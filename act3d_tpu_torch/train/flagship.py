"""Canonical model constructions and their Trainer functions.

Counterpart of ``act3d_tpu/train/flagship.py``:
  * ChainedDiffuser: emb 120, 8 heads, 6 query layers, 6D rotation, 100
    DDPM steps, goal- and instruction-conditioned, dropout 0.1 (reference
    scripts/train_trajectory.sh:6-41);
  * Act3D keypose: emb 60, 4 heads, 1000 / 10000 ghost points (train /
    eval) over 3 levels, weights tied, instruction-conditioned, rotation
    from the query (reference scripts/train_act3d.sh:9-52).
Batches carry the canonical keys (``trajectory``, ``trajectory_mask``,
``rgbs``, ``pcds``, ``instr``, ``curr_gripper``, ``action``) or their
wire encodings: every loss and metric function first decodes compact and
depth-wire batches (``data.compact.expand_batch``), then looks
``instr_id`` rows up in ``instr_bank``, then (training only) applies
``augment`` (``data.device_augment.make_device_augment``).  The functions
take any model and criterion, so the CLIs (``main_keypose`` /
``main_trajectory``) build them from their config.  bf16 is not ported
yet; every kernel takes float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..data.compact import expand_batch
from ..models import Act3D, DiffusionPlanner
from ..utils.testing import BOUNDS

__all__ = ["canonical_batch", "diffusion_loss_fn", "diffusion_metrics_fn",
           "instruction_bank_on", "keypose_loss_fn", "keypose_metrics_fn",
           "make_diffusion_model", "make_keypose_model"]


def make_diffusion_model(
    image_size: Tuple[int, int] = (256, 256),
    embedding_dim: int = 120,
    gripper_loc_bounds=BOUNDS,
    use_instruction: bool = True,
    use_goal: bool = True,
    diffusion_timesteps: int = 100,
    num_query_cross_attn_layers: int = 6,
    device="cuda",
) -> DiffusionPlanner:
    return DiffusionPlanner(
        image_size=image_size,
        embedding_dim=embedding_dim,
        output_dim=7,
        num_query_cross_attn_layers=num_query_cross_attn_layers,
        use_instruction=use_instruction,
        use_goal=use_goal,
        use_goal_at_test=False,  # chained mode: the goal comes from Act3D
        rotation_parametrization="6D",
        diffusion_timesteps=diffusion_timesteps,
        gripper_loc_bounds=tuple(map(tuple, gripper_loc_bounds)),
        device=device,
    )


def instruction_bank_on(instr_bank, device):
    """The instruction bank as a tensor on ``device``, uploaded once per
    loss function: held by its closure, neither a parameter nor in the
    state_dict."""
    if instr_bank is None:
        return None
    return torch.as_tensor(np.asarray(instr_bank, np.float32), device=device)


def _resolve_instr(batch, instr_bank):
    """``instr`` = ``instr_bank[instr_id]`` for batches of
    ``RLBenchDataset(instr_mode="ids")``, which ship a (B,) int32 row index
    instead of (B, 53, 512) features; other batches pass through."""
    if "instr_id" not in batch:
        return batch
    if instr_bank is None:
        raise ValueError("batch carries instr_id but no instr_bank was passed to the loss fn "
                         "(RLBenchDataset(instr_mode='ids') pairs with "
                         "loss_fn(..., instr_bank=ds.instruction_bank))")
    batch = dict(batch)
    batch["instr"] = instr_bank[batch.pop("instr_id").to(instr_bank.device, torch.int64)]
    return batch


def canonical_batch(batch, bank, augment=None, generators=None):
    """A batch with the canonical keys: the wire decoded
    (``expand_batch``), ``instr_id`` resolved in ``bank`` (the tensor of
    :func:`instruction_bank_on`), then ``augment`` drawing from
    ``generators.device`` (training only)."""
    batch = _resolve_instr(expand_batch(batch), bank)
    if augment is not None:
        batch = augment(batch, generators.device)
    return batch


def _loss(model: DiffusionPlanner, batch, generators):
    return model(
        batch["trajectory"], batch["trajectory_mask"], batch["rgbs"], batch["pcds"],
        batch["instr"], batch["curr_gripper"], batch["action"], generator=generators,
    )


def _device_of(model):
    return next(model.parameters()).device


def diffusion_loss_fn(model: DiffusionPlanner, augment=None, instr_bank=None):
    """(batch, generators) -> (loss, aux) for the Trainer (training mode:
    dropout on).  ``augment``: an on-device ``(batch, generator) -> batch``
    drawing from ``generators.device``, for a dataset built with
    ``augment_host=False``; ``instr_bank``: the (n_rows, 53, 512) bank of
    ``instr_id`` batches."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def loss_fn(batch, generators):
        return _loss(model, canonical_batch(batch, bank, augment, generators), generators), {}

    return loss_fn


def diffusion_metrics_fn(model: DiffusionPlanner, instr_bank=None):
    """(batch, generators) -> eval metric dict (the loss in eval mode)."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def metrics_fn(batch, generators):
        return {"noise_mse": _loss(model, canonical_batch(batch, bank), generators)}

    return metrics_fn


def make_keypose_model(
    image_size: Tuple[int, int] = (256, 256),
    embedding_dim: int = 60,
    gripper_loc_bounds=BOUNDS,
    num_ghost_points: int = 1000,
    num_ghost_points_val: int = 10000,
    num_sampling_level: int = 3,
    use_instruction: bool = True,
    device="cuda",
) -> Act3D:
    return Act3D(
        image_size=image_size,
        embedding_dim=embedding_dim,
        num_attn_heads=4,
        gripper_loc_bounds=tuple(map(tuple, gripper_loc_bounds)),
        num_ghost_points=num_ghost_points,
        num_ghost_points_val=num_ghost_points_val,
        num_sampling_level=num_sampling_level,
        use_instruction=use_instruction,
        device=device,
    )


def _keypose_pred(model: Act3D, batch, generators, use_gt_sampling: bool):
    return model(
        batch["rgbs"], batch["pcds"], batch["instr"], batch["curr_gripper"],
        generator=generators.device,
        gt_action=batch["action"] if use_gt_sampling else None,
    )


def keypose_loss_fn(model: Act3D, criterion, use_gt_sampling: bool = True, augment=None,
                    instr_bank=None):
    """(batch, generators) -> (loss, aux dict of detached sub-losses) for the
    Trainer (training mode: ``num_ghost_points``).  ``use_gt_sampling``
    centres the fine ghost-point balls on the ground-truth position
    (reference --use_ground_truth_position_for_sampling_train, on by
    default).  Ghost points come from the device generator, after the
    augment's draws.  ``augment`` / ``instr_bank`` as in
    :func:`diffusion_loss_fn`."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def loss_fn(batch, generators):
        batch = canonical_batch(batch, bank, augment, generators)
        losses = criterion.compute_loss(
            _keypose_pred(model, batch, generators, use_gt_sampling), batch["action"])
        return sum(losses.values()), {k: v.detach() for k, v in losses.items()}

    return loss_fn


def keypose_metrics_fn(model: Act3D, criterion, use_gt_sampling: bool = False,
                       instr_bank=None):
    """(batch, generators) -> per-sample eval metrics: eval mode under
    ``Trainer.evaluate`` (``num_ghost_points_val``), gt sampling off unless
    asked (--use_ground_truth_position_for_sampling_val), as
    main_keypose.py:160-173."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def metrics_fn(batch, generators):
        batch = canonical_batch(batch, bank)
        pred = _keypose_pred(model, batch, generators, use_gt_sampling)
        return criterion.compute_metrics(pred, batch["action"])

    return metrics_fn
