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
``main_trajectory``) build them from their config.

Mixed precision (``compute_dtype=torch.bfloat16``, the CLIs'
``--mixed_precision 1``) is JAX's ``_cast_tree``: every float32 tensor of
the model's state dict (its parameters, frozen trunk included, and the
frozen batch norms' statistics, which are parameters in the JAX tree) and
every float32 model input of the batch is cast to bf16, and the model runs
on those through ``torch.func.functional_call``.  The cast is
differentiable, so the gradients reach the float32 master parameters as
float32 and the optimizer and checkpoints stay float32.  The loss comes
back in float32; Act3D's outputs are cast to float32 before the criterion,
as JAX casts them.  Evaluation stays float32, as JAX's metric functions
apply the uncast params.  ``torch.autocast`` is not used: its op lists are
not JAX's promotion rules, so it would compute another function.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.compact import expand_batch
from ..models import Act3D, DiffusionPlanner
from ..utils.testing import BOUNDS

__all__ = ["canonical_batch", "cast_params", "diffusion_loss",
           "diffusion_loss_fn", "diffusion_metrics_fn", "instruction_bank_on",
           "keypose_loss_fn", "keypose_metrics_fn", "keypose_pred", "make_diffusion_model",
           "make_keypose_model"]


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
    ``generators`` (training only)."""
    batch = _resolve_instr(expand_batch(batch), bank)
    if augment is not None:
        batch = augment(batch, generators)
    return batch


def cast_params(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor.to(dtype)} for every float32 entry of ``model``'s state
    dict: the tensors of JAX's params tree, cast as ``_cast_tree`` casts
    them.  The non-persistent buffers (JAX's constants, such as the
    workspace bounds) stay float32.  The parameters are cast as they are,
    not detached, so a loss of the cast model backpropagates into them.
    Under FSDP2 the parameters it manages are left out (sharded DTensors,
    or gathered in ``dtype`` already by its ``MixedPrecisionPolicy``,
    ``parallel/mesh.py``), while the frozen trunk it leaves alone and the
    buffers are cast here; the entries are read without ``state_dict``,
    whose FSDP2 hook would register the sharded parameters mid-forward."""
    from torch.distributed.tensor import DTensor

    return {name: t.to(dtype) for name, t in _state_tensors(model).items()
            if t.dtype == torch.float32 and not isinstance(t, DTensor)}


def _state_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The entries of ``model.state_dict(keep_vars=True)`` (parameters under
    every name, persistent buffers), read from the modules directly."""
    out = dict(model.named_parameters(remove_duplicate=False))
    for prefix, module in model.named_modules(remove_duplicate=False):
        for name, buf in module.named_buffers(recurse=False):
            if name not in module._non_persistent_buffers_set:
                out[f"{prefix}.{name}" if prefix else name] = buf
    return out


def _cast_floats(tensors, dtype: Optional[torch.dtype]):
    """The tensors (a sequence; None entries kept), float32 ones cast to
    ``dtype`` and the others as they are; no cast when dtype is None."""
    if dtype is None:
        return tuple(tensors)
    return tuple(t.to(dtype) if t is not None and t.dtype == torch.float32 else t
                 for t in tensors)


def _apply(model: nn.Module, compute_dtype, args, kwargs):
    """``model(*args, **kwargs)``, or with ``compute_dtype`` the model on its
    cast params and float32 ``args`` cast (``kwargs`` as they are)."""
    if compute_dtype is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, cast_params(model, compute_dtype),
                                      _cast_floats(args, compute_dtype), kwargs)


def diffusion_loss(model: DiffusionPlanner, batch, generators, compute_dtype=None,
                   **draws) -> torch.Tensor:
    """The float32 loss of one canonical batch (every key cast but the
    mask, as JAX's diffusion_loss_fn); ``draws``: ``noise`` / ``timesteps``
    injected by tests."""
    loss = _apply(model, compute_dtype,
                  [batch[k] for k in ("trajectory", "trajectory_mask", "rgbs", "pcds",
                                      "instr", "curr_gripper", "action")],
                  dict(generator=generators, **draws))
    return loss.float()


def _device_of(model):
    return next(model.parameters()).device


def diffusion_loss_fn(model: DiffusionPlanner, compute_dtype=None, augment=None,
                      instr_bank=None):
    """(batch, generators) -> (loss, aux) for the Trainer (training mode:
    dropout on).  ``compute_dtype=torch.bfloat16`` runs the network in bf16
    with float32 master weights and a float32 loss (module docstring).
    ``augment``: an on-device ``(batch, generator) -> batch`` drawing from
    ``generators``, for a dataset built with ``augment_host=False``;
    ``instr_bank``: the (n_rows, 53, 512) bank of ``instr_id`` batches."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def loss_fn(batch, generators):
        batch = canonical_batch(batch, bank, augment, generators)
        return diffusion_loss(model, batch, generators, compute_dtype), {}

    return loss_fn


def diffusion_metrics_fn(model: DiffusionPlanner, instr_bank=None):
    """(batch, generators) -> eval metric dict (the loss in eval mode, in
    float32)."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def metrics_fn(batch, generators):
        return {"noise_mse": diffusion_loss(model, canonical_batch(batch, bank), generators)}

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


def _to_float(tree):
    """Every bf16 tensor of a (nested list / dict) model output cast to
    float32, as JAX casts Act3D's outputs before the criterion."""
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_float(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


def keypose_pred(model: Act3D, batch, generators, use_gt_sampling: bool,
                 compute_dtype=None, **draws):
    """Act3D's outputs on one canonical batch, float32 whatever
    ``compute_dtype`` (the four observation keys are cast, ``gt_action``
    is not, as in JAX's keypose_loss_fn); ``draws``: ``ghost_uniforms`` or
    ``ghost_points_override`` injected by tests."""
    out = _apply(model, compute_dtype,
                 [batch[k] for k in ("rgbs", "pcds", "instr", "curr_gripper")],
                 dict(generator=generators,
                      gt_action=batch["action"] if use_gt_sampling else None, **draws))
    return _to_float(out)


def keypose_loss_fn(model: Act3D, criterion, compute_dtype=None, use_gt_sampling: bool = True,
                    augment=None, instr_bank=None):
    """(batch, generators) -> (loss, aux dict of detached sub-losses) for the
    Trainer (training mode: ``num_ghost_points``).  ``compute_dtype`` as in
    :func:`diffusion_loss_fn`; the losses are float32.  ``use_gt_sampling``
    centres the fine ghost-point balls on the ground-truth position
    (reference --use_ground_truth_position_for_sampling_train, on by
    default).  Ghost points come from the device generator, after the
    augment's draws.  ``augment`` / ``instr_bank`` as in
    :func:`diffusion_loss_fn`."""
    bank = instruction_bank_on(instr_bank, _device_of(model))

    def loss_fn(batch, generators):
        batch = canonical_batch(batch, bank, augment, generators)
        losses = criterion.compute_loss(
            keypose_pred(model, batch, generators, use_gt_sampling, compute_dtype),
            batch["action"])
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
        pred = keypose_pred(model, batch, generators, use_gt_sampling)
        return criterion.compute_metrics(pred, batch["action"])

    return metrics_fn
