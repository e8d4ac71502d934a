"""Canonical ChainedDiffuser construction and its Trainer functions.

Counterpart of the diffusion half of ``act3d_tpu/train/flagship.py``:
emb 120, 8 heads, 6 query layers, 6D rotation, 100 DDPM steps, goal- and
instruction-conditioned, dropout 0.1 (reference
scripts/train_trajectory.sh:6-41), over the canonical batch keys
(``trajectory``, ``trajectory_mask``, ``rgbs``, ``pcds``, ``instr``,
``curr_gripper``, ``action``).  Compact batches (``expand_batch``), device
augmentation, ``instr_id`` banks and bf16 come with the data slice; every
kernel takes float32.
"""

from __future__ import annotations

from typing import Tuple

from ..models import DiffusionPlanner
from ..utils.testing import BOUNDS

__all__ = ["diffusion_loss_fn", "diffusion_metrics_fn", "make_diffusion_model"]


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


def _loss(model: DiffusionPlanner, batch, generators):
    return model(
        batch["trajectory"], batch["trajectory_mask"], batch["rgbs"], batch["pcds"],
        batch["instr"], batch["curr_gripper"], batch["action"], generator=generators,
    )


def diffusion_loss_fn(model: DiffusionPlanner):
    """(batch, generators) -> (loss, aux) for the Trainer (training mode:
    dropout on)."""

    def loss_fn(batch, generators):
        return _loss(model, batch, generators), {}

    return loss_fn


def diffusion_metrics_fn(model: DiffusionPlanner):
    """(batch, generators) -> eval metric dict (the loss in eval mode)."""

    def metrics_fn(batch, generators):
        return {"noise_mse": _loss(model, batch, generators)}

    return metrics_fn
