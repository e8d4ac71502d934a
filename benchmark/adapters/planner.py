"""The ChainedDiffuser's trajectory DDPM (``act3d_tpu_torch.models.
DiffusionPlanner`` against ``benchmark/reference/planner.py``): its
options, weights, training batches and losses, and its attention sites.

The reference implements the one-block CLIP 6D head of
``scripts/train_trajectory.sh`` (``OPTIONS``); it makes no discrete choice,
so ``recorder`` keeps nothing and the reference follows nothing."""

from __future__ import annotations

import contextlib
from typing import Dict

from .. import generators, work
from ..reference.planner import DiffusionPlanner as Reference
from ..weights import materialise, meta_model, seeded_state

OPTIONS = dict(backbone="clip", use_instruction=1, use_goal=1, use_goal_at_test=0,
               rotation_parametrization="6D", num_attn_heads=8, feat_scales_to_use=1,
               attn_rounds=1, output_dim=7)


def reference_kwargs(cfg: Dict) -> Dict:
    """The reference planner's constructor arguments."""
    p = cfg["planner"]
    return dict(image_size=(cfg["image_size"],) * 2, embedding_dim=p["embedding_dim"],
                num_vis_ins_attn_layers=p["num_vis_ins_attn_layers"],
                num_query_cross_attn_layers=p["num_query_cross_attn_layers"],
                diffusion_timesteps=p["diffusion_timesteps"],
                gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])),
                dropout=p["dropout"])


def state(cfg: Dict, seed: int, device):
    """The seeded state dict, laid out as the reference's."""
    return seeded_state(meta_model(Reference, **reference_kwargs(cfg)), seed, device)


def reference(cfg: Dict, seed: int, device):
    """The reference on ``device`` with the seeded weights."""
    return materialise(Reference, state(cfg, seed, device), device, **reference_kwargs(cfg))


def program(cfg: Dict, seed: int, device):
    """The system's planner on ``device`` with the seeded weights, built by
    its own constructor from every option the configuration states (on the
    card the constructor applies the system's float32 policy)."""
    from act3d_tpu_torch.models import DiffusionPlanner

    p = cfg["planner"]
    model = DiffusionPlanner(
        backbone=p["backbone"], image_size=(cfg["image_size"],) * 2,
        embedding_dim=p["embedding_dim"], output_dim=p["output_dim"],
        num_vis_ins_attn_layers=p["num_vis_ins_attn_layers"],
        num_query_cross_attn_layers=p["num_query_cross_attn_layers"],
        use_instruction=bool(p["use_instruction"]), use_goal=bool(p["use_goal"]),
        use_goal_at_test=bool(p["use_goal_at_test"]),
        feat_scales_to_use=p["feat_scales_to_use"], attn_rounds=p["attn_rounds"],
        rotation_parametrization=p["rotation_parametrization"],
        diffusion_timesteps=p["diffusion_timesteps"],
        gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])), device=device)
    if model.prediction_head.dropout != p["dropout"]:
        raise ValueError(f"the system's head drops out at {model.prediction_head.dropout}, "
                         f"the configuration states {p['dropout']}")
    model.load_state_dict(state(cfg, seed, device))
    return model


def batches(cfg: Dict, tr: Dict, gen, device):
    """The traffic's pool of trajectory batches, drawn from ``gen``."""
    return [generators.trajectory_batch(tr["batch"], cfg["ncam"], cfg["image_size"],
                                        cfg["planner"]["trajectory_length"],
                                        cfg["workspace_bounds"], gen, device)
            for _ in range(tr["batch_pool"])]


def loss_fn(model):
    """The Trainer's loss: ``flagship.diffusion_loss_fn``."""
    from act3d_tpu_torch.train import flagship

    return flagship.diffusion_loss_fn(model)


def reference_loss(model, batch, gens, follow=None):
    """The reference's loss of one batch; no choices, a choice gap of 0."""
    return model.loss(batch["trajectory"], batch["trajectory_mask"], batch["rgbs"],
                      batch["pcds"], batch["instr"], batch["curr_gripper"], batch["action"],
                      gens), None, 0.0


@contextlib.contextmanager
def recorder(model):
    """An empty list: the head makes no choice for the reference to follow."""
    yield []


def sites(cfg: Dict, batch: int, training: bool):
    """The attention sites of one training forward, or of a keystep's
    denoising steps, at ``batch`` (``benchmark/work.py``)."""
    shared = {"ncam": cfg["ncam"], "instruction_tokens": cfg["instruction_tokens"]}
    p = cfg["planner"]
    return work.planner_sites({**p, **shared}, batch,
                              per_denoise=1 if training else p["diffusion_timesteps"])


def noise_width(cfg: Dict) -> int:
    """The sampler's internal width: 3 position + 6 rotation (6D)."""
    return 9
