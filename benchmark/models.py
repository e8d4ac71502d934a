"""A configuration's models, built twice from one seeded state dict: the
system under test (``act3d_tpu_torch``, imported only inside these
functions) and the reference (``benchmark/reference``).

A configuration file states every constructor option.  The reference
implements the options of the published scripts only, so a configuration
asking for another one is refused here rather than compared against a
different model.
"""

from __future__ import annotations

from typing import Dict

from .reference.act3d import Act3D as RefAct3D
from .reference.planner import DiffusionPlanner as RefPlanner
from .weights import materialise, meta_model, seeded_state

# the options the reference implements (scripts/train_act3d.sh, train_trajectory.sh)
ACT3D_FIXED = dict(backbone="clip", weight_tying=1, gp_emb_tying=1, use_instruction=1,
                   rotation_parametrization="quat_from_query", regress_position_offset=0)
PLANNER_FIXED = dict(backbone="clip", use_instruction=1, use_goal=1, use_goal_at_test=0,
                     rotation_parametrization="6D", num_attn_heads=8, feat_scales_to_use=1,
                     attn_rounds=1, output_dim=7)


def _check(section: Dict, fixed: Dict, what: str):
    for key, want in fixed.items():
        if section.get(key) != want:
            raise ValueError(f"{what}: the reference implements {key}={want!r}, the "
                             f"configuration states {section.get(key)!r}")


def act3d_kwargs(cfg: Dict) -> Dict:
    """The reference Act3D's constructor arguments."""
    a = cfg["act3d"]
    _check(a, ACT3D_FIXED, "act3d")
    return dict(image_size=(cfg["image_size"],) * 2, embedding_dim=a["embedding_dim"],
                num_attn_heads=a["num_attn_heads"],
                num_ghost_point_cross_attn_layers=a["num_ghost_point_cross_attn_layers"],
                num_query_cross_attn_layers=a["num_query_cross_attn_layers"],
                num_vis_ins_attn_layers=a["num_vis_ins_attn_layers"],
                gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])),
                num_ghost_points=a["num_ghost_points"],
                num_ghost_points_val=a["num_ghost_points_val"],
                num_sampling_level=a["num_sampling_level"],
                fine_sampling_ball_diameter=a["fine_sampling_ball_diameter"])


def planner_kwargs(cfg: Dict) -> Dict:
    """The reference planner's constructor arguments."""
    p = cfg["planner"]
    _check(p, PLANNER_FIXED, "planner")
    return dict(image_size=(cfg["image_size"],) * 2, embedding_dim=p["embedding_dim"],
                num_vis_ins_attn_layers=p["num_vis_ins_attn_layers"],
                num_query_cross_attn_layers=p["num_query_cross_attn_layers"],
                diffusion_timesteps=p["diffusion_timesteps"],
                gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])),
                dropout=p["dropout"])


def _reference_class(kind: str, cfg: Dict):
    if kind == "act3d":
        return RefAct3D, act3d_kwargs(cfg)
    return RefPlanner, planner_kwargs(cfg)


def state(kind: str, cfg: Dict, seed: int, device):
    """The seeded state dict of the ``act3d`` or ``planner`` model."""
    cls, kwargs = _reference_class(kind, cfg)
    return seeded_state(meta_model(cls, **kwargs), seed, device)


def reference(kind: str, cfg: Dict, seed: int, device):
    """The reference model on ``device`` with the seeded weights."""
    cls, kwargs = _reference_class(kind, cfg)
    return materialise(cls, state(kind, cfg, seed, device), device, **kwargs)


def program(kind: str, cfg: Dict, seed: int, device):
    """The system's model on ``device`` with the seeded weights, built by
    its own constructor from every option the configuration states (on the
    card the constructor applies the system's float32 policy)."""
    if kind == "act3d":
        from act3d_tpu_torch.models import Act3D
        a = cfg["act3d"]
        kwargs = act3d_kwargs(cfg)
        kwargs.pop("gripper_loc_bounds")
        model = Act3D(backbone=a["backbone"], weight_tying=bool(a["weight_tying"]),
                      gp_emb_tying=bool(a["gp_emb_tying"]),
                      use_instruction=bool(a["use_instruction"]),
                      rotation_parametrization=a["rotation_parametrization"],
                      regress_position_offset=bool(a["regress_position_offset"]),
                      gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])),
                      device=device, **kwargs)
    else:
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
    model.load_state_dict(state(kind, cfg, seed, device))
    return model
