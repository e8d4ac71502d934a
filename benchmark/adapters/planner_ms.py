"""The ChainedDiffuser's trajectory DDPM with its multi-scale head
(``act3d_tpu_torch.models.DiffusionPlanner`` at ``feat_scales_to_use`` 3,
``attn_rounds`` 2, against ``benchmark/reference/planner_ms.py``): its
options, weights, training batches and losses, the head's
trajectory-nearest selections, and its attention sites.

The head selects four times a forward (scales 1 and 2 of both rounds);
where distances nearly tie at the k-th place the selection turns on
rounding, so ``recorder`` keeps the system's indices and the reference
gathers those and judges the first step's (``choice_gap``).  The system
exposes its selection as the head's ``traj_neighbours`` submodule; a
system without it is refused when its model is built, before any step."""

from __future__ import annotations

import contextlib
from typing import Dict

from .. import work
from ..reference.planner_ms import DiffusionPlanner as Reference
from ..reference.trunk import pyramid_layout
from ..weights import materialise, meta_model, seeded_state
# the batches, the Trainer's loss and the sampler's width are the one-block planner's
from .planner import batches, loss_fn, noise_width  # noqa: F401
from .planner import reference_kwargs as _one_block_kwargs

OPTIONS = dict(backbone="clip", use_instruction=1, use_goal=1, use_goal_at_test=0,
               rotation_parametrization="6D", num_attn_heads=8, feat_scales_to_use=3,
               attn_rounds=2, output_dim=7)
SELECTOR = "traj_neighbours"  # the head's selection submodule


def reference_kwargs(cfg: Dict) -> Dict:
    """The reference planner's constructor arguments."""
    p = cfg["planner"]
    return dict(_one_block_kwargs(cfg), feat_scales_to_use=p["feat_scales_to_use"],
                attn_rounds=p["attn_rounds"])


def state(cfg: Dict, seed: int, device):
    """The seeded state dict, laid out as the reference's."""
    return seeded_state(meta_model(Reference, **reference_kwargs(cfg)), seed, device)


def reference(cfg: Dict, seed: int, device):
    """The reference on ``device`` with the seeded weights."""
    return materialise(Reference, state(cfg, seed, device), device, **reference_kwargs(cfg))


def _selector(model):
    """The system head's selection submodule; a RuntimeError naming it when
    the head has none."""
    head = getattr(model, "prediction_head", None)
    selector = getattr(head, SELECTOR, None)
    if selector is None:
        raise RuntimeError(
            f"the system's planner head has no {SELECTOR!r} submodule: its trajectory-nearest "
            "selections (find_traj_nn) cannot be recorded for the reference to follow")
    return selector


def program(cfg: Dict, seed: int, device):
    """The system's planner on ``device`` with the seeded weights, built by
    its own constructor from every option the configuration states."""
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
    _selector(model)
    if model.prediction_head.dropout != p["dropout"]:
        raise ValueError(f"the system's head drops out at {model.prediction_head.dropout}, "
                         f"the configuration states {p['dropout']}")
    model.load_state_dict(state(cfg, seed, device))
    return model


def reference_loss(model, batch, gens, follow=None):
    """The reference's loss of one batch, its selections (the four (B, k)
    index tensors, in block order) and the widest choice gap of the
    followed ones.  Only the first forward of a reference model is judged:
    after AdamW's first step every element has moved by lr in the sign of
    its gradient, rounding noise included, so the later steps' trajectories
    differ from the system's by far more than rounding (choice gaps of
    sound runs up to ~1e-2 there, PERF.md section 2), as their losses do;
    their followed selections are still checked to be k points of the
    cloud."""
    return model.loss(batch["trajectory"], batch["trajectory_mask"], batch["rgbs"],
                      batch["pcds"], batch["instr"], batch["curr_gripper"], batch["action"],
                      gens, follow, judge=model.forwards == 0)


@contextlib.contextmanager
def recorder(model):
    """The system's selections, one entry a forward: the (B, k) index
    tensors its head gathered, in block order, kept on the device (no copy,
    no sync).  Raises at once, naming the submodule, where the head has
    none."""
    from act3d_tpu_torch.models.diffusion_head import DiffusionHead

    entries, last = [], [None]

    def keep(module, args, idx):
        if DiffusionHead.evaluations != last[0]:  # the first selection of a forward
            last[0] = DiffusionHead.evaluations
            entries.append([])
        entries[-1].append(idx.detach())

    hook = _selector(model).register_forward_hook(keep)
    try:
        yield entries
    finally:
        hook.remove()


def sites(cfg: Dict, batch: int, training: bool):
    """The attention sites of one training forward, or of a keystep's
    denoising steps, at ``batch``: in every block the trajectory-language
    layer and the self attention of the trajectory, position and rotation
    stacks; per round and scale the vision-language stack (the scale's
    tokens over the instruction) and their cross attention (the trajectory
    over the tokens, gripper and goal).  Scale 0 attends to its whole level,
    scales 1 and 2 to the 64 * L and 16 * L points nearest the trajectory."""
    p = cfg["planner"]
    per = 1 if training else p["diffusion_timesteps"]
    e, h, length = p["embedding_dim"], p["num_attn_heads"], p["trajectory_length"]
    n_instr, rounds = cfg["instruction_tokens"], p["attn_rounds"]
    blocks = rounds * p["feat_scales_to_use"]
    layers = (p["num_query_cross_attn_layers"] - 2) + 2 + 2
    _, down = pyramid_layout((cfg["image_size"],) * 2)
    level0 = cfg["ncam"] * (cfg["image_size"] // down[0]) ** 2
    out = [work.Site("planner.traj_lang", length, n_instr, e, h, batch, False, blocks * per),
           work.Site("planner.self", length, length, e, h, batch, True, layers * blocks * per)]
    for scale in range(p["feat_scales_to_use"]):
        tokens = level0 if scale == 0 else (64 if scale == 1 else 16) * length
        out += [work.Site(f"planner.vl_scale{scale}", tokens, n_instr, e, h, batch, False,
                          p["num_vis_ins_attn_layers"] * rounds * per),
                work.Site(f"planner.cross_scale{scale}", length, tokens + 2, e, h, batch, False,
                          layers * rounds * per)]
    return out
