"""Act3D, the keypose model (``act3d_tpu_torch.models.Act3D`` against
``benchmark/reference/act3d.py``): its options, weights, training batches
and losses, the choices the reference follows, and its attention sites.

The reference implements the options of ``scripts/train_act3d.sh``
(``OPTIONS``).  Act3D's argmax over ghost points is a discrete choice that
rounding swings where scores lie close, so ``recorder`` keeps each level's
chosen position of every forward and the reference follows them."""

from __future__ import annotations

import contextlib
from typing import Dict

from .. import generators, work
from ..reference.act3d import Act3D as Reference
from ..reference.act3d import keypose_loss
from ..weights import materialise, meta_model, seeded_state

OPTIONS = dict(backbone="clip", weight_tying=1, gp_emb_tying=1, use_instruction=1,
               rotation_parametrization="quat_from_query", regress_position_offset=0)


def reference_kwargs(cfg: Dict) -> Dict:
    """The reference Act3D's constructor arguments."""
    a = cfg["act3d"]
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


def state(cfg: Dict, seed: int, device):
    """The seeded state dict, laid out as the reference's."""
    return seeded_state(meta_model(Reference, **reference_kwargs(cfg)), seed, device)


def reference(cfg: Dict, seed: int, device):
    """The reference on ``device`` with the seeded weights."""
    return materialise(Reference, state(cfg, seed, device), device, **reference_kwargs(cfg))


def program(cfg: Dict, seed: int, device):
    """The system's Act3D on ``device`` with the seeded weights, built by its
    own constructor from every option the configuration states (on the card
    the constructor applies the system's float32 policy)."""
    from act3d_tpu_torch.models import Act3D

    a = cfg["act3d"]
    kwargs = reference_kwargs(cfg)
    kwargs.pop("gripper_loc_bounds")
    model = Act3D(backbone=a["backbone"], weight_tying=bool(a["weight_tying"]),
                  gp_emb_tying=bool(a["gp_emb_tying"]),
                  use_instruction=bool(a["use_instruction"]),
                  rotation_parametrization=a["rotation_parametrization"],
                  regress_position_offset=bool(a["regress_position_offset"]),
                  gripper_loc_bounds=tuple(map(tuple, cfg["workspace_bounds"])),
                  device=device, **kwargs)
    model.load_state_dict(state(cfg, seed, device))
    return model


def batches(cfg: Dict, tr: Dict, gen, device):
    """The traffic's pool of keypose batches, drawn from ``gen``."""
    return [generators.keypose_batch(tr["batch"], cfg["ncam"], cfg["image_size"],
                                     cfg["workspace_bounds"], gen, device)
            for _ in range(tr["batch_pool"])]


def loss_fn(model):
    """The Trainer's loss: ``flagship.keypose_loss_fn`` with the fine balls
    centred on the ground truth, as the training CLI runs it."""
    from act3d_tpu_torch.train import flagship
    from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics

    return flagship.keypose_loss_fn(model, KeyposeLossAndMetrics(), use_gt_sampling=True)


def reference_loss(model, batch, gens, follow=None):
    """The reference's loss of one batch, its chosen positions per level
    (following ``follow``, the system's) and its choice gap."""
    pred = model(batch["rgbs"], batch["pcds"], batch["instr"], batch["curr_gripper"],
                 gens=gens, gt_action=batch["action"], follow=follow)
    return (keypose_loss(pred, batch["action"]),
            [p.detach() for p in pred["position_pyramid"]], float(pred["choice_gap"].detach()))


@contextlib.contextmanager
def recorder(model):
    """A list that gets each forward's choices (its output's
    ``position_pyramid``) while the block runs."""
    chosen = []
    hook = model.register_forward_hook(
        lambda module, args, out: chosen.append([p.detach().clone()
                                                 for p in out["position_pyramid"]]))
    try:
        yield chosen
    finally:
        hook.remove()


def sites(cfg: Dict, batch: int, training: bool):
    """The attention sites of one forward at ``batch`` (``benchmark/work.py``)."""
    shared = {"ncam": cfg["ncam"], "instruction_tokens": cfg["instruction_tokens"]}
    return work.act3d_sites({**cfg["act3d"], **shared}, batch, training)
