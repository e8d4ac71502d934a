"""Plain PyTorch Act3D of the reference (Gervet et al., arXiv:2306.17817),
at the options of ``scripts/train_act3d.sh``: the CLIP trunk, levels tied
(one ghost-point embedding and one set of attention stacks for every
level), instruction-conditioned, the rotation read from the query as a
unit quaternion, no position offset head.

Written for the benchmark after ``act3d_tpu/models/act3d.py``.  Per level:
ghost points (level 0 uniform in the workspace; level i >= 1 uniform in a
ball of diameter 0.16 / {1, 4, 16}[i-1] around the previous estimate, or
around the ground-truth position in training), drawn as the first N of 4N
cube uniforms that fall inside the ball; the context is the whole level-0
token map, or at fine levels the 32 * 32 * ncam tokens nearest the
previous estimate (ties to the lower index), kept in index order; vis-ins
attention of the context over the instruction, then ghost points and one
query cross-attend to [context, gripper, instruction] with rotary 3D
positions (the instruction at position 0); the last query layer's dot
product with the ghost features scores the ghost points and their argmax
is the level's position.

``follow`` replaces a level's argmax by the position another
implementation chose, so the comparison can follow the system's choices
where it judges them (benchmark/drivers/keystep.py, train.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Generators, RelativeCrossAttentionModule, rotary_pe_3d
from .trunk import VisualEncoder

OVERSAMPLE = 4
BALL_DIVISORS = [None, 1.0, 4.0, 16.0]


def normalise_quat(q):
    return q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-10)


def uniform_cube(lo, hi, u):
    """lo/hi (..., 3), u (..., N, 3) uniforms -> points (..., N, 3)."""
    return lo[..., None, :] + u * (hi - lo)[..., None, :]


def uniform_ball(center, radius, lo, hi, n, u):
    """The first n of the cube points ``u`` maps into [lo, hi] that lie
    strictly inside ball(center, radius), in draw order."""
    pts = uniform_cube(lo, hi, u)
    outside = (torch.sum((pts - center[..., None, :]) ** 2, dim=-1) >= radius * radius)
    order = torch.argsort(outside.to(torch.uint8), dim=-1, stable=True)[..., :n]
    return torch.gather(pts, -2, order[..., None].expand(order.shape + (3,)))


def nearest_indices(anchor, cloud, k):
    """(B, k) indices of the k points of (B, P, 3) nearest (B, 3), ties to
    the lower index, returned in ascending index order."""
    d2 = torch.sum((anchor[:, None, :] - cloud) ** 2, dim=-1)
    idx = torch.sort(d2, dim=-1, stable=True).indices[:, :k]
    return torch.sort(idx, dim=-1).values


def gather_rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))


class Act3D(nn.Module):
    def __init__(self, image_size=(256, 256), embedding_dim: int = 60, num_attn_heads: int = 4,
                 num_ghost_point_cross_attn_layers: int = 2, num_query_cross_attn_layers: int = 2,
                 num_vis_ins_attn_layers: int = 2, gripper_loc_bounds=None,
                 num_ghost_points: int = 1000, num_ghost_points_val: int = 10000,
                 num_sampling_level: int = 3, fine_sampling_ball_diameter: float = 0.16):
        super().__init__()
        dim = embedding_dim
        self.embedding_dim = dim
        self.num_sampling_level = num_sampling_level
        self.num_ghost_points = num_ghost_points
        self.num_ghost_points_val = num_ghost_points_val
        self.fine_sampling_ball_diameter = fine_sampling_ball_diameter
        self.register_buffer("gripper_loc_bounds",
                             torch.tensor(gripper_loc_bounds, dtype=torch.float32),
                             persistent=False)
        self.visual = VisualEncoder(image_size, dim, num_sampling_level)
        self.ghost_points_embed = nn.Parameter(torch.zeros(1, dim))
        self.curr_gripper_embed = nn.Parameter(torch.zeros(1, dim))
        self.query_embed = nn.Parameter(torch.zeros(1, dim))
        self.ghost_point_cross_attn = RelativeCrossAttentionModule(
            dim, num_attn_heads, num_ghost_point_cross_attn_layers)
        self.query_cross_attn = RelativeCrossAttentionModule(
            dim, num_attn_heads, num_query_cross_attn_layers)
        self.vis_ins_attn = RelativeCrossAttentionModule(dim, num_attn_heads,
                                                         num_vis_ins_attn_layers)
        self.instruction_encoder = nn.Linear(512, dim)
        self.gripper_state_fc1 = nn.Linear(dim, dim)
        self.gripper_state_fc2 = nn.Linear(dim, 5)

    def forward(self, rgb, pcd, instruction, curr_gripper, *, gens: Optional[Generators] = None,
                gt_action=None, ghost_points: Optional[Sequence[torch.Tensor]] = None,
                follow: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, object]:
        """rgb in [0, 1]; ghost points from ``gens.device`` (training) or
        given per level (``ghost_points``).  ``follow`` gives each level's
        (B, 3) positions chosen by another implementation, followed wherever
        they are ghost points of that level (the argmax elsewhere).
        ``choice_gap`` in the output: how far the chosen points' scores lie
        below the best, over the scale of a score's rounding (|query| times
        the largest |ghost feature|), at the worst row and level."""
        dim = self.embedding_dim
        levels = self.num_sampling_level
        b, ncam = rgb.shape[:2]
        lo, hi = self.gripper_loc_bounds
        n_ghost = (self.num_ghost_points if self.training else self.num_ghost_points_val) // levels
        rows = torch.arange(b, device=rgb.device)
        tokens, points = self.visual(rgb, pcd)
        instr = self.instruction_encoder(instruction)
        instr_pos = rotary_pe_3d(torch.zeros(b, instr.shape[1], 3, device=rgb.device), dim)
        gripper_pos = rotary_pe_3d(curr_gripper[:, None, :3], dim)
        gripper_feats = self.curr_gripper_embed[None].expand(b, 1, dim)

        query = self.query_embed[None].expand(b, 1, dim)
        ghosts, masks, positions, gaps = [], [], [], []
        for i in range(levels):
            if ghost_points is not None:
                ghost = ghost_points[i]
            else:
                u = torch.rand((b, n_ghost * (1 if i == 0 else OVERSAMPLE), 3),
                               generator=gens.device, device=rgb.device)
                if i == 0:
                    ghost = uniform_cube(lo.expand(b, 3), hi.expand(b, 3), u)
                else:
                    anchor = gt_action[:, :3] if gt_action is not None else positions[-1]
                    diameter = self.fine_sampling_ball_diameter / BALL_DIVISORS[i]
                    ghost = uniform_ball(anchor, diameter / 2.0,
                                         torch.clamp(anchor - diameter / 2.0, lo, hi),
                                         torch.clamp(anchor + diameter / 2.0, lo, hi), n_ghost, u)
            if i == 0:
                ctx, ctx_xyz = tokens[0], points[0]
            else:
                idx = nearest_indices(positions[-1], points[i], 32 * 32 * ncam)
                ctx, ctx_xyz = gather_rows(tokens[i], idx), gather_rows(points[i], idx)
            ctx_pos = torch.cat([rotary_pe_3d(ctx_xyz, dim), gripper_pos], dim=1)
            ctx = self.vis_ins_attn(torch.cat([ctx, gripper_feats], dim=1), instr)[-1]
            ctx = torch.cat([ctx, instr], dim=1)
            ctx_pos = torch.cat([ctx_pos, instr_pos], dim=1)

            ghost_feats = self.ghost_point_cross_attn(
                self.ghost_points_embed[None].expand(b, ghost.shape[1], dim), ctx,
                query_pos=rotary_pe_3d(ghost, dim), value_pos=ctx_pos)[-1]
            if i == 0:
                outs = self.query_cross_attn(query, ctx)
            else:
                outs = self.query_cross_attn(query, ctx,
                                             query_pos=rotary_pe_3d(positions[-1][:, None], dim),
                                             value_pos=ctx_pos)
            query = outs[-1]
            masks_i = [torch.einsum("bc,bnc->bn", q[:, 0], ghost_feats) for q in outs]
            scores = masks_i[-1]
            top = torch.argmax(scores, dim=-1)
            if follow is not None and follow[i].shape == (b, 3):
                match = (ghost == follow[i][:, None, :]).all(dim=-1)
                top = torch.where(match.any(dim=-1), match.to(torch.uint8).argmax(dim=-1), top)
            # a score's rounding scales with |query| |ghost feature|, not with the score
            scale = outs[-1][:, 0].norm(dim=-1) * ghost_feats.norm(dim=-1).amax(dim=-1)
            gaps.append(((scores.amax(dim=-1) - scores[rows, top]) / scale).amax())
            positions.append(ghost[rows, top])
            ghosts.append(ghost)
            masks.append(masks_i)

        pred = self.gripper_state_fc2(F.relu(self.gripper_state_fc1(query[:, 0])))
        return {"position": positions[-1], "rotation": normalise_quat(pred[:, :4]),
                "gripper": torch.sigmoid(pred[:, 4:]), "position_pyramid": positions,
                "ghost_pcd_pyramid": ghosts, "ghost_pcd_masks_pyramid": masks,
                "choice_gap": torch.stack(gaps).amax()}


def keypose_loss(pred: Dict, gt_action: torch.Tensor, spread: float = 0.01) -> torch.Tensor:
    """Soft cross-entropy of each level's last-layer scores against a
    softmax of -distance / 0.01 to the ground-truth position, averaged over
    levels; 10 x the quaternion MSE; the gripper MSE (reference
    main_keypose.py's defaults)."""
    gt_pos = gt_action[:, :3]
    levels = len(pred["ghost_pcd_masks_pyramid"])
    total = 0.0
    for ghost, masks in zip(pred["ghost_pcd_pyramid"], pred["ghost_pcd_masks_pyramid"]):
        dist = torch.sqrt(torch.sum(torch.square(ghost - gt_pos[:, None, :]), dim=-1))
        label = torch.softmax(-dist / spread, dim=-1).detach()
        total = total - torch.mean(torch.sum(label * F.log_softmax(masks[-1], dim=-1), dim=-1)) / levels
    total = total + 10.0 * torch.mean(torch.square(pred["rotation"] - gt_action[:, 3:7]))
    return total + torch.mean(torch.square(pred["gripper"] - gt_action[:, 7:8]))
