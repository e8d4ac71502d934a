"""Plain PyTorch ChainedDiffuser trajectory model of the reference with its
multi-scale head (Xian et al., CoRL 2023; the upstream
``model/trajectory_optimization/diffusion_head.py:200-363``): the CLIP
trunk, ``attn_rounds`` rounds over ``feat_scales_to_use`` feature scales,
8 heads, instruction- and goal-conditioned, ortho-6D rotations, DDPM over
100 steps predicting the clean sample.

Written for the benchmark after ``act3d_tpu/models/diffusion_head.py``
(the multi-block ``denoise``) and this folder's one-block ``planner.py``,
whose schedules, rotation formulas and input normalisation it shares.
Block ``round * scales + scale`` has its own attention stacks and
regressors under the published names (``vl_attention_{i}``,
``traj_attention_{i}``, ..., ``pos_regressor_{i}_fc1``) and attends to that
scale's visual tokens: at 256^2 scale 0 is the res3 map, scales 1 and 2
both the res1 map.  At scales above 0 (the goal is in use) it keeps only
the ``nn_per_step * L`` points nearest the previous block's trajectory (the
upstream's ``find_traj_nn``, :253-259: 64 per step at scale 1, 16 above),
nearest first, equal distances in index order, and gathers their tokens
and points.  Every block updates the trajectory (positions by residual,
rotations replaced); the trajectory's features and rotary codes are those
of the input trajectory in every block.  The loss sums
100 L1(pos) + 10 L1(rot6d) over the blocks.

Departures from the upstream: none in the arithmetic; the nearest points
are found from distances computed a few batch rows at a time, so that the
(rows, L, P, 3) differences fit.

Following: the system's selection at the k-th place turns on rounding
where distances nearly tie, so the loss can be handed the system's indices
(``follow``: the four (B, k) index tensors of one forward, in block order)
and gathers those, in the system's order.  With ``judge`` each followed
selection is judged by :func:`choice_gap` on the reference's own
distances; without, it is only checked to be k distinct points of the
cloud.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import planner
from .layers import Generators, ParallelAttention, dropout, rotary_pe_3d, sinusoidal_pos_emb
from .trunk import VisualEncoder

ROWS = 4  # batch rows whose (L, P, 3) differences are formed at once


def nearest_sq_distance(trajectory_xyz: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """(B, P) squared distance of each cloud point (B, P, 3) to the nearest
    point of the (B, L, 3) trajectory."""
    trajectory_xyz, cloud = trajectory_xyz.detach(), cloud.detach()
    return torch.cat([
        torch.amin(torch.sum((trajectory_xyz[r:r + ROWS, :, None, :]
                              - cloud[r:r + ROWS, None, :, :]) ** 2, dim=-1), dim=1)
        for r in range(0, cloud.shape[0], ROWS)])


def nearest(m: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k smallest of (B, P) distances, nearest first,
    equal distances in index order."""
    return torch.sort(m, dim=-1, stable=True).indices[:, :k]


def choice_gap(m: torch.Tensor, idx: torch.Tensor, k: int) -> float:
    """How far a followed selection ``idx`` (B, k) lies beyond the k nearest
    by the reference's distances ``m`` (B, P): the largest m[p] - tau over
    the kept points p, over tau, the reference's k-th smallest distance (0
    when every kept point is within it), worst row.  A selection that is
    not k distinct points of the cloud reads inf."""
    if idx.shape != (m.shape[0], k) or int(idx.min()) < 0 or int(idx.max()) >= m.shape[1]:
        return math.inf
    if bool((torch.sort(idx, dim=-1).values.diff(dim=-1) == 0).any()):
        return math.inf
    tau = torch.kthvalue(m, k, dim=-1).values
    excess = torch.gather(m, 1, idx).amax(dim=-1) - tau
    return float(torch.where(excess > 0, excess / tau, torch.zeros_like(excess)).amax())


class DiffusionHead(nn.Module):
    def __init__(self, image_size, embedding_dim: int = 120, output_dim: int = 9,
                 num_attn_heads: int = 8, num_vis_ins_attn_layers: int = 2,
                 num_query_cross_attn_layers: int = 6, dropout: float = 0.1,
                 feat_scales_to_use: int = 3, attn_rounds: int = 2):
        super().__init__()
        dim = embedding_dim
        self.embedding_dim = dim
        self.dropout = dropout
        self.scales, self.rounds = feat_scales_to_use, attn_rounds
        self.visual = VisualEncoder(image_size, dim, feat_scales_to_use)
        self.traj_enc_fc1 = nn.Linear(output_dim, dim)
        self.traj_enc_fc2 = nn.Linear(dim, dim)
        self.curr_gripper_encoder = nn.Linear(output_dim, dim)
        self.goal_gripper_encoder = nn.Linear(output_dim, dim)
        self.instruction_encoder = nn.Linear(512, dim)
        self.curr_gripper_embed = nn.Parameter(torch.zeros(1, dim))
        self.goal_gripper_embed = nn.Parameter(torch.zeros(1, dim))
        cross = dict(d_model=dim, n_heads=num_attn_heads, self_attention1=False,
                     self_attention2=False, cross_attention1=True, cross_attention2=False,
                     dropout=dropout)
        traj = dict(d_model=dim, n_heads=num_attn_heads, self_attention1=True,
                    self_attention2=False, cross_attention1=True, cross_attention2=False,
                    rotary_pe=True, use_adaln=True, dropout=dropout)
        for i in range(attn_rounds * feat_scales_to_use):
            setattr(self, f"vl_attention_{i}", ParallelAttention(num_vis_ins_attn_layers, **cross))
            setattr(self, f"traj_lang_attention_{i}", ParallelAttention(1, apply_ffn=False, **cross))
            setattr(self, f"traj_attention_{i}",
                    ParallelAttention(num_query_cross_attn_layers - 2, **traj))
            setattr(self, f"pos_attention_{i}", ParallelAttention(2, **traj))
            setattr(self, f"rot_attention_{i}", ParallelAttention(2, **traj))
            setattr(self, f"pos_regressor_{i}_fc1", nn.Linear(dim, dim))
            setattr(self, f"pos_regressor_{i}_fc2", nn.Linear(dim, 3))
            setattr(self, f"rot_regressor_{i}_fc1", nn.Linear(dim, dim))
            setattr(self, f"rot_regressor_{i}_fc2", nn.Linear(dim, output_dim - 3))

    def encode_context(self, rgb, pcd, curr, goal, instruction):
        dim = self.embedding_dim
        b = rgb.shape[0]
        tokens, points = self.visual(rgb, pcd)
        return dict(
            tokens=tokens, points=points, instr=self.instruction_encoder(instruction),
            curr=self.curr_gripper_encoder(curr)[:, None] + self.curr_gripper_embed[None].expand(b, 1, dim),
            curr_pos=rotary_pe_3d(curr[:, None, :3], dim),
            goal=self.goal_gripper_encoder(goal)[:, None] + self.goal_gripper_embed[None].expand(b, 1, dim),
            goal_pos=rotary_pe_3d(goal[:, None, :3], dim))

    def denoise(self, trajectory, mask, timestep, ctx, gens=None,
                follow: Optional[List[torch.Tensor]] = None, judge: bool = True):
        """Every block's clean-trajectory prediction (B, L, output_dim), the
        selections gathered (the system's where ``follow`` gives them), and
        the widest choice gap over the followed ones (0 without; without
        ``judge``, inf for a followed selection that is not k points of
        the cloud and 0 for one that is)."""
        dim = self.embedding_dim
        b, length = trajectory.shape[:2]
        gens = gens if self.training else None

        def drop(x):
            return dropout(x, self.dropout, gens)

        traj_feats = self.traj_enc_fc2(drop(F.relu(self.traj_enc_fc1(trajectory))))
        traj_pos = rotary_pe_3d(trajectory[..., :3], dim)
        time_feats = sinusoidal_pos_emb(timestep, dim)
        time_pos = sinusoidal_pos_emb(torch.arange(length, device=trajectory.device),
                                      dim)[None].expand(b, length, dim)
        outputs, chosen, gap = [], [], 0.0
        for r in range(self.rounds):
            for scale in range(self.scales):
                feats, xyz = ctx["tokens"][scale], ctx["points"][scale]
                if scale > 0:
                    k = (64 if scale == 1 else 16) * length
                    m = nearest_sq_distance(outputs[-1][..., :3], xyz)
                    idx = None if follow is None else follow[len(chosen)]
                    if idx is not None:
                        judged = choice_gap(m, idx, k)
                        gap = max(gap, judged if judge or math.isinf(judged) else 0.0)
                        if not math.isfinite(judged):
                            idx = None  # not k points of the cloud: gathered from its own
                    if idx is None:
                        idx = nearest(m, k)
                    chosen.append(idx)
                    feats = torch.gather(feats, 1, idx[..., None].expand(-1, -1, dim))
                    xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
                update = self._block(r * self.scales + scale, ctx, feats, xyz, traj_feats,
                                     traj_pos, time_pos, time_feats, mask, drop, gens)
                trajectory = torch.cat([trajectory[..., :3] + update[..., :3], update[..., 3:]],
                                       dim=-1)
                outputs.append(trajectory)
        return outputs, chosen, gap

    def _block(self, i, ctx, feats, xyz, traj_feats, traj_pos, time_pos, time_feats, mask,
               drop, gens):
        """Block ``i`` over one scale's tokens: the (B, L, output_dim)
        update, positions first."""
        def block(name):
            return getattr(self, name.format(i))

        ctx_pos = rotary_pe_3d(xyz, self.embedding_dim)
        ctx_feats, _ = block("vl_attention_{}")(feats, ctx["instr"], gens=gens)
        ctx_feats = torch.cat([ctx_feats, ctx["curr"], ctx["goal"]], dim=1)
        ctx_pos = torch.cat([ctx_pos, ctx["curr_pos"], ctx["goal_pos"]], dim=1)
        traj_feats, _ = block("traj_lang_attention_{}")(traj_feats, ctx["instr"],
                                                        seq1_key_padding_mask=mask,
                                                        seq1_sem_pos=time_pos, gens=gens)
        kw = dict(seq1_key_padding_mask=mask, seq1_pos=traj_pos, seq2_pos=ctx_pos,
                  seq1_sem_pos=time_pos, ada_sgnl=time_feats, gens=gens)
        traj_feats, _ = block("traj_attention_{}")(traj_feats, ctx_feats, **kw)
        pos_feats, _ = block("pos_attention_{}")(traj_feats, ctx_feats, **kw)
        rot_feats, _ = block("rot_attention_{}")(traj_feats, ctx_feats, **kw)
        pos = block("pos_regressor_{}_fc2")(drop(F.relu(block("pos_regressor_{}_fc1")(pos_feats))))
        rot = block("rot_regressor_{}_fc2")(drop(F.relu(block("rot_regressor_{}_fc1")(rot_feats))))
        return torch.cat([pos, rot], dim=-1)


class DiffusionPlanner(nn.Module):
    """The training loss of the multi-scale planner; normalisation, 6D
    conversion, schedules and the context are the one-block planner's."""

    def __init__(self, image_size=(256, 256), embedding_dim: int = 120,
                 num_vis_ins_attn_layers: int = 2, num_query_cross_attn_layers: int = 6,
                 diffusion_timesteps: int = 100, gripper_loc_bounds=None, dropout: float = 0.1,
                 feat_scales_to_use: int = 3, attn_rounds: int = 2):
        super().__init__()
        self.diffusion_timesteps = diffusion_timesteps
        self.register_buffer("gripper_loc_bounds",
                             torch.tensor(gripper_loc_bounds, dtype=torch.float32),
                             persistent=False)
        self.prediction_head = DiffusionHead(image_size, embedding_dim, 9, 8,
                                             num_vis_ins_attn_layers,
                                             num_query_cross_attn_layers, dropout,
                                             feat_scales_to_use, attn_rounds)
        self.schedules = None
        self.forwards = 0  # ``loss`` calls

    _schedules = planner.DiffusionPlanner._schedules
    normalize_pos = planner.DiffusionPlanner.normalize_pos
    to_6d = staticmethod(planner.DiffusionPlanner.to_6d)
    _gripper = planner.DiffusionPlanner._gripper
    _context = planner.DiffusionPlanner._context

    def loss(self, trajectory, mask, rgb, pcd, instruction, curr_gripper, goal_gripper,
             gens: Generators, follow: Optional[List[torch.Tensor]] = None,
             judge: bool = True):
        """The training loss of one batch, summed over the blocks (noise
        (B, L, 9) and timesteps (B,) drawn from ``gens.device`` in that
        order), the selections gathered, and the widest followed choice
        gap (judged as ``denoise`` says)."""
        self.forwards += 1
        ident = torch.zeros_like(trajectory[..., 3:7])
        ident[..., 3] = 1.0
        quat = torch.where(mask[..., None], ident, trajectory[..., 3:7])
        gt = self.to_6d(torch.cat([self.normalize_pos(trajectory[..., :3]), quat], dim=-1))
        curr, goal = self._gripper(curr_gripper), self._gripper(goal_gripper)
        b = gt.shape[0]
        noise = torch.randn(gt.shape, generator=gens.device, device=gt.device)
        timesteps = torch.randint(0, self.diffusion_timesteps, (b,), generator=gens.device,
                                  device=gt.device)
        pos_s, rot_s = self._schedules()
        noisy = torch.cat([pos_s.add_noise(gt[..., :3], noise[..., :3], timesteps),
                           rot_s.add_noise(gt[..., 3:9], noise[..., 3:9], timesteps)], dim=-1)
        ctx = self._context(rgb, pcd, instruction, curr, goal)
        preds, chosen, gap = self.prediction_head.denoise(noisy, mask, timesteps, ctx, gens,
                                                          follow, judge)
        valid = (~mask)[..., None].to(gt.dtype)
        n = valid.sum().clamp_min(1.0)
        total = 0.0
        for pred in preds:
            pos_l1 = ((pred[..., :3] - gt[..., :3]).abs() * valid).sum() / (n * 3.0)
            rot_l1 = ((pred[..., 3:9] - gt[..., 3:9]).abs() * valid).sum() / (n * 6.0)
            total = total + 100.0 * pos_l1 + 10.0 * rot_l1
        return total, chosen, gap
