"""Plain PyTorch ChainedDiffuser trajectory model of the reference (Xian
et al., CoRL 2023), at the options of ``scripts/train_trajectory.sh``: the
CLIP trunk, one feature scale and one attention round, 8 heads,
instruction- and goal-conditioned, ortho-6D rotations, DDPM over 100 steps
predicting the clean sample.

Written for the benchmark after ``act3d_tpu/models/diffusion_head.py`` and
``diffusion_planner.py`` and diffusers' DDPMScheduler: positions normalised
to [-1, 1] by the workspace bounds; the dataset's quaternion fed to the
wxyz formulas unchanged; two schedules (positions scaled_linear, rotations
squaredcos_cap_v2, beta 1e-4..0.02, derived in float64), x0 clipped to
[-1, 1], fixed_small variance; the loss 100 L1(pos) + 10 L1(rot6d) over
the valid points at one uniform timestep per sample.  ``denoise``
recomputes the vision-language attention every step, as the published
model does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Generators, ParallelAttention, dropout, rotary_pe_3d,
                     sinusoidal_pos_emb)
from .trunk import VisualEncoder


# ---------------------------------------------------------------- rotations
def normalise_quat(q):
    return q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-10)


def quaternion_to_matrix(q):
    r, i, j, k = torch.unbind(q, -1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack([1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)],
                    dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m):
    """The best-conditioned of the four candidate quaternions."""
    shape = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m.reshape(shape + (9,)), -1)
    q_abs = torch.sqrt(torch.clamp(torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                                                1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                                               dim=-1), min=0.0))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2) / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    return torch.gather(cands, -2, best[..., None, None].expand(shape + (1, 4)))[..., 0, :]


def _unit(v, eps=1e-8):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=eps)


def matrix_from_ortho6d(x):
    a = _unit(x[..., 0:3])
    c = _unit(torch.linalg.cross(a, x[..., 3:6], dim=-1))
    return torch.stack([a, torch.linalg.cross(c, a, dim=-1), c], dim=-1)


def ortho6d_from_matrix(m):
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


# -------------------------------------------------------------------- DDPM
class Schedule:
    """diffusers' DDPMScheduler tables for prediction_type="sample"."""

    def __init__(self, kind: str, steps: int, device):
        if kind == "scaled_linear":
            betas = np.linspace(1e-4 ** 0.5, 0.02 ** 0.5, steps, dtype=np.float64) ** 2
        else:  # squaredcos_cap_v2
            def bar(t):
                return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
            betas = np.asarray([min(1.0 - bar((i + 1) / steps) / bar(i / steps), 0.999)
                                for i in range(steps)], np.float64)
        ac = np.cumprod(1.0 - betas)
        prev = np.concatenate([[1.0], ac[:-1]])
        alpha = ac / prev
        beta_prod = 1.0 - ac

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.sqrt_ac = t(np.sqrt(ac))
        self.sqrt_1m_ac = t(np.sqrt(1.0 - ac))
        self.x0_coeff = t(np.sqrt(prev) * (1.0 - alpha) / beta_prod)
        self.xt_coeff = t(np.sqrt(alpha) * (1.0 - prev) / beta_prod)
        self.variance = t(np.maximum((1.0 - prev) / beta_prod * (1.0 - alpha), 1e-20))

    def add_noise(self, x0, noise, timesteps):
        shape = timesteps.shape + (1,) * (x0.ndim - 1)
        return (self.sqrt_ac[timesteps].reshape(shape) * x0
                + self.sqrt_1m_ac[timesteps].reshape(shape) * noise)

    def step(self, x0_hat, t: int, sample, noise):
        x0 = torch.clamp(x0_hat, -1.0, 1.0)
        prev = self.x0_coeff[t] * x0 + self.xt_coeff[t] * sample
        return prev + torch.sqrt(self.variance[t]) * noise if t > 0 else prev


# -------------------------------------------------------------------- head
class DiffusionHead(nn.Module):
    def __init__(self, image_size, embedding_dim: int = 120, output_dim: int = 9,
                 num_attn_heads: int = 8, num_vis_ins_attn_layers: int = 2,
                 num_query_cross_attn_layers: int = 6, dropout: float = 0.1):
        super().__init__()
        dim = embedding_dim
        self.embedding_dim = dim
        self.dropout = dropout
        self.visual = VisualEncoder(image_size, dim, 1)
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
        self.vl_attention_0 = ParallelAttention(num_vis_ins_attn_layers, **cross)
        self.traj_lang_attention_0 = ParallelAttention(1, apply_ffn=False, **cross)
        self.traj_attention_0 = ParallelAttention(num_query_cross_attn_layers - 2, **traj)
        self.pos_attention_0 = ParallelAttention(2, **traj)
        self.rot_attention_0 = ParallelAttention(2, **traj)
        self.pos_regressor_0_fc1 = nn.Linear(dim, dim)
        self.pos_regressor_0_fc2 = nn.Linear(dim, 3)
        self.rot_regressor_0_fc1 = nn.Linear(dim, dim)
        self.rot_regressor_0_fc2 = nn.Linear(dim, output_dim - 3)

    def encode_context(self, rgb, pcd, curr, goal, instruction):
        dim = self.embedding_dim
        b = rgb.shape[0]
        tokens, points = self.visual(rgb, pcd)
        return dict(
            tokens=tokens[0], points=points[0], instr=self.instruction_encoder(instruction),
            curr=self.curr_gripper_encoder(curr)[:, None] + self.curr_gripper_embed[None].expand(b, 1, dim),
            curr_pos=rotary_pe_3d(curr[:, None, :3], dim),
            goal=self.goal_gripper_encoder(goal)[:, None] + self.goal_gripper_embed[None].expand(b, 1, dim),
            goal_pos=rotary_pe_3d(goal[:, None, :3], dim))

    def denoise(self, trajectory, mask, timestep, ctx, gens=None):
        """The clean-trajectory prediction (B, L, output_dim)."""
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
        ctx_pos = rotary_pe_3d(ctx["points"], dim)
        ctx_feats, _ = self.vl_attention_0(ctx["tokens"], ctx["instr"], gens=gens)
        ctx_feats = torch.cat([ctx_feats, ctx["curr"], ctx["goal"]], dim=1)
        ctx_pos = torch.cat([ctx_pos, ctx["curr_pos"], ctx["goal_pos"]], dim=1)
        traj_feats, _ = self.traj_lang_attention_0(traj_feats, ctx["instr"],
                                                   seq1_key_padding_mask=mask,
                                                   seq1_sem_pos=time_pos, gens=gens)
        kw = dict(seq1_key_padding_mask=mask, seq1_pos=traj_pos, seq2_pos=ctx_pos,
                  seq1_sem_pos=time_pos, ada_sgnl=time_feats, gens=gens)
        traj_feats, _ = self.traj_attention_0(traj_feats, ctx_feats, **kw)
        pos_feats, _ = self.pos_attention_0(traj_feats, ctx_feats, **kw)
        rot_feats, _ = self.rot_attention_0(traj_feats, ctx_feats, **kw)
        pos = self.pos_regressor_0_fc2(drop(F.relu(self.pos_regressor_0_fc1(pos_feats))))
        rot = self.rot_regressor_0_fc2(drop(F.relu(self.rot_regressor_0_fc1(rot_feats))))
        return torch.cat([trajectory[..., :3] + pos, rot], dim=-1)


class DiffusionPlanner(nn.Module):
    def __init__(self, image_size=(256, 256), embedding_dim: int = 120,
                 num_vis_ins_attn_layers: int = 2, num_query_cross_attn_layers: int = 6,
                 diffusion_timesteps: int = 100, gripper_loc_bounds=None, dropout: float = 0.1):
        super().__init__()
        self.diffusion_timesteps = diffusion_timesteps
        self.register_buffer("gripper_loc_bounds",
                             torch.tensor(gripper_loc_bounds, dtype=torch.float32),
                             persistent=False)
        self.prediction_head = DiffusionHead(image_size, embedding_dim, 9, 8,
                                             num_vis_ins_attn_layers,
                                             num_query_cross_attn_layers, dropout)
        self.schedules = None

    def _schedules(self):
        if self.schedules is None:
            dev = self.gripper_loc_bounds.device
            self.schedules = (Schedule("scaled_linear", self.diffusion_timesteps, dev),
                              Schedule("squaredcos_cap_v2", self.diffusion_timesteps, dev))
        return self.schedules

    def normalize_pos(self, pos):
        lo, hi = self.gripper_loc_bounds
        return (pos - lo) / (hi - lo) * 2.0 - 1.0

    def unnormalize_pos(self, pos):
        lo, hi = self.gripper_loc_bounds
        return (pos + 1.0) / 2.0 * (hi - lo) + lo

    @staticmethod
    def to_6d(x):
        """(..., 3 + 4) -> (..., 3 + 6)."""
        rot = ortho6d_from_matrix(quaternion_to_matrix(normalise_quat(x[..., 3:7])))
        return torch.cat([x[..., :3], rot], dim=-1)

    def _gripper(self, g):
        return self.to_6d(torch.cat([self.normalize_pos(g[..., :3]), g[..., 3:7]], dim=-1))

    def _context(self, rgb, pcd, instruction, curr, goal):
        pcd = self.normalize_pos(pcd.movedim(2, -1)).movedim(-1, 2)
        return self.prediction_head.encode_context(rgb, pcd, curr, goal, instruction)

    def loss(self, trajectory, mask, rgb, pcd, instruction, curr_gripper, goal_gripper,
             gens: Generators):
        """The training loss of one batch; noise (B, L, 9) and timesteps (B,)
        drawn from ``gens.device`` in that order."""
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
        pred = self.prediction_head.denoise(noisy, mask, timesteps, ctx, gens)
        valid = (~mask)[..., None].to(gt.dtype)
        n = valid.sum().clamp_min(1.0)
        pos_l1 = ((pred[..., :3] - gt[..., :3]).abs() * valid).sum() / (n * 3.0)
        rot_l1 = ((pred[..., 3:9] - gt[..., 3:9]).abs() * valid).sum() / (n * 6.0)
        return 100.0 * pos_l1 + 10.0 * rot_l1

    @torch.no_grad()
    def sample(self, mask, rgb, pcd, instruction, curr_gripper, goal_gripper, init_noise,
               step_noises):
        """The reverse process from (B, L, 9) ``init_noise`` with (T, B, L, 9)
        ``step_noises``; the start pose held at index 0 (the goal only
        conditions); returns (B, L, 7) poses with wxyz-formula quaternions."""
        b, length = mask.shape
        curr, goal = self._gripper(curr_gripper), self._gripper(goal_gripper)
        ctx = self._context(rgb, pcd, instruction, curr, goal)
        first = torch.zeros(b, length, 9, dtype=torch.bool, device=mask.device)
        first[:, 0] = True
        cond = torch.where(first, curr[:, None, :], torch.zeros(b, length, 9, device=mask.device))
        pos_s, rot_s = self._schedules()
        traj = init_noise + cond
        for i, t in enumerate(range(self.diffusion_timesteps - 1, -1, -1)):
            out = self.prediction_head.denoise(traj, mask, torch.full((b,), t, device=mask.device),
                                               ctx)
            out = torch.where(first, cond, out)
            if t == 0:
                traj = out
                break
            eps = step_noises[i]
            traj = torch.cat([pos_s.step(out[..., :3], t, traj[..., :3], eps[..., :3]),
                              rot_s.step(out[..., 3:9], t, traj[..., 3:9], eps[..., 3:9])], dim=-1)
        quat = matrix_to_quaternion(matrix_from_ortho6d(traj[..., 3:9]))
        return torch.cat([self.unnormalize_pos(traj[..., :3]), quat], dim=-1)
