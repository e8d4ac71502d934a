"""ChainedDiffuser denoiser network (PyTorch).

Counterpart of ``act3d_tpu/models/diffusion_head.py::DiffusionHead``:
``encode_context`` runs once per observation (frozen visual encoding,
instruction and gripper tokens), ``denoise`` runs every diffusion step.
As in JAX, ``vl_attention`` (visual tokens attending to the instruction)
sits inside ``denoise`` and is recomputed every step although its inputs
do not change.  In training mode ``denoise`` applies JAX's dropout (rate
0.1 by default) after ``traj_enc_fc1`` and the regressors' ``fc1`` and
inside every attention stack, drawn from the ``generators`` it is given.

The head runs ``attn_rounds`` rounds over ``feat_scales_to_use`` feature
scales: ``n_blocks = attn_rounds * feat_scales_to_use`` blocks, each with
its own attention stacks and regressors under flax's names
(``vl_attention_{i}``, ``traj_attention_{i}``, ``pos_regressor_{i}_fc1``,
...), block ``round * scales + scale`` attending to that scale's visual
tokens.  With ``use_goal``, scales above 0 attend only to the
``nn_per_step * L`` points nearest the trajectory so far
(``ops.geometry.find_traj_nn``: 64 per step at scale 1, 16 above), gathered
with ``torch.gather`` as JAX gathers them with ``take_along_axis`` (the
gather's backward is autograd's scatter-add, as XLA's); without it they
attend to the whole level.  Every block updates the trajectory (positions
by residual, rotations replaced) and ``denoise`` returns every block's
trajectory.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.encoder import VisualEncoder
from ..nn.dropout import Generators, dropout
from ..nn.layers import ParallelAttention, active_generators
from ..ops.geometry import find_traj_nn
from ..ops.rotary import rotary_pe_3d, sinusoidal_pos_emb


def _xavier_linear(d_in: int, d_out: int) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class DiffusionHead(nn.Module):
    def __init__(
        self,
        backbone: str = "clip",
        image_size=(256, 256),
        embedding_dim: int = 120,
        output_dim: int = 9,
        num_attn_heads: int = 8,
        num_vis_ins_attn_layers: int = 2,
        num_query_cross_attn_layers: int = 6,
        use_instruction: bool = False,
        use_goal: bool = False,
        feat_scales_to_use: int = 1,
        attn_rounds: int = 1,
        dropout: float = 0.1,
    ):
        super().__init__()
        dim = embedding_dim
        self.dropout = dropout
        if dim % 3 != 0 or dim % num_attn_heads != 0:
            raise ValueError(
                f"embedding_dim {dim} must divide by 3 (one rotary band per "
                f"axis) and by num_attn_heads {num_attn_heads}"
            )
        self.embedding_dim = dim
        self.use_instruction = use_instruction
        self.use_goal = use_goal
        self.feat_scales_to_use = feat_scales_to_use
        self.attn_rounds = attn_rounds
        self.visual = VisualEncoder(image_size, dim, feat_scales_to_use, backbone)
        self.traj_enc_fc1 = nn.Linear(output_dim, dim)
        self.traj_enc_fc2 = nn.Linear(dim, dim)
        self.curr_gripper_encoder = nn.Linear(output_dim, dim)
        if use_goal:
            self.goal_gripper_encoder = nn.Linear(output_dim, dim)
        if use_instruction:
            self.instruction_encoder = nn.Linear(512, dim)
        self.curr_gripper_embed = nn.Parameter(torch.randn(1, dim))
        self.goal_gripper_embed = nn.Parameter(torch.randn(1, dim))

        cross_only = dict(d_model=dim, n_heads=num_attn_heads, self_attention1=False,
                          self_attention2=False, cross_attention1=True,
                          cross_attention2=False, dropout=dropout)
        traj = dict(d_model=dim, n_heads=num_attn_heads, self_attention1=True,
                    self_attention2=False, cross_attention1=True,
                    cross_attention2=False, rotary_pe=True, use_adaln=True,
                    dropout=dropout)
        for i in range(attn_rounds * feat_scales_to_use):
            if use_instruction:
                setattr(self, f"vl_attention_{i}",
                        ParallelAttention(num_vis_ins_attn_layers, **cross_only))
                setattr(self, f"traj_lang_attention_{i}",
                        ParallelAttention(1, apply_ffn=False, **cross_only))
            setattr(self, f"traj_attention_{i}",
                    ParallelAttention(num_query_cross_attn_layers - 2, **traj))
            setattr(self, f"pos_attention_{i}", ParallelAttention(2, **traj))
            setattr(self, f"rot_attention_{i}", ParallelAttention(2, **traj))
            setattr(self, f"pos_regressor_{i}_fc1", _xavier_linear(dim, dim))
            setattr(self, f"pos_regressor_{i}_fc2", _xavier_linear(dim, 3))
            setattr(self, f"rot_regressor_{i}_fc1", _xavier_linear(dim, dim))
            setattr(self, f"rot_regressor_{i}_fc2", _xavier_linear(dim, output_dim - 3))

    def encode_context(
        self,
        visible_rgb: torch.Tensor,  # (B, ncam, 3, H, W) in [0, 1]
        visible_pcd: torch.Tensor,  # (B, ncam, 3, H, W), normalised coords
        curr_gripper: torch.Tensor,  # (B, output_dim)
        goal_gripper: Optional[torch.Tensor],
        instruction: Optional[torch.Tensor],  # (B, 53, 512)
    ) -> Dict[str, object]:
        """The trajectory-independent conditioning tensors."""
        dim = self.embedding_dim
        b = visible_rgb.shape[0]
        rgb_feats_pyramid, pcd_pyramid = self.visual(visible_rgb, visible_pcd)
        # the feature inputs in the image's dtype, as JAX casts them (the
        # poses arrive float32 from the normalisation against float32
        # bounds); the rotary codes keep the float32 poses
        dtype = visible_rgb.dtype
        instr_feats = (self.instruction_encoder(instruction.to(dtype))
                       if self.use_instruction else None)
        curr_gripper_feats = (
            self.curr_gripper_encoder(curr_gripper.to(dtype))[:, None]
            + self.curr_gripper_embed[None].expand(b, 1, dim)
        )
        context = dict(
            rgb_feats_pyramid=rgb_feats_pyramid,
            pcd_pyramid=pcd_pyramid,
            instr_feats=instr_feats,
            curr_gripper_feats=curr_gripper_feats,
            curr_gripper_pos=rotary_pe_3d(curr_gripper[:, None, :3], dim),
            goal_gripper_feats=None,
            goal_gripper_pos=None,
        )
        if self.use_goal:
            context["goal_gripper_feats"] = (
                self.goal_gripper_encoder(goal_gripper.to(dtype))[:, None]
                + self.goal_gripper_embed[None].expand(b, 1, dim)
            )
            context["goal_gripper_pos"] = rotary_pe_3d(goal_gripper[:, None, :3], dim)
        return context

    def denoise(
        self,
        trajectory: torch.Tensor,  # (B, L, output_dim)
        trajectory_mask: torch.Tensor,  # (B, L) bool, True = padding
        timestep: torch.Tensor,  # (B,)
        context: Dict[str, object],
        generators: Optional[Generators] = None,
    ) -> List[torch.Tensor]:
        """Every block's clean-trajectory prediction (B, L, output_dim), in
        block order.  ``generators`` drive dropout in training mode."""
        dim = self.embedding_dim
        b, length = trajectory.shape[:2]
        gens = active_generators(self, self.dropout, generators)

        def drop(x):
            return dropout(x, self.dropout, gens)

        # the trunk in the visual features' dtype, as JAX; the trajectory
        # keeps its own for the residual update and the rotary phases
        dtype = context["rgb_feats_pyramid"][0].dtype
        traj_feats = self.traj_enc_fc2(drop(F.relu(self.traj_enc_fc1(trajectory.to(dtype)))))
        traj_pos = rotary_pe_3d(trajectory[..., :3], dim)
        time_feats = sinusoidal_pos_emb(timestep, dim).to(dtype)
        traj_time_pos = sinusoidal_pos_emb(
            torch.arange(length, device=trajectory.device), dim
        )[None].expand(b, length, dim)

        outputs: List[torch.Tensor] = []
        for attn_round in range(self.attn_rounds):
            for scale in range(self.feat_scales_to_use):
                context_feats = context["rgb_feats_pyramid"][scale]
                context_xyz = context["pcd_pyramid"][scale]
                if self.use_goal and scale > 0:
                    prev = outputs[-1] if outputs else trajectory
                    idx = find_traj_nn(prev[..., :3], context_xyz,
                                       nn_per_step=64 if scale == 1 else 16)
                    context_feats = torch.gather(
                        context_feats, 1, idx[..., None].expand(-1, -1, dim))
                    context_xyz = torch.gather(context_xyz, 1, idx[..., None].expand(-1, -1, 3))
                i = attn_round * self.feat_scales_to_use + scale
                update = self._block(i, context, context_feats, context_xyz, traj_feats,
                                     traj_pos, traj_time_pos, time_feats, trajectory_mask,
                                     drop, generators)
                trajectory = torch.cat([trajectory[..., :3] + update[..., :3],
                                        update[..., 3:]], dim=-1)
                outputs.append(trajectory)
        return outputs

    def _block(self, i, context, context_feats, context_xyz, traj_feats, traj_pos,
               traj_time_pos, time_feats, trajectory_mask, drop, generators):
        """Block ``i`` over one scale's context: the (B, L, output_dim)
        update, positions first."""
        dim = self.embedding_dim
        context_pos = rotary_pe_3d(context_xyz, dim)
        if self.use_instruction:
            context_feats, _ = getattr(self, f"vl_attention_{i}")(
                context_feats, context["instr_feats"], generators=generators)
        context_feats = torch.cat([context_feats, context["curr_gripper_feats"]], dim=1)
        context_pos = torch.cat([context_pos, context["curr_gripper_pos"]], dim=1)
        if self.use_goal:
            context_feats = torch.cat([context_feats, context["goal_gripper_feats"]], dim=1)
            context_pos = torch.cat([context_pos, context["goal_gripper_pos"]], dim=1)

        if self.use_instruction:
            traj_feats, _ = getattr(self, f"traj_lang_attention_{i}")(
                traj_feats, context["instr_feats"],
                seq1_key_padding_mask=trajectory_mask, seq1_sem_pos=traj_time_pos,
                generators=generators,
            )
        kwargs = dict(seq1_key_padding_mask=trajectory_mask, seq1_pos=traj_pos,
                      seq2_pos=context_pos, seq1_sem_pos=traj_time_pos,
                      ada_sgnl=time_feats, generators=generators)
        traj_feats, _ = getattr(self, f"traj_attention_{i}")(traj_feats, context_feats, **kwargs)
        pos_feats, _ = getattr(self, f"pos_attention_{i}")(traj_feats, context_feats, **kwargs)
        rot_feats, _ = getattr(self, f"rot_attention_{i}")(traj_feats, context_feats, **kwargs)
        pos = getattr(self, f"pos_regressor_{i}_fc2")(
            drop(F.relu(getattr(self, f"pos_regressor_{i}_fc1")(pos_feats))))
        rot = getattr(self, f"rot_regressor_{i}_fc2")(
            drop(F.relu(getattr(self, f"rot_regressor_{i}_fc1")(rot_feats))))
        return torch.cat([pos, rot], dim=-1)
