"""Act3D keypose predictor (PyTorch).

Counterpart of ``act3d_tpu/models/act3d.py::Act3D``: frozen CLIP trunk +
FPN tokens; coarse-to-fine ghost points (level 0 uniform in the workspace
cube, level i >= 1 uniform in a shrinking ball around the previous
estimate, or around the ground-truth position when ``gt_action`` is
given); ghost points and one learned query cross-attend to [visual +
gripper (+ instruction)] context with rotary-3D relative positions; the
query decodes a dot-product mask over the ghost points and the argmax ghost
point is the position.

Fine levels attend to the top-k (32*32*ncam) context tokens nearest the
previous estimate, sorted by index as in JAX, so the gather's backward is
the sorted row-scatter kernel.  The reference configuration is ported:
weights tied across levels (JAX ``weight_tying`` and ``gp_emb_tying``, one
submodule called at every level), the rotation read from the query as a
quaternion (``quat_from_query``) and the optional ``regress_position_offset``
heads.  JAX's ``train_mode`` is the module's training flag: it picks
``num_ghost_points`` (training) or ``num_ghost_points_val``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.encoder import VisualEncoder
from ..nn.layers import RelativeCrossAttentionModule
from ..ops import rotations as R
from ..ops.geometry import gather_tokens, topk_nearest_context
from ..ops.rotary import rotary_pe_3d
from ..ops.sampling import ghost_point_bounds, sample_uniform_ball, sample_uniform_cube

_BALL_DIAMETER_DIVISORS = [None, 1.0, 4.0, 16.0]
_QUAT_DIM = 4


class Act3D(nn.Module):
    def __init__(
        self,
        image_size=(256, 256),
        embedding_dim: int = 60,
        num_attn_heads: int = 4,
        num_ghost_point_cross_attn_layers: int = 2,
        num_query_cross_attn_layers: int = 2,
        num_vis_ins_attn_layers: int = 2,
        gripper_loc_bounds=((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)),
        num_ghost_points: int = 1000,
        num_ghost_points_val: int = 10000,
        num_sampling_level: int = 3,
        fine_sampling_ball_diameter: float = 0.16,
        regress_position_offset: bool = False,
        use_instruction: bool = False,
        device="cuda",
    ):
        super().__init__()
        dim = embedding_dim
        if dim % 3 != 0 or dim % num_attn_heads != 0:
            raise ValueError(
                f"embedding_dim {dim} must divide by 3 (one rotary band per "
                f"axis) and by num_attn_heads {num_attn_heads}"
            )
        self.image_size = tuple(image_size)
        self.embedding_dim = dim
        self.num_sampling_level = num_sampling_level
        self.num_ghost_points = num_ghost_points
        self.num_ghost_points_val = num_ghost_points_val
        self.regress_position_offset = regress_position_offset
        self.fine_sampling_ball_diameter = fine_sampling_ball_diameter
        self.use_instruction = use_instruction
        self.register_buffer(
            "gripper_loc_bounds",
            torch.tensor(gripper_loc_bounds, dtype=torch.float32), persistent=False,
        )

        self.visual = VisualEncoder(self.image_size, dim, num_sampling_level)
        self.ghost_points_embed = nn.Parameter(torch.randn(1, dim))
        self.curr_gripper_embed = nn.Parameter(torch.randn(1, dim))
        self.query_embed = nn.Parameter(torch.randn(1, dim))

        self.ghost_point_cross_attn = RelativeCrossAttentionModule(
            dim, num_attn_heads, num_ghost_point_cross_attn_layers)
        self.query_cross_attn = RelativeCrossAttentionModule(
            dim, num_attn_heads, num_query_cross_attn_layers)
        if use_instruction:
            self.vis_ins_attn = RelativeCrossAttentionModule(
                dim, num_attn_heads, num_vis_ins_attn_layers)
            self.instruction_encoder = nn.Linear(512, dim)
        self.gripper_state_fc1 = nn.Linear(dim, dim)
        self.gripper_state_fc2 = nn.Linear(dim, _QUAT_DIM + 1)
        if regress_position_offset:
            self.ghost_point_offset_fc1 = nn.Linear(dim, dim)
            self.ghost_point_offset_fc2 = nn.Linear(dim, 3)
        self.to(resolve_device(device))

    def forward(
        self,
        visible_rgb: torch.Tensor,  # (B, ncam, 3, H, W) in [0, 1]
        visible_pcd: torch.Tensor,  # (B, ncam, 3, H, W) world coords
        instruction: Optional[torch.Tensor],  # (B, 53, 512)
        curr_gripper: torch.Tensor,  # (B, 8)
        *,
        generator: Optional[torch.Generator] = None,
        gt_action: Optional[torch.Tensor] = None,  # (B, 8): centres the fine balls
        ghost_points_override: Optional[Sequence[torch.Tensor]] = None,
        ghost_uniforms: Optional[Sequence[torch.Tensor]] = None,
    ) -> Dict[str, object]:
        """Ghost points are drawn from ``generator``, or from the uniforms
        the samplers would draw (``ghost_uniforms``: (B, N, 3) at level 0,
        (B, 4N, 3) above), unless ``ghost_points_override`` gives each
        level's (B, N, 3) points."""
        dim = self.embedding_dim
        levels = self.num_sampling_level
        b, ncam = visible_rgb.shape[:2]
        bounds = self.gripper_loc_bounds
        n_ghost = (self.num_ghost_points if self.training else self.num_ghost_points_val) // levels
        fine_k = 32 * 32 * ncam
        gt_position = None if gt_action is None else gt_action[:, :3].detach()
        batch_rows = torch.arange(b, device=visible_rgb.device)

        rgb_feats_pyramid, pcd_pyramid = self.visual(visible_rgb, visible_pcd)

        instr_feats = instr_dummy_pos = None
        if self.use_instruction:
            instr_feats = self.instruction_encoder(instruction)
            instr_dummy_pos = rotary_pe_3d(
                torch.zeros(b, instr_feats.shape[1], 3, device=instr_feats.device), dim
            )
        curr_gripper_pos = rotary_pe_3d(curr_gripper[:, None, :3], dim)
        curr_gripper_feats = self.curr_gripper_embed[None].expand(b, 1, dim)

        ghost_pcd_pyramid, ghost_pcd_masks_pyramid, position_pyramid = [], [], []
        query_features = self.query_embed[None].expand(b, 1, dim)
        for i in range(levels):
            u = None if ghost_uniforms is None else ghost_uniforms[i]
            if ghost_points_override is not None:
                ghost_pcd_i = ghost_points_override[i]
                n_ghost = ghost_pcd_i.shape[1]
            elif i == 0:
                ghost_pcd_i = sample_uniform_cube(
                    bounds.expand(b, 2, 3), n_ghost, generator=generator, u=u
                )
            else:
                anchor = gt_position if gt_position is not None else position_pyramid[-1]
                diameter = self.fine_sampling_ball_diameter / _BALL_DIAMETER_DIVISORS[i]
                ghost_pcd_i = sample_uniform_ball(
                    anchor, diameter / 2.0, ghost_point_bounds(anchor, diameter, bounds),
                    n_ghost, generator=generator, u=u,
                )

            if i == 0:
                context_feats_i = rgb_feats_pyramid[0]
                context_xyz_i = pcd_pyramid[0]
            else:
                idx = topk_nearest_context(position_pyramid[-1], pcd_pyramid[i], fine_k)
                idx = torch.sort(idx, dim=-1).values
                context_feats_i = gather_tokens(rgb_feats_pyramid[i], idx, sorted_indices=True)
                context_xyz_i = gather_tokens(pcd_pyramid[i], idx, sorted_indices=True)
            context_pos_i = rotary_pe_3d(context_xyz_i, dim)
            context_feats_i = torch.cat([context_feats_i, curr_gripper_feats], dim=1)
            context_pos_i = torch.cat([context_pos_i, curr_gripper_pos], dim=1)
            if self.use_instruction:
                context_feats_i = self.vis_ins_attn(context_feats_i, instr_feats)[-1]
                context_feats_i = torch.cat([context_feats_i, instr_feats], dim=1)
                context_pos_i = torch.cat([context_pos_i, instr_dummy_pos], dim=1)

            ghost_pos_i = rotary_pe_3d(ghost_pcd_i, dim)
            ghost_feats_i = self.ghost_points_embed[None].expand(b, n_ghost, dim)
            ghost_feats_i = self.ghost_point_cross_attn(
                ghost_feats_i, context_feats_i, query_pos=ghost_pos_i,
                value_pos=context_pos_i,
            )[-1]

            if i == 0:
                query_pos_i = context_pos_for_query = None
            else:
                query_pos_i = rotary_pe_3d(position_pyramid[-1][:, None], dim)
                context_pos_for_query = context_pos_i
            query_outputs = self.query_cross_attn(
                query_features, context_feats_i, query_pos=query_pos_i,
                value_pos=context_pos_for_query,
            )
            query_features = query_outputs[-1]

            masks_i = [torch.einsum("bc,bnc->bn", qf[:, 0], ghost_feats_i)
                       for qf in query_outputs]
            top_idx = torch.argmax(masks_i[-1], dim=-1)
            position_pyramid.append(ghost_pcd_i[batch_rows, top_idx])
            ghost_pcd_pyramid.append(ghost_pcd_i)
            ghost_pcd_masks_pyramid.append(masks_i)

        position = position_pyramid[-1]
        fine_ghost_pcd_offsets = None
        if self.regress_position_offset:
            fine_ghost_pcd_offsets = self.ghost_point_offset_fc2(
                F.relu(self.ghost_point_offset_fc1(ghost_feats_i)))
            position = position + fine_ghost_pcd_offsets[batch_rows, top_idx]

        pred = self.gripper_state_fc2(F.relu(self.gripper_state_fc1(query_features[:, 0])))
        return {
            "position": position,
            "rotation": R.normalise_quat(pred[:, :_QUAT_DIM]),
            "gripper": torch.sigmoid(pred[:, _QUAT_DIM:]),
            "position_pyramid": position_pyramid,
            "ghost_pcd_pyramid": ghost_pcd_pyramid,
            "ghost_pcd_masks_pyramid": ghost_pcd_masks_pyramid,
            "fine_ghost_pcd_offsets": fine_ghost_pcd_offsets,
        }
