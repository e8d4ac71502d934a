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
the sorted row-scatter kernel; ``approx_topk`` selects them with
``topk_nearest_context(approx=True)`` (ops/geometry.py states its rule).
Every option of JAX's module is ported:

  * ``backbone``: ``clip`` or ``resnet`` (nn/encoder.py);
  * ``weight_tying`` / ``gp_emb_tying``: tied levels call one submodule
    (``ghost_point_cross_attn``, ``query_cross_attn``, ``vis_ins_attn``)
    and read one ``ghost_points_embed``; untied levels have one per level
    under flax's names (``ghost_point_cross_attn_{i}``,
    ``ghost_points_embed_{i}``, ...);
  * ``rotation_parametrization``: the rotation comes from the query
    (``*_from_query``) or from the last level's ghost-point feature at the
    argmax of the final mask (``*_from_top_ghost``, the first maximum as
    ``jnp.argmax``), as a unit quaternion (``quat_*``, 4 numbers) or a
    rotation matrix from ortho-6D (``6D*``, 6 numbers, (B, 3, 3) out);
  * the ``regress_position_offset`` heads.

JAX's ``train_mode`` is the module's training flag: it picks
``num_ghost_points`` (training) or ``num_ghost_points_val``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.dropout import Generators, draw
from ..nn.encoder import VisualEncoder
from ..nn.layers import RelativeCrossAttentionModule
from ..ops import rotations as R
from ..ops.geometry import gather_tokens, topk_nearest_context
from ..ops.rotary import rotary_pe_3d
from ..ops.sampling import (OVERSAMPLE, ghost_point_bounds, sample_uniform_ball,
                            sample_uniform_cube)

_BALL_DIAMETER_DIVISORS = [None, 1.0, 4.0, 16.0]


class Act3D(nn.Module):
    def __init__(
        self,
        backbone: str = "clip",
        image_size=(256, 256),
        embedding_dim: int = 60,
        num_attn_heads: int = 4,
        num_ghost_point_cross_attn_layers: int = 2,
        num_query_cross_attn_layers: int = 2,
        num_vis_ins_attn_layers: int = 2,
        rotation_parametrization: str = "quat_from_query",
        gripper_loc_bounds=((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)),
        num_ghost_points: int = 1000,
        num_ghost_points_val: int = 10000,
        weight_tying: bool = True,
        gp_emb_tying: bool = True,
        num_sampling_level: int = 3,
        fine_sampling_ball_diameter: float = 0.16,
        regress_position_offset: bool = False,
        use_instruction: bool = False,
        approx_topk: bool = False,
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
        self.approx_topk = approx_topk
        self.weight_tying = weight_tying
        self.gp_emb_tying = gp_emb_tying
        self.rotation_parametrization = rotation_parametrization
        self.rotation_dim = 4 if "quat" in rotation_parametrization else 6
        self.register_buffer(
            "gripper_loc_bounds",
            torch.tensor(gripper_loc_bounds, dtype=torch.float32), persistent=False,
        )

        self.visual = VisualEncoder(self.image_size, dim, num_sampling_level, backbone)
        for name in self._level_names("ghost_points_embed", gp_emb_tying):
            setattr(self, name, nn.Parameter(torch.randn(1, dim)))
        self.curr_gripper_embed = nn.Parameter(torch.randn(1, dim))
        self.query_embed = nn.Parameter(torch.randn(1, dim))

        stacks = [("ghost_point_cross_attn", num_ghost_point_cross_attn_layers),
                  ("query_cross_attn", num_query_cross_attn_layers)]
        if use_instruction:
            stacks.append(("vis_ins_attn", num_vis_ins_attn_layers))
        for stack, n_layers in stacks:
            for name in self._level_names(stack, weight_tying):
                setattr(self, name, RelativeCrossAttentionModule(dim, num_attn_heads, n_layers))
        if use_instruction:
            self.instruction_encoder = nn.Linear(512, dim)
        self.gripper_state_fc1 = nn.Linear(dim, dim)
        self.gripper_state_fc2 = nn.Linear(dim, self.rotation_dim + 1)
        if regress_position_offset:
            self.ghost_point_offset_fc1 = nn.Linear(dim, dim)
            self.ghost_point_offset_fc2 = nn.Linear(dim, 3)
        self.to(resolve_device(device))

    def _level_names(self, name: str, tied: bool):
        """One submodule or parameter for every level (tied), or one per
        level under flax's ``{name}_{i}``."""
        return [name] if tied else [f"{name}_{i}" for i in range(self.num_sampling_level)]

    def _level(self, name: str, tied: bool, i: int):
        """Level ``i``'s submodule or parameter."""
        return getattr(self, name if tied else f"{name}_{i}")

    def forward(
        self,
        visible_rgb: torch.Tensor,  # (B, ncam, 3, H, W) in [0, 1]
        visible_pcd: torch.Tensor,  # (B, ncam, 3, H, W) world coords
        instruction: Optional[torch.Tensor],  # (B, 53, 512)
        curr_gripper: torch.Tensor,  # (B, 8)
        *,
        generator: Optional[Union[Generators, torch.Generator]] = None,
        gt_action: Optional[torch.Tensor] = None,  # (B, 8): centres the fine balls
        ghost_points_override: Optional[Sequence[torch.Tensor]] = None,
        ghost_uniforms: Optional[Sequence[torch.Tensor]] = None,
    ) -> Dict[str, object]:
        """Ghost points are drawn from ``generator`` (a torch.Generator, or
        :class:`Generators`, which draw at the global batch, nn/dropout.py),
        or from the uniforms the samplers would draw (``ghost_uniforms``:
        (B, N, 3) at level 0, (B, 4N, 3) above), unless
        ``ghost_points_override`` gives each level's (B, N, 3) points."""
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
            if ghost_uniforms is not None:
                u = ghost_uniforms[i]
            elif ghost_points_override is None:
                u = draw(generator, torch.rand, (b, n_ghost * (1 if i == 0 else OVERSAMPLE), 3),
                         bounds.device, dtype=torch.float32)
            if ghost_points_override is not None:
                ghost_pcd_i = ghost_points_override[i]
                n_ghost = ghost_pcd_i.shape[1]
            elif i == 0:
                ghost_pcd_i = sample_uniform_cube(
                    bounds.expand(b, 2, 3), n_ghost, u=u
                )
            else:
                anchor = gt_position if gt_position is not None else position_pyramid[-1]
                diameter = self.fine_sampling_ball_diameter / _BALL_DIAMETER_DIVISORS[i]
                ghost_pcd_i = sample_uniform_ball(
                    anchor, diameter / 2.0, ghost_point_bounds(anchor, diameter, bounds),
                    n_ghost, u=u,
                )

            if i == 0:
                context_feats_i = rgb_feats_pyramid[0]
                context_xyz_i = pcd_pyramid[0]
            else:
                idx = topk_nearest_context(position_pyramid[-1], pcd_pyramid[i], fine_k,
                                           approx=self.approx_topk)
                idx = torch.sort(idx, dim=-1).values
                context_feats_i = gather_tokens(rgb_feats_pyramid[i], idx, sorted_indices=True)
                context_xyz_i = gather_tokens(pcd_pyramid[i], idx, sorted_indices=True)
            context_pos_i = rotary_pe_3d(context_xyz_i, dim)
            context_feats_i = torch.cat([context_feats_i, curr_gripper_feats], dim=1)
            context_pos_i = torch.cat([context_pos_i, curr_gripper_pos], dim=1)
            if self.use_instruction:
                vis_ins_attn = self._level("vis_ins_attn", self.weight_tying, i)
                context_feats_i = vis_ins_attn(context_feats_i, instr_feats)[-1]
                context_feats_i = torch.cat([context_feats_i, instr_feats], dim=1)
                context_pos_i = torch.cat([context_pos_i, instr_dummy_pos], dim=1)

            ghost_pos_i = rotary_pe_3d(ghost_pcd_i, dim)
            ghost_embed = self._level("ghost_points_embed", self.gp_emb_tying, i)
            ghost_feats_i = ghost_embed[None].expand(b, n_ghost, dim)
            ghost_feats_i = self._level("ghost_point_cross_attn", self.weight_tying, i)(
                ghost_feats_i, context_feats_i, query_pos=ghost_pos_i,
                value_pos=context_pos_i,
            )[-1]

            if i == 0:
                query_pos_i = context_pos_for_query = None
            else:
                query_pos_i = rotary_pe_3d(position_pyramid[-1][:, None], dim)
                context_pos_for_query = context_pos_i
            query_outputs = self._level("query_cross_attn", self.weight_tying, i)(
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

        if self.rotation_parametrization.endswith("from_top_ghost"):
            features = ghost_feats_i[batch_rows, top_idx]
        else:  # *_from_query
            features = query_features[:, 0]
        pred = self.gripper_state_fc2(F.relu(self.gripper_state_fc1(features)))
        rot = pred[:, :self.rotation_dim]
        return {
            "position": position,
            "rotation": (R.normalise_quat(rot) if self.rotation_dim == 4
                         else R.rotation_matrix_from_ortho6d(rot)),
            "gripper": torch.sigmoid(pred[:, self.rotation_dim:]),
            "position_pyramid": position_pyramid,
            "ghost_pcd_pyramid": ghost_pcd_pyramid,
            "ghost_pcd_masks_pyramid": ghost_pcd_masks_pyramid,
            "fine_ghost_pcd_offsets": fine_ghost_pcd_offsets,
        }
