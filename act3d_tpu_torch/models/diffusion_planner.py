"""ChainedDiffuser trajectory DDPM (PyTorch).

Counterpart of ``act3d_tpu/models/diffusion_planner.py``: two DDPM
schedules (positions: scaled_linear; rotations: squaredcos_cap_v2), both
predicting the clean sample; positions normalised to [-1, 1] by the
gripper workspace bounds; rotations as ortho-6D (``rotation_parametrization
"6D"``, 9 numbers a pose) or, for any other value, as the normalised
quaternion itself (7 numbers a pose, normalised again after sampling).  As
in the reference, the dataset-layout quaternion (xyzw) is fed to the
wxyz-convention maths unchanged; the 6D parametrization is
self-consistent under this relabelling, so outputs land back in dataset
layout.

``forward`` is the training loss of JAX ``DiffusionPlanner.__call__``:
noise at a uniform random timestep, the validity-masked
100 * L1(pos) + 10 * L1(rot) summed over the head's blocks, where L1(rot)
reads columns 3:9 and divides by 6 whatever the parametrization, as JAX
does.  :func:`compute_trajectory` encodes the observation once and runs
the reverse process as a Python loop over the steps, on the last block's
prediction.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..device import resolve_device
from ..nn.dropout import Generators, draw
from ..ops import rotations as R
from ..ops.schedulers import make_ddpm_schedule
from .diffusion_head import DiffusionHead


class DiffusionPlanner(nn.Module):
    def __init__(
        self,
        backbone: str = "clip",
        image_size=(256, 256),
        embedding_dim: int = 120,
        output_dim: int = 7,
        num_vis_ins_attn_layers: int = 2,
        num_query_cross_attn_layers: int = 6,
        use_instruction: bool = False,
        use_goal: bool = False,
        use_goal_at_test: bool = True,
        feat_scales_to_use: int = 1,
        attn_rounds: int = 1,
        rotation_parametrization: str = "6D",
        diffusion_timesteps: int = 100,
        gripper_loc_bounds=((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)),
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.output_dim = output_dim
        self.rotation_parametrization = rotation_parametrization
        self.internal_dim = output_dim + (2 if rotation_parametrization == "6D" else 0)
        self.use_instruction = use_instruction
        self.use_goal = use_goal
        self.use_goal_at_test = use_goal_at_test
        self.diffusion_timesteps = diffusion_timesteps
        self.register_buffer(
            "gripper_loc_bounds",
            torch.tensor(gripper_loc_bounds, dtype=torch.float32), persistent=False,
        )
        self.prediction_head = DiffusionHead(
            backbone=backbone,
            image_size=image_size,
            embedding_dim=embedding_dim,
            output_dim=self.internal_dim,
            num_vis_ins_attn_layers=num_vis_ins_attn_layers,
            num_query_cross_attn_layers=num_query_cross_attn_layers,
            use_instruction=use_instruction,
            use_goal=use_goal,
            feat_scales_to_use=feat_scales_to_use,
            attn_rounds=attn_rounds,
        )
        self.to(dev)
        self.pos_schedule = make_ddpm_schedule("scaled_linear", diffusion_timesteps, device=dev)
        self.rot_schedule = make_ddpm_schedule("squaredcos_cap_v2", diffusion_timesteps,
                                               device=dev)

    def normalize_pos(self, pos):
        lo, hi = self.gripper_loc_bounds
        return (pos - lo) / (hi - lo) * 2.0 - 1.0

    def unnormalize_pos(self, pos):
        lo, hi = self.gripper_loc_bounds
        return (pos + 1.0) / 2.0 * (hi - lo) + lo

    def convert_rot(self, signal):
        """(..., 3+4[+k]) pose with quaternion -> (..., 3+6[+k]) with 6D, or
        with the normalised quaternion (non-6D)."""
        quat = R.normalise_quat(signal[..., 3:7])
        if self.rotation_parametrization != "6D":
            return torch.cat([signal[..., :3], quat, signal[..., 7:]], dim=-1)
        rot = R.ortho6d_from_rotation_matrix(R.quaternion_to_matrix(quat))
        return torch.cat([signal[..., :3], rot, signal[..., 7:]], dim=-1)

    def unconvert_rot(self, signal):
        """(..., 3+6[+k]) -> (..., 3+4[+k]); the identity when non-6D."""
        if self.rotation_parametrization != "6D":
            return signal
        quat = R.matrix_to_quaternion(R.rotation_matrix_from_ortho6d(signal[..., 3:9]))
        return torch.cat([signal[..., :3], quat, signal[..., 9:]], dim=-1)

    def _normalize_pcd(self, pcd_obs):
        # (B, ncam, 3, H, W): normalise the channel dim
        return self.normalize_pos(pcd_obs.movedim(2, -1)).movedim(-1, 2)

    def _prep_gripper(self, gripper):
        g = torch.cat([self.normalize_pos(gripper[..., :3]), gripper[..., 3:]], dim=-1)
        return self.convert_rot(g)

    def encode(self, rgb_obs, pcd_obs, instruction, curr_gripper, goal_gripper):
        """Observation encoding for sampling; grippers (B, 7) are raw poses,
        normalised and rotation-converted here.  Returns (context, curr, goal)."""
        pcd = self._normalize_pcd(pcd_obs)
        curr = self._prep_gripper(curr_gripper)
        goal = self._prep_gripper(goal_gripper)
        context = self.prediction_head.encode_context(
            rgb_obs, pcd, curr,
            goal if self.use_goal else None,
            instruction if self.use_instruction else None,
        )
        return context, curr, goal

    def forward(
        self,
        gt_trajectory: torch.Tensor,  # (B, L, 7) quaternion layout
        trajectory_mask: torch.Tensor,  # (B, L) bool, True = padding
        rgb_obs: torch.Tensor,  # (B, ncam, 3, H, W)
        pcd_obs: torch.Tensor,  # (B, ncam, 3, H, W)
        instruction: Optional[torch.Tensor],
        curr_gripper: torch.Tensor,  # (B, 7)
        goal_gripper: torch.Tensor,  # (B, 7)
        *,
        generator: Optional[Generators] = None,
        noise: Optional[torch.Tensor] = None,
        timesteps: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Training loss (scalar), as JAX ``DiffusionPlanner.__call__``.

        Padded rows get the identity quaternion (a zero quaternion is
        singular under the 6D conversion) and are left out of the L1 means.
        ``noise`` (B, L, internal_dim) and ``timesteps`` (B,) are drawn from
        ``generator.device`` unless given (tests inject JAX's draws);
        ``generator`` also drives dropout in training mode.
        """
        ident = torch.zeros_like(gt_trajectory[..., 3:7])
        ident[..., 3] = 1.0
        quat = torch.where(trajectory_mask[..., None], ident, gt_trajectory[..., 3:7])
        gt = torch.cat([self.normalize_pos(gt_trajectory[..., :3]), quat,
                        gt_trajectory[..., 7:]], dim=-1)
        pcd = self._normalize_pcd(pcd_obs)
        curr = self._prep_gripper(curr_gripper)
        goal = self._prep_gripper(goal_gripper)
        gt = self.convert_rot(gt)

        b = gt.shape[0]
        if generator is None and (noise is None or timesteps is None):
            raise ValueError("the training loss needs generator=Generators(...) or both "
                             "noise and timesteps")
        if noise is None:  # at the global batch, this rank's rows (nn/dropout.py)
            noise = draw(generator, torch.randn, gt.shape, gt.device)
        if timesteps is None:
            timesteps = draw(generator, partial(torch.randint, 0, self.diffusion_timesteps),
                             (b,), gt.device)
        pos = self.pos_schedule.add_noise(gt[..., :3], noise[..., :3], timesteps)
        rot = self.rot_schedule.add_noise(gt[..., 3:9], noise[..., 3:9], timesteps)
        noisy = torch.cat([pos, rot], dim=-1)

        context = self.prediction_head.encode_context(
            rgb_obs, pcd, curr,
            goal if self.use_goal else None,
            instruction if self.use_instruction else None,
        )
        preds = self.prediction_head.denoise(noisy, trajectory_mask, timesteps, context,
                                             generators=generator)

        valid = (~trajectory_mask)[..., None].to(gt.dtype)
        n_valid = _batch_count(valid, generator).clamp_min(1.0)
        total = 0.0
        for pred in preds:
            pos_l1 = ((pred[..., :3] - gt[..., :3]).abs() * valid).sum() / (n_valid * 3.0)
            rot_l1 = ((pred[..., 3:9] - gt[..., 3:9]).abs() * valid).sum() / (n_valid * 6.0)
            total = total + 100.0 * pos_l1 + 10.0 * rot_l1
        return total

    def denoise_step(self, trajectory, trajectory_mask, timestep, context):
        """One denoiser evaluation: the last block's clean-sample prediction."""
        return self.prediction_head.denoise(trajectory, trajectory_mask, timestep, context)[-1]


def _batch_count(valid: torch.Tensor, generator: Optional[Generators]) -> torch.Tensor:
    """The number of valid trajectory points the L1 means divide by.  Under
    data parallelism (``generator.world > 1``) it is the global batch's
    count (summed over the ranks in float32, then rounded to the loss dtype
    as a one-device sum is) divided by the world: DDP and FSDP average the
    ranks' gradients, so the ranks' losses average to the global loss
    whatever padding each rank holds."""
    if generator is None or generator.world == 1:
        return valid.sum()
    count = valid.detach().float().sum()
    dist.all_reduce(count)
    return count.to(valid.dtype) / generator.world


@torch.no_grad()
def compute_trajectory(
    model: DiffusionPlanner,
    trajectory_mask: torch.Tensor,  # (B, L) bool, True = padding
    rgb_obs: torch.Tensor,
    pcd_obs: torch.Tensor,
    instruction: Optional[torch.Tensor],
    curr_gripper: torch.Tensor,  # (B, 7)
    goal_gripper: torch.Tensor,  # (B, 7)
    generator=None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Full reverse diffusion; returns (B, L, 7) trajectories.

    Noise comes from ``generator`` (a torch.Generator, or ``Generators``,
    which draw at the global batch: nn/dropout.py), or from ``noise = (init_noise
    (B, L, D), step_noises (T, B, L, D))``, D = ``model.internal_dim``, so a
    test can feed the exact numbers of another implementation.  Non-6D
    quaternions are normalised after the last step, as in JAX.
    """
    b, length = trajectory_mask.shape
    d = model.internal_dim
    n_steps = model.diffusion_timesteps
    dev = trajectory_mask.device
    context, curr, goal = model.encode(rgb_obs, pcd_obs, instruction, curr_gripper,
                                       goal_gripper)

    # start pose at index 0; with use_goal_at_test the goal pose at the last
    # valid index and everything after it held fixed
    positions = torch.arange(length, device=dev)[None, :]
    last_valid = (length - trajectory_mask.sum(dim=1) - 1)[:, None]
    cond_data = torch.zeros(b, length, d, device=dev)
    cond_data = torch.where((positions == 0)[..., None], curr[:, None, :], cond_data)
    cond_mask = positions == 0
    if model.use_goal_at_test:
        cond_data = torch.where((positions == last_valid)[..., None], goal[:, None, :],
                                cond_data)
        cond_mask = cond_mask | (positions >= last_valid)
    cond_mask = cond_mask[..., None].expand(b, length, d)

    def randn():
        return draw(generator, torch.randn, (b, length, d), dev)

    if noise is None:
        trajectory = randn() + cond_data
    else:
        trajectory = noise[0] + cond_data
    for i, t in enumerate(range(n_steps - 1, -1, -1)):
        out = model.denoise_step(trajectory, trajectory_mask,
                                 torch.full((b,), t, device=dev), context)
        out = torch.where(cond_mask, cond_data, out)
        if t == 0:
            trajectory = out  # the final step keeps the raw prediction
            break
        eps = randn() if noise is None else noise[1][i]
        pos = model.pos_schedule.step(out[..., :3], t, trajectory[..., :3], eps[..., :3])
        rot = model.rot_schedule.step(out[..., 3:9], t, trajectory[..., 3:9], eps[..., 3:9])
        trajectory = torch.cat([pos, rot], dim=-1)

    if model.rotation_parametrization != "6D":
        trajectory = torch.cat([trajectory[..., :3], R.normalise_quat(trajectory[..., 3:7]),
                                trajectory[..., 7:]], dim=-1)
    trajectory = model.unconvert_rot(trajectory)
    return torch.cat([model.unnormalize_pos(trajectory[..., :3]), trajectory[..., 3:]],
                     dim=-1)
