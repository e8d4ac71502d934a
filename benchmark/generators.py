"""The traffic generators: observations, instructions, ghost points, noise
and training batches, all drawn from the run's seed.

Frozen copies of the system's generators, made on the device in a few
large draws: ``observation_pool`` follows ``chip_smoke.py::
synthetic_observation`` (rgb uniform in [-1, 1] as the simulator hands
it, the point cloud uniform in the workspace, the gripper a uniform
position, a normalised Gaussian quaternion and an open gripper);
``trajectory_batch`` and ``keypose_batch`` follow
``act3d_tpu_torch/utils/testing.py::synthetic_{trajectory,keypose}_batch``
(the same keys and distributions, positions drawn in the configuration's
workspace instead of the fixed test cube).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

N_INSTR, INSTR_DIM = 53, 512


def _uniform(shape, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _unit_quat(shape, gen, device):
    q = torch.randn(shape + (4,), generator=gen, device=device)
    return q / q.norm(dim=-1, keepdim=True)


def observation_pool(n: int, ncam: int, image: int, bounds, gen, device) -> List[Tuple]:
    """``n`` observations as numpy on the host: rgb (1, ncam, 3, H, W) in
    [-1, 1], pcd (1, ncam, 3, H, W) uniform in ``bounds``, gripper (1, 8)."""
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=device) for b in bounds)
    rgb = _uniform((n, 1, ncam, 3, image, image), -1.0, 1.0, gen, device)
    pcd = _uniform((n, 1, ncam, image, image, 3), lo, hi, gen, device).permute(0, 1, 2, 5, 3, 4)
    grip = torch.cat([_uniform((n, 1, 3), lo, hi, gen, device), _unit_quat((n, 1), gen, device),
                      torch.ones(n, 1, 1, device=device)], dim=-1)
    rgb, pcd, grip = (x.contiguous().cpu().numpy() for x in (rgb, pcd, grip))
    return [(rgb[i], pcd[i], grip[i]) for i in range(n)]


def instruction_bank(n: int, gen, device) -> np.ndarray:
    """(n, 53, 512) instruction features, one task each."""
    return torch.randn((n, N_INSTR, INSTR_DIM), generator=gen, device=device).cpu().numpy()


def ghost_sets(n: int, counts, diameters, bounds, gen, device) -> List[List[torch.Tensor]]:
    """``n`` sets of per-level (1, N_i, 3) ghost points: level 0 uniform in
    the workspace, level i >= 1 uniform in a ball of ``diameters[i]``
    around an anchor uniform in the workspace."""
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=device) for b in bounds)
    anchor = _uniform((n, 1, 1, 3), lo, hi, gen, device)
    levels = [_uniform((n, 1, counts[0], 3), lo, hi, gen, device)]
    for count, diameter in zip(counts[1:], diameters[1:]):
        direction = torch.randn((n, 1, count, 3), generator=gen, device=device)
        direction = direction / direction.norm(dim=-1, keepdim=True)
        radius = diameter / 2 * torch.rand((n, 1, count, 1), generator=gen, device=device) ** (1 / 3)
        levels.append(anchor + direction * radius)
    return [[level[i] for level in levels] for i in range(n)]


def noise_sets(n: int, steps: int, length: int, dim: int, gen, device):
    """``n`` (init (1, L, D), per-step (T, 1, L, D)) standard normal pairs."""
    init = torch.randn((n, 1, length, dim), generator=gen, device=device)
    per_step = torch.randn((n, steps, 1, length, dim), generator=gen, device=device)
    return [(init[i], per_step[i]) for i in range(n)]


def trajectory_batch(batch: int, ncam: int, image: int, length: int, bounds, gen,
                     device) -> Dict[str, torch.Tensor]:
    """A trajectory-training batch: trajectory (B, L, 7) of positions and
    unit quaternions, an all-valid mask, rgb in [0, 1], the point cloud,
    instructions, and the current and goal poses (B, 7)."""
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=device) for b in bounds)

    def pose(*lead):
        return torch.cat([_uniform(lead + (3,), lo, hi, gen, device),
                          _unit_quat(lead, gen, device)], dim=-1)

    return {
        "trajectory": pose(batch, length),
        "trajectory_mask": torch.zeros(batch, length, dtype=torch.bool, device=device),
        "rgbs": torch.rand((batch, ncam, 3, image, image), generator=gen, device=device),
        "pcds": _uniform((batch, ncam, image, image, 3), lo, hi, gen, device)
        .permute(0, 1, 4, 2, 3).contiguous(),
        "instr": torch.randn((batch, N_INSTR, INSTR_DIM), generator=gen, device=device),
        "curr_gripper": pose(batch),
        "action": pose(batch),
    }


def keypose_batch(batch: int, ncam: int, image: int, bounds, gen, device) -> Dict[str, torch.Tensor]:
    """A keypose-training batch: rgb in [0, 1], the point cloud,
    instructions, and (B, 8) current and target actions (position, unit
    quaternion, gripper open or closed)."""
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=device) for b in bounds)

    def pose8():
        g = torch.randint(0, 2, (batch, 1), generator=gen, device=device).float()
        return torch.cat([_uniform((batch, 3), lo, hi, gen, device),
                          _unit_quat((batch,), gen, device), g], dim=-1)

    return {
        "rgbs": torch.rand((batch, ncam, 3, image, image), generator=gen, device=device),
        "pcds": _uniform((batch, ncam, image, image, 3), lo, hi, gen, device)
        .permute(0, 1, 4, 2, 3).contiguous(),
        "instr": torch.randn((batch, N_INSTR, INSTR_DIM), generator=gen, device=device),
        "curr_gripper": pose8(),
        "action": pose8(),
    }
