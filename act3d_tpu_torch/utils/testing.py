"""Synthetic batches, a numpy copy of ``act3d_tpu/utils/testing.py``:
the same draws from the same seed, returned as torch tensors."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BOUNDS = ((-0.5, -0.5, 0.5), (0.5, 0.5, 1.5))


def synthetic_trajectory_batch(
    batch: int = 2,
    ncam: int = 3,
    image_size: Tuple[int, int] = (256, 256),
    traj_len: int = 50,
    seed: int = 0,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """A fixed-shape trajectory-training batch in the dataset schema."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    rgb = rng.uniform(0, 1, (batch, ncam, 3, h, w)).astype(np.float32)
    pcd = rng.uniform(-0.4, 1.4, (batch, ncam, 3, h, w)).astype(np.float32)
    quat = rng.normal(size=(batch, traj_len, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    traj = np.concatenate(
        [rng.uniform(-0.4, 1.4, (batch, traj_len, 3)).astype(np.float32), quat],
        axis=-1,
    )
    mask = np.zeros((batch, traj_len), bool)
    instr = rng.normal(size=(batch, 53, 512)).astype(np.float32)

    def pose():
        q = rng.normal(size=(batch, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        p = rng.uniform(-0.4, 1.4, (batch, 3)).astype(np.float32)
        return np.concatenate([p, q], axis=-1)

    arrays = {
        "trajectory": traj,
        "trajectory_mask": mask,
        "rgbs": rgb,
        "pcds": pcd,
        "instr": instr,
        "curr_gripper": pose(),
        "action": pose(),  # goal gripper (keypose)
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
