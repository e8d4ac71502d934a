"""Host-side data augmentations (pure numpy/scipy), a copy of
``act3d_tpu/data/augment.py``.

Equivalents of the reference's torch-based augmentations (reference:
datasets/utils.py:40-214).  They run on the host CPU while the feeder
builds a batch; the card only ever sees fixed-shape batches.  The draws
are JAX's, in JAX's order, so a seeded dataset gives the same batches in
both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.interpolate import CubicSpline, interp1d

__all__ = ["Resize", "Rotate", "TrajectoryInterpolator", "normalise_quat_np"]


def normalise_quat_np(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(
        np.linalg.norm(x, axis=-1, keepdims=True), 1e-10
    )


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(..., C, H, W) nearest resize via index maps (PIL/torchvision
    NEAREST convention: src = floor(dst * scale))."""
    in_h, in_w = img.shape[-2:]
    rows = np.minimum((np.arange(h) * in_h / h).astype(np.int64), in_h - 1)
    cols = np.minimum((np.arange(w) * in_w / w).astype(np.int64), in_w - 1)
    return img[..., rows[:, None], cols[None, :]]


class Resize:
    """Random-scale resize + reflect-pad + random-crop, NEAREST so the
    point-cloud stays pixel-aligned (reference datasets/utils.py:40-100)."""

    def __init__(self, scales: Tuple[float, float], rng: Optional[np.random.Generator] = None):
        self.scales = scales
        self.rng = rng or np.random.default_rng()

    def sample_index_maps(
        self, raw_h: int, raw_w: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw one augmentation and return it as per-axis SOURCE-index
        vectors (rows (raw_h,), cols (raw_w,)): the whole NEAREST resize
        + reflect-pad + random-crop collapses to an outer index map
        ``img[rows[:, None], cols[None, :]]`` (the depth wire ships these
        maps, ``depthwire.py``).  Draws (scale, i, j), in that order."""
        sc = self.rng.uniform(*self.scales)
        new_h, new_w = int(raw_h * sc), int(raw_w * sc)
        rows = np.minimum(
            (np.arange(new_h) * raw_h / new_h).astype(np.int64), raw_h - 1
        )
        cols = np.minimum(
            (np.arange(new_w) * raw_w / new_w).astype(np.int64), raw_w - 1
        )
        pad_b = max(raw_h - new_h, 0)
        pad_r = max(raw_w - new_w, 0)
        if pad_b or pad_r:
            # reflecting the index vector == indexing the reflected image
            rows = np.pad(rows, (0, pad_b), mode="reflect")
            cols = np.pad(cols, (0, pad_r), mode="reflect")
        i = self.rng.integers(0, len(rows) - raw_h + 1)
        j = self.rng.integers(0, len(cols) - raw_w + 1)
        return rows[i : i + raw_h], cols[j : j + raw_w]

    def __call__(self, **kwargs: np.ndarray) -> Dict[str, np.ndarray]:
        keys = list(kwargs)
        if not keys:
            raise RuntimeError("No args")
        raw_h, raw_w = kwargs[keys[0]].shape[-2:]
        rows, cols = self.sample_index_maps(raw_h, raw_w)
        return {
            n: a[..., rows[:, None], cols[None, :]] for n, a in kwargs.items()
        }


def _quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw -> (N, 3, 3)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.sum(q * q, axis=-1)
    s = 2.0 / np.maximum(n, 1e-12)
    m = np.empty(q.shape[:-1] + (3, 3), dtype=q.dtype)
    m[:, 0, 0] = 1 - s * (y * y + z * z)
    m[:, 0, 1] = s * (x * y - z * w)
    m[:, 0, 2] = s * (x * z + y * w)
    m[:, 1, 0] = s * (x * y + z * w)
    m[:, 1, 1] = 1 - s * (x * x + z * z)
    m[:, 1, 2] = s * (y * z - x * w)
    m[:, 2, 0] = s * (x * z - y * w)
    m[:, 2, 1] = s * (y * z + x * w)
    m[:, 2, 2] = 1 - s * (x * x + y * y)
    return m


def _matrix_to_quat_xyzw(m: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 4) xyzw (stable trace method)."""
    w = 0.5 * np.sqrt(np.maximum(0, 1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]))
    x = 0.5 * np.sqrt(np.maximum(0, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2]))
    y = 0.5 * np.sqrt(np.maximum(0, 1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2]))
    z = 0.5 * np.sqrt(np.maximum(0, 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]))
    x = np.copysign(x, m[:, 2, 1] - m[:, 1, 2])
    y = np.copysign(y, m[:, 0, 2] - m[:, 2, 0])
    z = np.copysign(z, m[:, 1, 0] - m[:, 0, 1])
    return normalise_quat_np(np.stack([x, y, z, w], axis=-1))


class Rotate:
    """Yaw augmentation of point cloud + poses with workspace-bound
    rejection (reference datasets/utils.py:103-181).  The reference ships
    with this disabled (yaw_range == 0 asserted, dataset_engine.py:80)."""

    def __init__(
        self,
        gripper_loc_bounds: np.ndarray,
        yaw_range: float,
        num_tries: int = 10,
        rng: Optional[np.random.Generator] = None,
    ):
        self.bounds = np.asarray(gripper_loc_bounds, np.float64)
        self.yaw_range = np.deg2rad(yaw_range)
        self.num_tries = num_tries
        self.rng = rng or np.random.default_rng()

    def __call__(self, pcds, gripper, action, trajectory=None):
        rot, gripper, action, trajectory = self.sample(
            gripper, action, trajectory
        )
        if rot is not None:
            pcds = np.einsum("ij,tcjhw->tcihw", rot, pcds)
        return pcds, gripper, action, trajectory

    def sample(self, gripper, action, trajectory=None):
        """Draw + apply the pose part; return (rot | None, poses...), with
        JAX's draw and rejection order."""
        if self.yaw_range == 0.0:
            return None, gripper, action, trajectory

        for _ in range(self.num_tries):
            yaw = self.rng.uniform(-self.yaw_range, self.yaw_range)
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array(
                [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64
            )

            def rot_pose(p):
                pos = p[:, :3] @ rot.T
                q_rot = _matrix_to_quat_xyzw(
                    rot[None] @ _quat_xyzw_to_matrix(p[:, 3:7])
                )
                return pos, q_rot

            g_pos, g_quat = rot_pose(gripper)
            a_pos, a_quat = rot_pose(action)
            in_bounds = (
                (g_pos >= self.bounds[0]).all()
                and (g_pos <= self.bounds[1]).all()
                and (a_pos >= self.bounds[0]).all()
                and (a_pos <= self.bounds[1]).all()
            )
            if in_bounds:
                gripper = gripper.copy()
                action = action.copy()
                gripper[:, :3], gripper[:, 3:7] = g_pos, g_quat
                action[:, :3], action[:, 3:7] = a_pos, a_quat
                if trajectory is not None:
                    t = trajectory.reshape(-1, trajectory.shape[-1]).copy()
                    t_pos, t_quat = rot_pose(t)
                    t[:, :3], t[:, 3:7] = t_pos, t_quat
                    trajectory = t.reshape(trajectory.shape)
                return rot, gripper, action, trajectory
        return None, gripper, action, trajectory


class TrajectoryInterpolator:
    """Resample a trajectory to fixed length with cubic splines (linear for
    the gripper channel), renormalising quaternions
    (reference datasets/utils.py:184-214)."""

    def __init__(self, use: bool = False, interpolation_length: int = 50):
        self._use = use
        self._len = interpolation_length

    def __call__(self, trajectory: np.ndarray) -> np.ndarray:
        if not self._use:
            return trajectory
        trajectory = np.asarray(trajectory, np.float64)
        old_steps = np.linspace(0, 1, len(trajectory))
        new_steps = np.linspace(0, 1, self._len)
        out = np.empty((self._len, trajectory.shape[1]))
        for i in range(trajectory.shape[1]):
            if i == 7 or len(trajectory) < 3:  # gripper channel: linear
                f = interp1d(old_steps, trajectory[:, i])
            else:
                f = CubicSpline(old_steps, trajectory[:, i])
            out[:, i] = f(new_steps)
        out[:, 3:7] = normalise_quat_np(out[:, 3:7])
        return out.astype(np.float32)
