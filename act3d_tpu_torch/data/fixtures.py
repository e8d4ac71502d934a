"""Synthetic episode fixtures in the packaged schema, a copy of
``act3d_tpu/data/fixtures.py``.

The writers put valid blosc ``.dat`` containers through the port's
native packer, so the whole loader path (C++ decode -> pickle -> numpy) is
exercised; the same seed gives the same episodes as JAX's writers.  Each
camera has a pinhole model (the optional slot-7 ``camera_params``) and the
XYZ image is the reprojection of a smooth synthetic depth map through it,
so the clouds are geometrically consistent, as RLBench's are.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from .episode import save_episode

CAMERAS = ("wrist", "left_shoulder", "right_shoulder")

_TARGET = np.array([0.2, 0.2, 0.9], np.float64)  # workspace center


def _look_at_c2w(eye, target=_TARGET, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world 4x4, OpenCV axes (+z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def _fixture_camera(cam_idx: int, image_size: int, jitter=0.0, rng=None):
    """(K, c2w) for one ring camera around the workspace."""
    s = image_size
    k = np.array(
        [[1.2 * s, 0.0, (s - 1) / 2.0],
         [0.0, 1.2 * s, (s - 1) / 2.0],
         [0.0, 0.0, 1.0]]
    )
    ang = 2.1 * cam_idx + 0.4
    eye = _TARGET + np.array(
        [1.3 * np.cos(ang), 1.3 * np.sin(ang), 0.65]
    )
    if jitter and rng is not None:
        eye = eye + rng.uniform(-jitter, jitter, 3)
    return k, _look_at_c2w(eye)


def _render_frame(k, c2w, image_size, rng):
    """(depth, pcd): smooth random depth + its pinhole reprojection."""
    s = image_size
    u = np.arange(s)[None, :]
    v = np.arange(s)[:, None]
    ph = rng.uniform(0, 2 * np.pi, 4)
    depth = (
        1.45
        + 0.25 * np.sin(2 * np.pi * u / s + ph[0]) * np.cos(
            2 * np.pi * v / s + ph[1])
        + 0.15 * np.cos(4 * np.pi * (u + v) / s + ph[2])
    )
    x = (u - k[0, 2]) / k[0, 0] * depth
    y = (v - k[1, 2]) / k[1, 1] * depth
    cam = np.stack([x, y, depth])  # (3, H, W)
    pcd = np.einsum("ik,khw->ihw", c2w[:3, :3], cam) + c2w[:3, 3][
        :, None, None
    ]
    return depth.astype(np.float32), pcd.astype(np.float32)


def make_episode(
    n_frames: int = 3,
    n_cam: int = 3,
    image_size: int = 32,
    traj_len_range=(8, 24),
    seed: int = 0,
):
    rng = np.random.default_rng(seed)
    frame_ids = list(range(n_frames))
    obs, camera_params = [], []
    for _ in frame_ids:
        frames, params = [], {}
        for ci, cam in enumerate(CAMERAS[:n_cam]):
            # the first (wrist) camera moves frame to frame
            k, c2w = _fixture_camera(
                ci, image_size, jitter=0.08 if ci == 0 else 0.0, rng=rng
            )
            _, pcd = _render_frame(k, c2w, image_size, rng)
            rgb = np.clip(
                rng.normal(0, 0.5, (3, image_size, image_size)), -1, 1
            ).astype(np.float32)
            frames.append(np.stack([rgb, pcd]))  # (2, 3, H, W)
            params[cam] = {
                "intrinsics": k.astype(np.float32),
                "extrinsics": c2w.astype(np.float32),
            }
        obs.append(np.stack(frames).astype(np.float32))
        camera_params.append(params)

    def pose8():
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        return np.concatenate(
            [rng.uniform(-0.3, 0.7, 3), q, [float(rng.integers(0, 2))]]
        ).astype(np.float32)[None]

    actions = [pose8() for _ in frame_ids]
    camera_dicts = [{c: {} for c in CAMERAS[:n_cam]} for _ in frame_ids]
    grippers = [pose8() for _ in frame_ids]
    trajectories = []
    for i in frame_ids:
        n = int(rng.integers(*traj_len_range))
        start, end = grippers[i][0], actions[i][0]
        ts = np.linspace(0, 1, n)[:, None]
        traj = start[None] * (1 - ts) + end[None] * ts
        traj[:, 3:7] /= np.linalg.norm(traj[:, 3:7], axis=-1, keepdims=True)
        trajectories.append(traj.astype(np.float32))
    # slot 7 (the reference reader indexes 0-5 and is unaffected):
    # per-frame per-camera pinhole params
    return [
        frame_ids, obs, actions, camera_dicts, grippers, trajectories,
        camera_params,
    ]


def make_dataset_tree(
    root: Path,
    tasks: Sequence[str] = ("pick_and_lift",),
    variations: Sequence[int] = (0,),
    episodes_per_variation: int = 2,
    **episode_kwargs,
) -> Path:
    """Write a {task}+{var}/ep{N}.dat tree (reference data_gen.py:135-136)."""
    root = Path(root)
    seed = episode_kwargs.pop("seed", 0)
    for task in tasks:
        for var in variations:
            for n in range(episodes_per_variation):
                ep = make_episode(seed=seed, **episode_kwargs)
                seed += 1
                save_episode(root / f"{task}+{var}" / f"ep{n}.dat", ep)
    return root


def make_instructions(
    tasks: Sequence[str] = ("pick_and_lift",),
    variations: Sequence[int] = (0,),
    n_instr: int = 2,
    seed: int = 0,
):
    """task -> variation -> (n_instr, 53, 512) float32, mirroring
    instructions.pkl (reference preprocess_instructions.py:101-170)."""
    rng = np.random.default_rng(seed)
    return {
        task: {
            var: rng.normal(size=(n_instr, 53, 512)).astype(np.float32)
            for var in variations
        }
        for task in tasks
    }
