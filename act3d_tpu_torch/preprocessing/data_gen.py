"""Package raw RLBench demos into blosc ``.dat`` training episodes.

Counterpart of ``act3d_tpu/preprocessing/data_gen.py`` (reference
data_preprocessing/data_gen.py:44-155): replay a stored demo, find its
keyframes, and write the 7-slot episode

  [frame_ids, obs (n_cam, 2, 3, H, W), keyframe actions (1, 8),
   obs_to_attn indices per camera, gripper poses (1, 8),
   inter-keyframe action trajectories (N_i, 8), per-camera pinhole params]

to ``{task}+{variation}/ep{N}.dat`` through ``data/episode.py::save_episode``.
Demo replay needs the RLBench simulator stack (``main`` raises ImportError
without it); ``pack_demo`` takes any env with ``get_obs_action`` and any
demo with ``_observations``.

Run (on the host):
  python -m act3d_tpu_torch.preprocessing.data_gen \\
      --data_dir /path/raw --output /path/packaged \\
      --tasks pick_and_lift --max_variations 1
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path
from typing import List

import numpy as np

from ..data.episode import save_episode
from ..eval.keypoint import keypoint_discovery
from ..eval.rlbench_env import HAS_RLBENCH, RLBenchEnv, obs_to_attn


def pack_demo(env: "RLBenchEnv", demo, cameras) -> List:
    """One demo -> the 7-slot episode list (numpy)."""
    key_frames = keypoint_discovery(demo)
    key_frames.insert(0, 0)

    states, actions, attns, cam_params, trajectories = [], [], [], [], []
    for i, kf in enumerate(key_frames):
        obs = demo._observations[kf]
        state_dict, action = env.get_obs_action(obs)
        rgb = np.stack(state_dict["rgb"]).astype(np.float32)
        rgb = rgb.transpose(0, 3, 1, 2) / 255.0 * 2.0 - 1.0  # [-1, 1]
        pc = np.stack(state_dict["pc"]).astype(np.float32).transpose(0, 3, 1, 2)
        states.append(np.stack([rgb, pc], axis=1))  # (n_cam, 2, 3, H, W)
        actions.append(action[None])
        attns.append({cam: obs_to_attn(obs, cam) for cam in cameras})
        # slot 7, the pinhole params: RLBench's misc carries each camera's K
        # and the camera->world extrinsic the cloud was reprojected with
        # (the depth wire, data/depthwire.py)
        cam_params.append({
            cam: {
                "intrinsics": np.asarray(obs.misc[f"{cam}_camera_intrinsics"], np.float32),
                "extrinsics": np.asarray(obs.misc[f"{cam}_camera_extrinsics"], np.float32),
            }
            for cam in cameras
        })
        if i < len(key_frames) - 1:
            inter = []
            for j in range(kf, key_frames[i + 1] + 1):
                _, a = env.get_obs_action(demo._observations[j])
                inter.append(a)
            trajectories.append(np.stack(inter))

    frame_ids = list(range(len(key_frames) - 1))
    return [
        frame_ids,
        np.stack(states[:-1]),  # obs at keyframe starts
        actions[1:],  # next-keypose targets
        attns[:-1],
        actions[:-1],  # current gripper poses
        trajectories,  # gripper -> keypose trajectories
        cam_params[:-1],  # slot 7, pinhole params (depth wire)
    ]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True, type=Path)
    p.add_argument("--output", required=True, type=Path)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--max_variations", type=int, default=1)
    p.add_argument("--image_size", default="256,256")
    p.add_argument("--cameras", nargs="*", default=["left_shoulder", "right_shoulder", "wrist"])
    args = p.parse_args(argv)

    if not HAS_RLBENCH:
        raise ImportError("data_gen requires the RLBench simulator stack")

    env = RLBenchEnv(
        data_path=args.data_dir,
        image_size=tuple(int(x) for x in args.image_size.split(",")),
        apply_rgb=True,
        apply_pc=True,
        apply_cameras=tuple(args.cameras),
    )

    items = []
    for task_str, variation in itertools.product(
        args.tasks, range(args.offset, args.max_variations)
    ):
        episodes_dir = args.data_dir / task_str / f"variation{variation}" / "episodes"
        items += [(task_str, variation, int(ep.stem[7:]))
                  for ep in episodes_dir.glob("episode*")]

    for task, variation, episode in items:
        demo = env.get_demo(task, variation, episode)[0]
        state_dict = pack_demo(env, demo, args.cameras)
        out = args.output / f"{task}+{variation}" / f"ep{episode}.dat"
        save_episode(out, state_dict)
        print(f"Packed {task}+{variation}/ep{episode}: {len(state_dict[0])} keyframes")


if __name__ == "__main__":
    main()
