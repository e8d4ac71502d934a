"""RLBench packaged-episode dataset (host-side, fixed-shape batches).

A copy of ``act3d_tpu/data/dataset.py::RLBenchDataset`` for the port, the
counterpart of the reference ``RLBenchDataset``
(reference: datasets/dataset_engine.py:14-258): loading, caching, camera
re-indexing, instruction sampling, gripper history, trajectory
interpolation and padding, and the Resize / Rotate augmentations.  The
unit of sampling is one (episode, frame) pair and a batch is exactly
``batch_size`` frames; trajectories are padded to a fixed
``interpolation_length``.

Every draw comes from one ``np.random.default_rng(seed)`` in JAX's order
(episode, frame, instruction, rotation, then the resize's scale and crop),
so the two packages give bit-identical batches from the same tree and
seed.  The port ships the XYZ point cloud and the instruction features
(JAX's ``wire="pcd"``, ``instr_mode="features"``); JAX's depth wire,
instruction ids and reference-style chunks (``get_chunk``) are not ported
yet.
"""

from __future__ import annotations

import itertools
import logging
import threading
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .augment import Resize, Rotate, TrajectoryInterpolator
from .episode import load_episode

log = logging.getLogger(__name__)

__all__ = ["RLBenchDataset"]


class _Cache:
    """Bounded FIFO episode cache (dataset_engine.py:116-132 keys on time)."""

    def __init__(self, size: int):
        self.size = size
        self._store: Dict = {}
        self._order: List = []

    def get(self, key, loader_fn):
        if self.size == 0:
            return loader_fn(key)
        if key in self._store:
            return self._store[key]
        value = loader_fn(key)
        if len(self._store) >= self.size:
            del self._store[self._order.pop(0)]
        self._store[key] = value
        self._order.append(key)
        return value


class RLBenchDataset:
    def __init__(
        self,
        root,
        instructions: Optional[Dict] = None,
        taskvar: Sequence[Tuple[str, int]] = (("close_door", 0),),
        cache_size: int = 0,
        max_episodes_per_task: int = 100,
        cameras: Sequence[str] = ("wrist", "left_shoulder", "right_shoulder"),
        training: bool = True,
        gripper_loc_bounds=None,
        image_rescale: Tuple[float, float] = (1.0, 1.0),
        point_cloud_rotate_yaw_range: float = 0.0,
        return_low_lvl_trajectory: bool = False,
        dense_interpolation: bool = False,
        interpolation_length: int = 100,
        action_dim: int = 8,
        seed: int = 0,
    ):
        """``training`` turns on the host Resize / Rotate augmentations."""
        self._cameras = list(cameras)
        self._training = training
        self._return_low_lvl_trajectory = return_low_lvl_trajectory
        self._action_dim = action_dim
        self._interpolation_length = interpolation_length
        self._rng = np.random.default_rng(seed)
        if isinstance(root, (Path, str)):
            root = [Path(root)]
        self._root = [Path(r).expanduser() for r in root]

        if return_low_lvl_trajectory:
            self._interpolate_traj = TrajectoryInterpolator(
                use=dense_interpolation, interpolation_length=interpolation_length)

        # keep only instructions for present task variations
        self._instructions = defaultdict(dict)
        self._num_vars = Counter()
        for r, (task, var) in itertools.product(self._root, taskvar):
            if (r / f"{task}+{var}").is_dir():
                if instructions is not None:
                    self._instructions[task][var] = instructions[task][var]
                self._num_vars[task] += 1

        if training:
            self._resize = Resize(scales=image_rescale, rng=self._rng)
            self._rotate = Rotate(
                gripper_loc_bounds=np.asarray(
                    gripper_loc_bounds if gripper_loc_bounds is not None
                    else [[-2, -2, -2], [2, 2, 2]], np.float64),
                yaw_range=point_cloud_rotate_yaw_range,
                rng=self._rng,
            )

        # episode file list, split equally over variations, then capped per task
        per_var_cap = None
        if max_episodes_per_task > -1:
            per_var_cap = {task: max_episodes_per_task // n + 1
                           for task, n in self._num_vars.items()}
        episodes_by_task = defaultdict(list)
        for r, (task, var) in itertools.product(self._root, taskvar):
            episodes_by_task[task] += self._scan_variation_dir(
                r / f"{task}+{var}", task, var,
                None if per_var_cap is None else per_var_cap[task])

        self._episodes = []
        for task, eps in episodes_by_task.items():
            if -1 < max_episodes_per_task < len(eps):
                idx = self._rng.choice(len(eps), size=max_episodes_per_task, replace=False)
                eps = [eps[i] for i in idx]
            self._episodes += eps
        self._num_episodes = len(self._episodes)
        self._cache = _Cache(cache_size)
        self._lock = threading.Lock()
        log.info("RLBenchDataset ready: %d episode files under %s (%d taskvars)",
                 self._num_episodes, [str(r) for r in self._root], len(taskvar))

    @staticmethod
    def _scan_variation_dir(data_dir, task, var, cap):
        """List episode files for one task+variation directory (capped)."""
        if not data_dir.is_dir():
            log.warning("missing taskvar directory: %s", data_dir)
            return []
        found = [(task, var, ep) for pattern in ("*.npy", "*.dat", "*.pkl")
                 for ep in sorted(data_dir.glob(pattern))]
        if cap is not None:
            found = found[:cap]
        if not found:
            log.warning("no episode files in %s", data_dir)
        return found

    def _frames_to_sample(self, task, variation, episode, frame_ids):
        """Assemble a sample dict for the given frame ids (numpy)."""
        states = np.stack([episode[1][i] for i in frame_ids]).astype(np.float32, copy=False)
        if episode[3]:
            cameras = list(episode[3][0].keys())
            if not all(c in cameras for c in self._cameras):
                raise ValueError(f"episode cameras {cameras} lack some of {self._cameras}")
            index = [cameras.index(c) for c in self._cameras]
            if index != list(range(len(cameras))):
                states = states[:, index]

        rgbs = states[:, :, 0]
        rgbs *= 0.5  # stored [-1, 1] -> [0, 1] in place
        rgbs += 0.5  # (dataset_engine.py:135-137)
        pcds = states[:, :, 1]
        action = np.concatenate([episode[2][i] for i in frame_ids]).astype(np.float32)

        if self._instructions:
            options = self._instructions[task][variation]
            pick = int(self._rng.integers(len(options)))
            instr = np.repeat(np.asarray(options[pick], np.float32)[None], len(rgbs), axis=0)
        else:
            instr = np.zeros((len(rgbs), 53, 512), np.float32)

        gripper = np.concatenate([episode[4][i] for i in frame_ids]).astype(np.float32)
        gripper_history = np.stack(
            [np.concatenate([episode[4][max(0, i - 2)] for i in frame_ids]),
             np.concatenate([episode[4][max(0, i - 1)] for i in frame_ids]),
             gripper],
            axis=1,
        ).astype(np.float32)

        traj = traj_mask = None
        if self._return_low_lvl_trajectory:
            items = [self._interpolate_traj(np.asarray(episode[5][i], np.float64))
                     for i in frame_ids]
            max_l = max(self._interpolation_length, max(len(t) for t in items))
            traj = np.zeros((len(items), max_l, 8), np.float32)
            traj_mask = np.ones((len(items), max_l), bool)
            for i, item in enumerate(items):
                traj[i, : len(item)] = item
                traj_mask[i, : len(item)] = False

        if self._training:  # rotation before resize, as in JAX
            pcds, gripper, action, traj = self._rotate(pcds, gripper, action, traj)
            modals = self._resize(rgbs=rgbs, pcds=pcds)
            rgbs, pcds = modals["rgbs"], modals["pcds"]

        sample = {
            "task": [task for _ in frame_ids],
            "rgbs": rgbs.astype(np.float32, copy=False),
            "pcds": pcds.astype(np.float32, copy=False),
            "action": action[..., : self._action_dim],
            "curr_gripper": gripper[..., : self._action_dim],
            "curr_gripper_history": gripper_history[..., : self._action_dim],
            "instr": instr,
        }
        if traj is not None:
            sample["trajectory"] = traj[..., : self._action_dim]
            sample["trajectory_mask"] = traj_mask
        return sample

    def get_frame(self, episode_id: int):
        """One random frame of an episode, the fixed-shape training unit."""
        task, variation, file = self._episodes[episode_id % self._num_episodes]
        episode = self._cache.get(file, load_episode)
        if episode is None:
            return None
        frame_ids = [episode[0][int(self._rng.integers(len(episode[0])))]]
        return self._frames_to_sample(task, variation, episode, frame_ids)

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Fixed-shape batch of ``batch_size`` random frames; ``task`` is a
        list of names, every other key a numpy array.  Thread-safe: the
        CLIs draw evaluation batches from the training set while the feeder
        thread draws training batches (the order of the two threads' draws
        is not fixed)."""
        samples = []
        with self._lock:
            while len(samples) < batch_size:
                s = self.get_frame(int(self._rng.integers(self._num_episodes)))
                if s is not None:
                    samples.append(s)
        out: Dict[str, np.ndarray] = {}
        for key in samples[0]:
            if key == "task":
                out["task"] = [t for s in samples for t in s["task"]]
            else:
                out[key] = np.concatenate([s[key] for s in samples], axis=0)
        return out
