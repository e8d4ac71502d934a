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
seed, under every wire (``"pcd"``: the XYZ image; ``"depth"``: depth +
camera model, ``depthwire.py``) and instruction mode (``"features"``, or
``"ids"`` into ``instruction_bank``), with the host augmentations on or
off (``augment_host=False`` leaves them to ``device_augment.py``), and for
reference-style chunks (``get_chunk``).
"""

from __future__ import annotations

import itertools
import logging
import math
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
        max_episode_length: int = 5,
        cache_size: int = 0,
        max_episodes_per_task: int = 100,
        num_iters: Optional[int] = None,
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
        augment_host: bool = True,
        wire: str = "pcd",
        instr_mode: str = "features",
        depth_tol: float = 1e-3,
        rank: int = 0,
        world: int = 1,
    ):
        """``training`` with ``augment_host`` turns on the host Resize /
        Rotate; ``augment_host=False`` leaves them to the training step
        (``device_augment.make_device_augment``), and the host only decodes
        and stacks.

        ``wire="depth"`` ships 1-channel depth + per-camera pinhole params
        instead of the 3-channel XYZ image, the Resize as index maps and the
        yaw rotation folded into ``cam_c2w`` (``depthwire.py``).  It needs
        episodes whose slot-7 camera_params reproduce the stored cloud
        within ``depth_tol`` metres: the first episode is checked at init
        (failing it falls back to the XYZ wire, with a warning) and every
        episode at load (failing it raises).

        ``instr_mode="ids"`` ships a (B,) int32 row of
        ``self.instruction_bank`` instead of (B, 53, 512) features; the loss
        functions take the bank as ``instr_bank``.

        ``rank`` of ``world`` (data parallelism): :meth:`sample_batch`
        draws a global batch and returns this rank's rows of it, bit for
        bit the rows a ``world=1`` dataset of the same seed returns.  The
        other ranks' rows are replayed (their draws made, in order, without
        assembling their images)."""
        self._rank, self._world = rank, world
        self._cameras = list(cameras)
        self._max_episode_length = max_episode_length
        self._num_iters = num_iters
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

        self._augment_host = augment_host
        if training and augment_host:
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
        self._depth_cache = _Cache(cache_size)
        self._lock = threading.Lock()

        if wire not in ("pcd", "depth"):
            raise ValueError(f"unknown wire {wire!r}")
        self._wire = wire
        self._depth_tol = depth_tol
        if wire == "depth" and self._num_episodes:
            probe = load_episode(self._episodes[0][2])
            if probe is None or self._depth_aux_from_episode(probe) is None:
                log.warning("depth wire requested but the first episode has no "
                            "pinhole-consistent camera_params slot; falling back "
                            "to the XYZ wire")
                self._wire = "pcd"

        if instr_mode not in ("features", "ids"):
            raise ValueError(f"unknown instr_mode {instr_mode!r}")
        self._instr_mode = instr_mode
        self._instr_bank = None
        self._instr_rows = {}
        if instr_mode == "ids":
            rows, offset = [], 0
            for task in sorted(self._instructions):
                for var in sorted(self._instructions[task]):
                    opts = np.asarray(self._instructions[task][var], np.float32)
                    self._instr_rows[(task, var)] = (offset, len(opts))
                    rows.append(opts)
                    offset += len(opts)
            self._instr_bank = (np.concatenate(rows, axis=0) if rows
                                else np.zeros((1, 53, 512), np.float32))

        log.info("RLBenchDataset ready: %d episode files under %s (%d taskvars)",
                 self._num_episodes, [str(r) for r in self._root], len(taskvar))

    @property
    def wire(self) -> str:
        """The wire in effect ("depth" may have fallen back to "pcd")."""
        return self._wire

    @property
    def instruction_bank(self):
        """(n_rows, 53, 512) f32 bank of ``instr_mode="ids"`` (else None):
        every (task, variation)'s options, tasks and variations sorted."""
        return self._instr_bank

    def _depth_aux_from_episode(self, episode):
        """Per-frame depth + camera arrays; None if the episode has no
        camera_params slot or fails the pinhole round trip.  Cameras follow
        the order of the slot's dict keys."""
        if len(episode) < 7 or not episode[6]:
            return None
        from .depthwire import derive_depth, pinhole_residual

        cam_names = list(episode[6][0].keys())
        intr, c2w, depth = [], [], []
        for pos, params in enumerate(episode[6]):
            k = np.stack([np.asarray(params[c]["intrinsics"], np.float32) for c in cam_names])
            e = np.stack([np.asarray(params[c]["extrinsics"], np.float32) for c in cam_names])
            pcd = np.asarray(episode[1][pos], np.float32)[:, 1]
            d = derive_depth(pcd, e)
            if pinhole_residual(pcd, d, k, e) > self._depth_tol:
                return None
            intr.append(k)
            c2w.append(e)
            depth.append(d)
        return {"depth": np.stack(depth),  # (T, ncam, H, W) f32
                "intr": np.stack(intr),  # (T, ncam, 3, 3) f32
                "c2w": np.stack(c2w)}  # (T, ncam, 4, 4) f32

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

    def __len__(self):
        return self._num_iters if self._num_iters is not None else self._num_episodes

    def _load(self, episode_id: int):
        task, variation, file = self._episodes[episode_id % self._num_episodes]
        episode = self._cache.get(file, load_episode)
        aux = None
        if self._wire == "depth" and episode is not None:
            aux = self._depth_cache.get(file, lambda _f: self._depth_aux_from_episode(episode))
            if aux is None:
                raise RuntimeError(
                    f"depth wire: episode {file} is not pinhole-consistent (residual "
                    "above depth_tol); use wire='pcd' for this data")
        return task, variation, episode, aux

    def _frames_to_sample(self, task, variation, episode, frame_ids, aux=None):
        """Assemble a sample dict for the given frame ids (numpy); ``aux``
        holds the depth wire's arrays of the episode."""
        depth_mode = aux is not None
        states = np.stack([episode[1][i] for i in frame_ids]).astype(np.float32, copy=False)
        index = None
        if episode[3]:
            cameras = list(episode[3][0].keys())
            if not all(c in cameras for c in self._cameras):
                raise ValueError(f"episode cameras {cameras} lack some of {self._cameras}")
            index = [cameras.index(c) for c in self._cameras]
            if index == list(range(len(cameras))):
                index = None
            else:
                states = states[:, index]

        rgbs = states[:, :, 0]
        rgbs *= 0.5  # stored [-1, 1] -> [0, 1] in place
        rgbs += 0.5  # (dataset_engine.py:135-137)
        if depth_mode:
            pcds = None
            depth = aux["depth"][frame_ids]
            cam_intr = aux["intr"][frame_ids]
            cam_c2w = aux["c2w"][frame_ids]
            if index is not None:
                depth, cam_intr, cam_c2w = depth[:, index], cam_intr[:, index], cam_c2w[:, index]
        else:
            pcds = states[:, :, 1]
        pick, rot, aug, action, gripper, gripper_history, traj, traj_mask = self._frame_draws(
            task, variation, episode, frame_ids, rgbs.shape[-2:])

        instr = instr_id = None
        if self._instructions:
            options = self._instructions[task][variation]
            if self._instr_mode == "ids":
                instr_id = np.full(len(rgbs), self._instr_rows[(task, variation)][0] + pick,
                                   np.int32)
            else:
                instr = np.repeat(np.asarray(options[pick], np.float32)[None], len(rgbs),
                                  axis=0)
        elif self._instr_mode == "ids":
            instr_id = np.zeros(len(rgbs), np.int32)
        else:
            instr = np.zeros((len(rgbs), 53, 512), np.float32)

        aug_rows = aug_cols = None
        if aug is not None:  # rotation before resize, as in JAX
            rows, cols = aug
            if depth_mode:
                # the XYZ path's draws in its order: the rotation folds
                # into the camera-to-world extrinsic, the resize ships as
                # index maps gathered on the card (exact for NEAREST)
                if rot is not None:
                    cam_c2w = cam_c2w.copy()
                    cam_c2w[..., :3, :] = np.einsum("ij,tcjk->tcik", rot.astype(np.float32),
                                                    cam_c2w[..., :3, :])
                aug_rows = np.repeat(rows[None].astype(np.int32), len(rgbs), axis=0)
                aug_cols = np.repeat(cols[None].astype(np.int32), len(rgbs), axis=0)
            else:  # augment.Rotate and augment.Resize applied with these draws
                if rot is not None:
                    pcds = np.einsum("ij,tcjhw->tcihw", rot, pcds)
                rgbs, pcds = (a[..., rows[:, None], cols[None, :]] for a in (rgbs, pcds))

        sample = {
            "task": [task for _ in frame_ids],
            "rgbs": rgbs.astype(np.float32, copy=False),
            "action": action[..., : self._action_dim],
            "curr_gripper": gripper[..., : self._action_dim],
            "curr_gripper_history": gripper_history[..., : self._action_dim],
        }
        if depth_mode:
            sample.update(depth=depth, cam_intr=cam_intr, cam_c2w=cam_c2w)
            if aug_rows is not None:
                sample.update(aug_rows=aug_rows, aug_cols=aug_cols)
        else:
            sample["pcds"] = pcds.astype(np.float32, copy=False)
        if instr_id is not None:
            sample["instr_id"] = instr_id
        else:
            sample["instr"] = instr
        if traj is not None:
            sample["trajectory"] = traj[..., : self._action_dim]
            sample["trajectory_mask"] = traj_mask
        return sample

    def _frame_draws(self, task, variation, episode, frame_ids, hw):
        """The pose arrays of ``frame_ids`` and every draw of
        :meth:`_frames_to_sample`, in its order: the instruction pick, then
        (host augmentation) the Rotate and the Resize draws.  Returns
        (pick, rot, (rows, cols) or None, action, gripper, gripper_history,
        traj, traj_mask), action, gripper and traj rotated."""
        action = np.concatenate([episode[2][i] for i in frame_ids]).astype(np.float32)
        pick = None
        if self._instructions:
            pick = int(self._rng.integers(len(self._instructions[task][variation])))
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

        rot = aug = None
        if self._training and self._augment_host:
            rot, gripper, action, traj = self._rotate.sample(gripper, action, traj)
            aug = self._resize.sample_index_maps(*hw)
        return pick, rot, aug, action, gripper, gripper_history, traj, traj_mask

    def _replay_frame(self, episode_id: int):
        """:meth:`get_frame`'s draws for a row another rank assembles: the
        same calls on the generator, in the same order, without the images.
        None where get_frame returns None."""
        task, variation, episode, _ = self._load(episode_id)
        if episode is None:
            return None
        n_frames = len(episode[0])
        frame_ids = [episode[0][int(self._rng.integers(n_frames)) % n_frames]]
        self._frame_draws(task, variation, episode, frame_ids,
                          np.shape(episode[1][frame_ids[0]])[-2:])
        return True

    def get_frame(self, episode_id: int, frame_index: Optional[int] = None):
        """One (episode, frame) sample, the fixed-shape training unit; a
        random frame unless ``frame_index`` is given."""
        task, variation, episode, aux = self._load(episode_id)
        if episode is None:
            return None
        n_frames = len(episode[0])
        if frame_index is None:
            frame_index = int(self._rng.integers(n_frames))
        frame_ids = [episode[0][frame_index % n_frames]]
        return self._frames_to_sample(task, variation, episode, frame_ids, aux)

    def get_chunk(self, episode_id: int, chunk: Optional[int] = None):
        """Reference-style chunk of up to ``max_episode_length`` frames
        (dataset_engine.py:159-168); a random chunk unless ``chunk`` is
        given."""
        task, variation, episode, aux = self._load(episode_id)
        if episode is None:
            return None
        n_chunks = math.ceil(len(episode[0]) / self._max_episode_length)
        if chunk is None:
            chunk = int(self._rng.integers(n_chunks))
        frame_ids = episode[0][chunk * self._max_episode_length:
                               (chunk + 1) * self._max_episode_length]
        return self._frames_to_sample(task, variation, episode, frame_ids, aux)

    __getitem__ = get_chunk

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Fixed-shape batch of ``batch_size`` random frames; ``task`` is a
        list of names, every other key a numpy array.  With ``world > 1``,
        ``batch_size`` is the global batch and this rank's
        ``batch_size / world`` rows come back.  Thread-safe: the CLIs draw
        evaluation batches from the training set while the feeder thread
        draws training batches (the order of the two threads' draws is not
        fixed)."""
        mine = range(batch_size)
        if self._world > 1:
            from ..parallel.mesh import local_batch_size

            b = local_batch_size(batch_size, self._world)
            mine = range(self._rank * b, (self._rank + 1) * b)
        samples = []
        with self._lock:
            row = 0
            while row < batch_size:
                episode_id = int(self._rng.integers(self._num_episodes))
                if row in mine:
                    s = self.get_frame(episode_id)
                    if s is not None:
                        samples.append(s)
                else:
                    s = self._replay_frame(episode_id)
                row += s is not None
        out: Dict[str, np.ndarray] = {}
        for key in samples[0]:
            if key == "task":
                out["task"] = [t for s in samples for t in s["task"]]
            else:
                out[key] = np.concatenate([s[key] for s in samples], axis=0)
        return out
