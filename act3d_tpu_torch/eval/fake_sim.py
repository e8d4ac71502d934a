"""Sim-free dry-run backend for the closed-loop evaluation stack.

Counterpart of ``act3d_tpu/eval/fake_sim.py``: for one seed it yields the
same observation stream.  Implements the small slice of the RLBench
``Environment`` / ``Task`` / ``Demo`` / ``Observation`` surface that
:class:`~act3d_tpu_torch.eval.rlbench_env.RLBenchEnv` touches, with
deterministic synthetic observations — so the full eval CLI
(``python -m act3d_tpu_torch.eval.main --fake_sim 1``) can be executed
end-to-end (checkpoint load -> Actioner -> task loop -> per-task
success-rate JSON) in environments without CoppeliaSim / PyRep /
RLBench.  The reference's equivalent surface
(online_evaluation/eval1.py:209-241) hard-requires the simulator; here the
backend is injected (rlbench_env.py ``env=`` parameter) and this module is
the stand-in.

Semantics: each fake demo is a straight-line end-effector path from a
start pose to ``goal``; ``FakeTask.step`` rewards an action whose
commanded position lands within ``goal_radius`` of that goal.  A policy
that tracks the demo keyposes therefore scores, and a broken pipeline
(wrong layouts, failed checkpoint load, bad un-normalisation) scores 0 —
which is exactly the property the CLI drive asserts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FakeObservation", "FakeDemo", "FakeTask", "FakeSimEnv"]

_DEFAULT_GOAL = (0.2, 0.1, 1.0)


class FakeObservation:
    """Duck-typed rlbench Observation: per-camera rgb/point-cloud attrs,
    gripper pose/open state, joint velocities."""

    def __init__(self, pose, gripper_open, rng, image_size, cameras):
        self.gripper_pose = np.asarray(pose, np.float64)
        self.gripper_open = gripper_open
        self.joint_velocities = rng.normal(size=7)
        h, w = image_size
        for cam in cameras:
            setattr(
                self, f"{cam}_rgb",
                rng.uniform(0, 255, (h, w, 3)).astype(np.uint8),
            )
            setattr(
                self, f"{cam}_point_cloud",
                rng.uniform(-0.4, 1.4, (h, w, 3)).astype(np.float32),
            )
        self.misc = {}


class FakeDemo:
    """Straight-line demo start->goal; gripper closes on the last frame,
    arm velocity drops to zero near the end (so keypoint discovery finds
    a terminal keypose)."""

    def __init__(self, rng, image_size, cameras, goal, n_frames=12):
        start = np.array([0.0, 0.0, 0.8, 0, 0, 0, 1.0])
        end = np.concatenate([np.asarray(goal, np.float64), [0, 0, 0, 1]])
        poses = np.linspace(start, end, n_frames)
        self._observations = []
        for i, p in enumerate(poses):
            obs = FakeObservation(
                p, 1.0 if i < n_frames - 1 else 0.0, rng, image_size, cameras
            )
            if i >= n_frames - 2:
                obs.joint_velocities = np.zeros(7)
            self._observations.append(obs)

    def __len__(self):
        return len(self._observations)

    def __getitem__(self, i):
        return self._observations[i]

    def __iter__(self):
        return iter(self._observations)


class FakeTask:
    """step() pops and raises from ``raises`` (exception factories) first
    — for exercising the eval loop's per-pose error scoping — then
    executes actions, rewarding proximity to the goal."""

    def __init__(self, rng, image_size, cameras, goal, goal_radius=0.2,
                 raises=()):
        self._rng = rng
        self._image_size = image_size
        self._cameras = cameras
        self._goal = np.asarray(goal, np.float64)
        self._goal_radius = goal_radius
        self._raises = list(raises)
        self.pose = np.array([0.0, 0.0, 0.8, 0, 0, 0, 1.0])
        self.steps = 0

    def variation_count(self):
        return 1

    def set_variation(self, v):
        pass

    def reset_to_demo(self, demo):
        self.pose = demo[0].gripper_pose.copy()
        obs = FakeObservation(
            self.pose, 1.0, self._rng, self._image_size, self._cameras
        )
        return ["reach the goal marker"], obs

    def step(self, action, collision_checking=False):
        self.steps += 1
        if self._raises:
            raise self._raises.pop(0)()
        self.pose = np.asarray(action[:7], np.float64)
        obs = FakeObservation(
            self.pose, float(action[7] > 0.5), self._rng,
            self._image_size, self._cameras,
        )
        reward = float(
            np.linalg.norm(self.pose[:3] - self._goal) < self._goal_radius
        )
        return obs, reward, False, []


class FakeSimEnv:
    """Duck-typed rlbench Environment for RLBenchEnv's ``env=`` injection."""

    def __init__(self, image_size=(128, 128), cameras=("left_shoulder",),
                 goal=_DEFAULT_GOAL, seed=0, raises=(), demo_frames=12):
        self._rng = np.random.default_rng(seed)
        self._image_size = tuple(image_size)
        self._cameras = tuple(cameras)
        self._goal = goal
        self._raises = raises
        self._demo_frames = demo_frames
        self.launched = False
        self.task = None

    def launch(self):
        self.launched = True

    def shutdown(self):
        pass

    def get_task(self, task_type):
        self.task = FakeTask(
            self._rng, self._image_size, self._cameras, self._goal,
            raises=self._raises,
        )
        return self.task

    def get_demos(self, task_name, variation_number, amount,
                  from_episode_number, random_selection):
        return [
            FakeDemo(
                self._rng, self._image_size, self._cameras, self._goal,
                n_frames=self._demo_frames,
            )
            for _ in range(amount)
        ]
