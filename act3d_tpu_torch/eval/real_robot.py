"""Real-robot (Franka) evaluation loop.

Counterpart of ``act3d_tpu/eval/real_robot.py``, over the port's Actioner.

The reference's real_evaluation/eval_real.py is stale — it imports model
classes that no longer exist in its tree (eval_real.py:13-16, SURVEY.md
§2.4).  This is a working re-design of the same capability: a closed
loop over the Actioner and a duck-typed robot interface, so any hardware
bridge (frankapy, polymetis, ROS) can plug in by implementing
``RobotInterface``.

Flow per keystep (mirrors the sim evaluator):
  observe (RGB-D cameras + gripper state) → Actioner.predict (chained
  Act3D keypose → trajectory DDPM) → execute the trajectory pose-by-pose →
  toggle gripper at the end.
"""

from __future__ import annotations

import time
from typing import Dict, Protocol

import numpy as np

from .actioner import Actioner

__all__ = ["RobotInterface", "RealRobotEvaluator"]


class RobotInterface(Protocol):
    """Minimal hardware abstraction the evaluator drives."""

    def observe(self) -> Dict[str, np.ndarray]:
        """Returns {'rgb': (ncam, 3, H, W) in [-1, 1],
                    'pcd': (ncam, 3, H, W) world xyz,
                    'gripper': (8,) pose+open}."""
        ...

    def move_to_pose(self, pose: np.ndarray) -> bool:
        """(7,) position+quat; returns success."""
        ...

    def set_gripper(self, open_: bool) -> None:
        ...


class RealRobotEvaluator:
    def __init__(
        self,
        robot: RobotInterface,
        actioner: Actioner,
        interpolation_length: int = 50,
        position_tolerance: float = 5e-3,
        settle_time_s: float = 0.1,
    ):
        self.robot = robot
        self.actioner = actioner
        self.interpolation_length = interpolation_length
        self.position_tolerance = position_tolerance
        self.settle_time_s = settle_time_s

    def run_episode(
        self,
        task_str: str,
        variation: int = 0,
        max_keysteps: int = 10,
        verbose: bool = True,
    ) -> Dict:
        self.actioner.load_episode(task_str, variation)
        executed = []
        for step_id in range(max_keysteps):
            obs = self.robot.observe()
            rgb = obs["rgb"][None].astype(np.float32)
            pcd = obs["pcd"][None].astype(np.float32)
            gripper = obs["gripper"][None].astype(np.float32)
            mask = np.zeros((1, self.interpolation_length), bool)

            out = self.actioner.predict(
                rgb, pcd, gripper, trajectory_mask=mask
            )
            keypose = out["action"][0]
            if verbose:
                print(f"step {step_id}: keypose {keypose[:3]}")

            if out["trajectory"] is not None:
                for pose in np.asarray(out["trajectory"])[0][1:]:
                    self.robot.move_to_pose(pose[:7])
                    time.sleep(self.settle_time_s)
            else:
                self.robot.move_to_pose(keypose[:7])

            self.robot.set_gripper(bool(round(float(keypose[7]))))
            executed.append(keypose)

            reached = self.robot.observe()["gripper"][:3]
            if (
                np.linalg.norm(reached - keypose[:3])
                > 10 * self.position_tolerance
            ) and verbose:
                print(f"  warning: {np.linalg.norm(reached - keypose[:3]):.3f} "
                      "from target")
        return {"keyposes": np.stack(executed)}
