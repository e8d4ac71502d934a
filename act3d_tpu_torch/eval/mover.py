"""Retrying action executor for closed-loop evaluation.

Counterpart of ``act3d_tpu/eval/mover.py``, the reference ``Mover``
(reference: utils/utils_with_rlbench.py:63-140): re-steps the simulator
until the end-effector is within 5e-3 of the target position (or
max_tries is exhausted), deferring the gripper open/close toggle to a
final dedicated step.  Numpy only; duck-typed over any task environment
exposing ``step(action) -> (obs, reward, terminate, other_obs)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["Mover"]


class Mover:
    def __init__(self, task, disabled: bool = False, max_tries: int = 1):
        self._task = task
        self._last_action: Optional[np.ndarray] = None
        self._step_id = 0
        self._max_tries = max_tries
        self._disabled = disabled

    def __call__(self, action: np.ndarray, collision_checking: bool = False):
        if self._disabled:
            return self._task.step(action)

        target = action.copy()
        if self._last_action is not None:
            action[7] = self._last_action[7].copy()

        images = []
        try_id = 0
        obs = None
        terminate = None
        reward = 0.0

        for try_id in range(self._max_tries):
            obs, reward, terminate, other_obs = self._task.step(
                action, collision_checking=collision_checking
            )
            if other_obs == []:
                other_obs = [obs]
            for o in other_obs:
                images.append(
                    {
                        k.split("_")[0]: getattr(o, k)
                        for k in o.__dict__.keys()
                        if "_rgb" in k and getattr(o, k) is not None
                    }
                )

            pos = obs.gripper_pose[:3]
            dist_pos = np.sqrt(np.square(target[:3] - pos).sum())
            if dist_pos < 5e-3 or reward == 1:
                break
            print(
                f"Too far away (pos: {dist_pos:.3f}, step: {self._step_id})"
                "... Retrying..."
            )

        # execute the deferred gripper toggle after the retries
        action = target
        if (
            not reward == 1.0
            and self._last_action is not None
            and action[7] != self._last_action[7]
        ):
            obs, reward, terminate, other_obs = self._task.step(action)
            if other_obs == []:
                other_obs = [obs]
            for o in other_obs:
                images.append(
                    {
                        k.split("_")[0]: getattr(o, k)
                        for k in o.__dict__.keys()
                        if "_rgb" in k and getattr(o, k) is not None
                    }
                )

        if try_id == self._max_tries:
            print(f"Failure after {self._max_tries} tries")

        self._step_id += 1
        self._last_action = action.copy()
        return obs, reward, terminate, images
