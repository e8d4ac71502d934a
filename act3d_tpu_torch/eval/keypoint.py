"""Keyframe discovery over demonstrations (pure numpy).

Counterpart of ``act3d_tpu/eval/keypoint.py``, the reference heuristic
(reference: utils/utils_with_rlbench.py:884-929): a frame is a keypoint
when the gripper state changes, when the arm has stopped (joint
velocities ≈ 0 with a 4-frame hysteresis buffer), or at the episode end.

Works on RLBench ``Demo`` objects (duck-typed: ``obs.gripper_open``,
``obs.joint_velocities``) or on a plain dict of arrays.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["keypoint_discovery", "keypoint_discovery_arrays"]


def _is_stopped(gripper_open, joint_vel, i, stopped_buffer, delta):
    n = len(gripper_open)
    next_is_not_final = i == (n - 2)
    gripper_state_no_change = i < (n - 2) and (
        gripper_open[i] == gripper_open[i + 1]
        and gripper_open[i] == gripper_open[max(0, i - 1)]
        and gripper_open[max(0, i - 2)] == gripper_open[max(0, i - 1)]
    )
    small_delta = np.allclose(joint_vel[i], 0, atol=delta)
    return (
        stopped_buffer <= 0
        and small_delta
        and (not next_is_not_final)
        and gripper_state_no_change
    )


def keypoint_discovery_arrays(
    gripper_open: Sequence[float],
    joint_velocities: np.ndarray,
    stopping_delta: float = 0.1,
) -> List[int]:
    """Array form: gripper_open (T,), joint_velocities (T, n_joints)."""
    episode_keypoints: List[int] = []
    prev_gripper_open = gripper_open[0]
    stopped_buffer = 0
    n = len(gripper_open)
    for i in range(n):
        stopped = _is_stopped(
            gripper_open, joint_velocities, i, stopped_buffer, stopping_delta
        )
        stopped_buffer = 4 if stopped else stopped_buffer - 1
        last = i == (n - 1)
        if i != 0 and (gripper_open[i] != prev_gripper_open or last or stopped):
            episode_keypoints.append(i)
        prev_gripper_open = gripper_open[i]

    if (
        len(episode_keypoints) > 1
        and episode_keypoints[-1] - 1 == episode_keypoints[-2]
    ):
        episode_keypoints.pop(-2)
    return episode_keypoints


def keypoint_discovery(demo, stopping_delta: float = 0.1) -> List[int]:
    """RLBench-Demo form (same semantics as the reference)."""
    gripper_open = [obs.gripper_open for obs in demo]
    joint_vel = np.stack([obs.joint_velocities for obs in demo])
    return keypoint_discovery_arrays(gripper_open, joint_vel, stopping_delta)
