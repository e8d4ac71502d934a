"""Evaluation video recording.

Counterpart of ``act3d_tpu/eval/video.py``, itself the equivalent of the
reference's utils/video_utils.py: a ``TaskRecorder`` that snapshots a
cinematic camera every simulator step and writes rollout mp4s with cv2
(imported only when a video is written, so OpenCV is optional), plus
``CircleCameraMotion`` for orbiting views and the numpy point-cloud
overlays of ``pcd_render``.

Simulator objects (VisionSensor / Dummy) are duck-typed so the module
imports without PyRep.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = [
    "CameraMotion",
    "CircleCameraMotion",
    "StaticCameraMotion",
    "TaskRecorder",
    "make_cinematic_recorder",
]


class CameraMotion:
    def __init__(self, cam):
        self.cam = cam
        self._prev_pose = None

    def step(self):
        raise NotImplementedError

    def save_pose(self):
        self._prev_pose = self.cam.get_pose()

    def restore_pose(self):
        if self._prev_pose is not None:
            self.cam.set_pose(self._prev_pose)


class StaticCameraMotion(CameraMotion):
    def step(self):
        pass


class CircleCameraMotion(CameraMotion):
    """Orbit the camera around an origin dummy by `speed` rad per step
    (reference video_utils.py:230-240)."""

    def __init__(self, cam, origin, speed: float):
        super().__init__(cam)
        self.origin = origin
        self.speed = speed

    def step(self):
        self.origin.rotate([0.0, 0.0, self.speed])


class TaskRecorder:
    """Collects per-step frames from a cinematic camera (and optional named
    views) and writes them as mp4 via cv2 (reference video_utils.py:243-475,
    minus open3d overlays)."""

    def __init__(
        self,
        cameras=("left_shoulder", "right_shoulder", "wrist"),
        env=None,
        cam_motion: Optional[CameraMotion] = None,
        fps: int = 30,
        task_str: str = "",
        pcd_overlay: bool = False,
    ):
        self._cameras = cameras
        self._env = env
        self._cam_motion = cam_motion
        self._fps = fps
        self._task_str = task_str
        self._snaps: List[np.ndarray] = []
        self._pcd_overlay = pcd_overlay
        self._pcd_snaps: List[np.ndarray] = []
        # sticky overlay state (reference video_utils.py:345-356)
        self._gt_grippers = None
        self._pred_grippers = None
        self._pred_coarse = None
        self._pred_fine = None
        self._position_prediction_only = False
        self._ball_diameter = None
        self._latest_metrics: dict = {}
        self._step_metrics: List[dict] = []

    def cam_motion_save_pose(self):
        if self._cam_motion is not None:
            self._cam_motion.save_pose()

    def cam_motion_restore_pose(self):
        if self._cam_motion is not None:
            self._cam_motion.restore_pose()

    def take_snap(
        self,
        obs=None,
        pred_position=None,
        gt_position=None,
        gt_keyframe_gripper_matrices=None,
        pred_keyframe_gripper_matrices=None,
        pred_coarse_position=None,
        pred_fine_position=None,
        position_prediction_only: bool = False,
        fine_sampling_ball_diameter=None,
        **_,
    ):
        """Per-sim-step snapshot (reference TaskRecorder.take_snap,
        video_utils.py:327-404).  Sticky overlays: gripper matrices and
        coarse/fine positions persist across snaps until save()."""
        if gt_keyframe_gripper_matrices is not None:
            self._gt_grippers = gt_keyframe_gripper_matrices
        if pred_keyframe_gripper_matrices is not None:
            self._pred_grippers = pred_keyframe_gripper_matrices
        if pred_coarse_position is not None:
            self._pred_coarse = pred_coarse_position
        if pred_fine_position is not None:
            self._pred_fine = pred_fine_position
        if pred_position is not None:
            self._pred_fine = pred_position
        if gt_position is not None:
            g = np.eye(4)
            g[:3, 3] = np.asarray(gt_position).reshape(3)
            self._gt_grippers = g[None]
        self._position_prediction_only = position_prediction_only
        if fine_sampling_ball_diameter is not None:
            self._ball_diameter = fine_sampling_ball_diameter

        # keyframe L2 metric, redrawn on every frame until the next
        # keystep (reference video_utils.py:359-368)
        if self._gt_grippers is not None and self._pred_grippers is not None:
            gt_pos = np.asarray(self._gt_grippers).reshape(-1, 4, 4)[:, :3, 3]
            pr_pos = np.asarray(self._pred_grippers).reshape(-1, 4, 4)[:, :3, 3]
            self._latest_metrics = {
                "l2_pos": float(
                    np.mean(np.sqrt(((gt_pos - pr_pos) ** 2).sum(1)))
                )
            }
        if self._latest_metrics:
            self._step_metrics.append(dict(self._latest_metrics))

        if self._cam_motion is not None:
            self._cam_motion.step()
            frame = self._cam_motion.cam.capture_rgb()
            self._snaps.append(
                (np.clip(frame, 0, 1) * 255.0).astype(np.uint8)
            )
        if self._pcd_overlay and obs is not None:
            frame = self._render_pcd_overlay(obs)
            if frame is not None:
                self._pcd_snaps.append(frame)

    def _render_pcd_overlay(self, obs):
        """Multi-view point-cloud render with keypose overlays: the
        numpy z-buffer equivalent of the reference's open3d offscreen
        views (video_utils.py:100-215) — per-camera views plus an
        aggregate, tiled into one frame (see eval/pcd_render.py)."""
        from .pcd_render import get_point_cloud_images

        clouds, colors, names = [], [], []
        for cam in self._cameras:
            pc = getattr(obs, f"{cam}_point_cloud", None)
            rgb = getattr(obs, f"{cam}_rgb", None)
            if pc is None:
                continue
            pc = np.asarray(pc)
            clouds.append(pc)
            names.append(cam)
            if rgb is not None:
                rgb = np.asarray(rgb).astype(np.float32)
                if rgb.max() > 1.5:  # uint8 range
                    rgb = rgb / 255.0
                colors.append(rgb.reshape(pc.shape))
            else:
                colors.append(np.full(pc.shape, 0.5, np.float32))
        if not clouds:
            return None
        imgs = get_point_cloud_images(
            np.stack(colors),
            np.stack(clouds),
            view_names=names,
            gt_keyframe_gripper_matrices=self._gt_grippers,
            pred_keyframe_gripper_matrices=self._pred_grippers,
            pred_coarse_position=self._pred_coarse,
            pred_fine_position=self._pred_fine,
            position_prediction_only=self._position_prediction_only,
            fine_sampling_ball_diameter=self._ball_diameter,
            image_size=(240, 240),
        )
        # tile: per-camera views on top, aggregate bottom-left
        cols_n = max(2, (len(imgs) + 1) // 2)
        h, w = imgs[0].shape[:2]
        rows_n = (len(imgs) + cols_n - 1) // cols_n
        canvas = np.full((rows_n * h, cols_n * w, 3), 255, np.uint8)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols_n)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
        return canvas

    def save(self, path, lang_goal: str = ""):
        path = Path(path)
        out = self._write_mp4(path, self._snaps, lang_goal)
        self._snaps = []
        if self._pcd_snaps:
            self._write_mp4(
                path.with_name(path.name + "_pcd"), self._pcd_snaps, lang_goal
            )
            self._pcd_snaps = []
        # clear sticky overlays for the next demo (video_utils.py:467-475)
        self._gt_grippers = None
        self._pred_grippers = None
        self._pred_coarse = None
        self._pred_fine = None
        self._ball_diameter = None
        self._latest_metrics = {}
        self._step_metrics = []
        return out

    def _write_mp4(self, path, snaps, lang_goal: str):
        import cv2

        if not snaps:
            return None
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        # names may contain dots (e.g. "..._rew1.0") — append, don't replace
        out_path = str(path) if str(path).endswith(".mp4") else str(path) + ".mp4"
        h, w = snaps[0].shape[:2]
        writer = cv2.VideoWriter(
            out_path,
            cv2.VideoWriter_fourcc(*"mp4v"),
            self._fps,
            (w, h),
        )
        for i, frame in enumerate(snaps):
            bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
            if lang_goal:
                cv2.putText(
                    bgr, lang_goal, (10, h - 20),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1,
                    cv2.LINE_AA,
                )
            if i < len(self._step_metrics):
                cv2.putText(
                    bgr,
                    f"Position L2 = {self._step_metrics[i]['l2_pos']:.3f}",
                    (10, h - 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                    cv2.LINE_AA,
                )
            writer.write(bgr)
        writer.release()
        return out_path


def make_cinematic_recorder(
    task_str: str = "",
    resolution=(1280, 720),
    rotation_speed: float = 0.005,
    fps: int = 30,
    pcd_overlay: bool = True,
) -> TaskRecorder:
    """Build a TaskRecorder around RLBench's cinematic camera placeholder
    (reference utils_with_rlbench.py:513-527).  Requires PyRep."""
    from pyrep.objects.dummy import Dummy
    from pyrep.objects.vision_sensor import VisionSensor

    cam_placeholder = Dummy("cam_cinematic_placeholder")
    cam = VisionSensor.create(list(resolution))
    cam.set_pose(cam_placeholder.get_pose())
    cam.set_parent(cam_placeholder)
    cam_motion = CircleCameraMotion(
        cam, Dummy("cam_cinematic_base"), rotation_speed
    )
    return TaskRecorder(
        cam_motion=cam_motion,
        fps=fps,
        task_str=task_str,
        pcd_overlay=pcd_overlay,
    )
