"""Closed-loop RLBench evaluation environment wrapper.

Counterpart of ``act3d_tpu/eval/rlbench_env.py``, the reference
``RLBenchEnv`` (reference: utils/utils_with_rlbench.py:284-883 and its
trimmed twin online_evaluation/utils_with_rlbench.py).  The simulator stack
(RLBench / PyRep / CoppeliaSim) stays host-side CPU behind this interface;
imports are guarded so training never needs the simulator installed
(mirrors reference README.md:22).

Observation tensors flow as numpy; model inference happens through the
port's :class:`act3d_tpu_torch.eval.actioner.Actioner` (or any object with
its ``load_episode`` / ``predict`` surface).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .actioner import Actioner
from .keypoint import keypoint_discovery
from .mover import Mover
from .video import TaskRecorder

try:  # the simulator stack is optional
    from rlbench.observation_config import CameraConfig, ObservationConfig
    from rlbench.environment import Environment
    from rlbench.action_modes.action_mode import MoveArmThenGripper
    from rlbench.action_modes.gripper_action_modes import Discrete
    from rlbench.action_modes.arm_action_modes import EndEffectorPoseViaPlanning
    from rlbench.backend.exceptions import InvalidActionError
    from pyrep.errors import ConfigurationPathError, IKError
    from pyrep.const import RenderMode

    HAS_RLBENCH = True
except ImportError:  # pragma: no cover - exercised only without the sim
    HAS_RLBENCH = False

    class IKError(Exception):
        ...

    class ConfigurationPathError(Exception):
        ...

    class InvalidActionError(Exception):
        ...


__all__ = ["RLBenchEnv", "task_file_to_task_class", "obs_to_attn"]


def task_file_to_task_class(task_file: str):
    import importlib

    name = task_file.replace(".py", "")
    class_name = "".join([w[0].upper() + w[1:] for w in name.split("_")])
    mod = importlib.import_module("rlbench.tasks.%s" % name)
    mod = importlib.reload(mod)
    return getattr(mod, class_name)


def obs_to_attn(obs, camera: str) -> Tuple[int, int]:
    """Project the gripper position into a camera image (u, v)
    (reference utils_with_rlbench.py:263-281), pure numpy."""
    extrinsics = np.linalg.inv(
        np.asarray(obs.misc[f"{camera}_camera_extrinsics"], np.float64)
    )
    intrinsics = np.asarray(obs.misc[f"{camera}_camera_intrinsics"], np.float64)
    gripper = np.append(np.asarray(obs.gripper_pose[:3], np.float64), 1.0)
    points_cam = extrinsics @ gripper
    proj = intrinsics @ points_cam[:3]
    u = int(round(proj[0] / proj[2]))
    v = int(round(proj[1] / proj[2]))
    return u, v


class RLBenchEnv:
    def __init__(
        self,
        data_path,
        image_size=(256, 256),
        apply_rgb: bool = True,
        apply_depth: bool = False,
        apply_pc: bool = True,
        headless: bool = True,
        apply_cameras=("left_shoulder", "right_shoulder", "wrist"),
        collision_checking: bool = False,
        env=None,  # dependency injection for sim-free testing
    ):
        self.data_path = data_path
        self.apply_rgb = apply_rgb
        self.apply_depth = apply_depth
        self.apply_pc = apply_pc
        self.apply_cameras = apply_cameras
        self.image_size = image_size

        if env is not None:
            self.env = env
            return
        if not HAS_RLBENCH:
            raise ImportError(
                "RLBench/PyRep are not installed; closed-loop evaluation "
                "requires the simulator stack (training does not)."
            )
        self.obs_config = self.create_obs_config(
            image_size, apply_rgb, apply_depth, apply_pc, apply_cameras
        )
        self.action_mode = MoveArmThenGripper(
            arm_action_mode=EndEffectorPoseViaPlanning(
                collision_checking=collision_checking
            ),
            gripper_action_mode=Discrete(),
        )
        self.env = Environment(
            self.action_mode, str(data_path), self.obs_config, headless=headless
        )

    # ------------------------------------------------------------- obs I/O
    def get_obs_action(self, obs):
        """obs -> (state dict of per-camera arrays, action (8,))."""
        state_dict = {"rgb": [], "depth": [], "pc": []}
        for cam in self.apply_cameras:
            if self.apply_rgb:
                state_dict["rgb"].append(getattr(obs, f"{cam}_rgb"))
            if self.apply_depth:
                state_dict["depth"].append(getattr(obs, f"{cam}_depth"))
            if self.apply_pc:
                state_dict["pc"].append(getattr(obs, f"{cam}_point_cloud"))
        action = np.concatenate([obs.gripper_pose, [obs.gripper_open]])
        return state_dict, action.astype(np.float32)

    def get_rgb_pcd_gripper_from_obs(self, obs):
        """-> rgb (1, ncam, 3, H, W) in [-1, 1], pcd (1, ncam, 3, H, W),
        gripper (1, 8)."""
        state_dict, gripper = self.get_obs_action(obs)
        rgb = np.stack(state_dict["rgb"]).astype(np.float32)  # (ncam, H, W, 3)
        rgb = rgb.transpose(0, 3, 1, 2) / 255.0 * 2.0 - 1.0
        pcd = np.stack(state_dict["pc"]).astype(np.float32).transpose(0, 3, 1, 2)
        return rgb[None], pcd[None], gripper[None]

    @staticmethod
    def get_gripper_matrix_from_action(action):
        """(8,) action -> 4x4 gripper pose matrix (reference
        utils_with_rlbench.py:404-414; dataset quaternion layout xyzw)."""
        action = np.asarray(action).reshape(-1)
        x, y, z, w = action[3:7] / np.linalg.norm(action[3:7])
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = action[:3]
        return mat

    def get_demo(self, task_name, variation, episode_index):
        return self.env.get_demos(
            task_name=task_name,
            variation_number=variation,
            amount=1,
            from_episode_number=episode_index,
            random_selection=False,
        )

    @staticmethod
    def get_actions_from_demo(demo):
        """Keyframe actions + inter-keyframe trajectories
        (reference utils_with_rlbench.py:181-210)."""
        key_frames = keypoint_discovery(demo)
        action_ls, trajectory_ls, mask_ls = [], [], []
        for i, kf in enumerate(key_frames):
            obs = demo[kf]
            action_ls.append(
                np.concatenate([obs.gripper_pose, [obs.gripper_open]])[None]
                .astype(np.float32)
            )
            start = key_frames[i - 1] if i > 0 else 0
            traj = np.stack(
                [
                    np.concatenate(
                        [demo[j].gripper_pose, [demo[j].gripper_open]]
                    )
                    for j in range(start, kf)
                ]
            ).astype(np.float32)
            trajectory_ls.append(traj)
            mask_ls.append(np.zeros((1, kf - start), bool))
        return action_ls, trajectory_ls, mask_ls

    # ------------------------------------------------------------ eval loop
    def evaluate_task_on_multiple_variations(
        self,
        task_str: str,
        max_steps: int,
        num_variations: int,
        num_demos: int,
        actioner: Actioner,
        max_tries: int = 1,
        offline: bool = False,
        dense_interpolation: bool = False,
        interpolation_length: int = 100,
        verbose: bool = False,
        record_videos: bool = False,
        num_videos: int = 10,
        log_dir=None,
        recorder: TaskRecorder | None = None,
    ) -> Dict:
        self.env.launch()
        task_type = (
            task_file_to_task_class(task_str) if HAS_RLBENCH else task_str
        )
        task = self.env.get_task(task_type)
        task_variations = task.variation_count()
        if num_variations >= 0:
            task_variations = min(num_variations, task_variations)

        var_success_rates = {}
        for variation in range(task_variations):
            task.set_variation(variation)
            success_rate, valid = self._evaluate_task_on_one_variation(
                task_str=task_str,
                task=task,
                max_steps=max_steps,
                variation=variation,
                num_demos=num_demos // task_variations + 1,
                actioner=actioner,
                max_tries=max_tries,
                offline=offline,
                dense_interpolation=dense_interpolation,
                interpolation_length=interpolation_length,
                verbose=verbose,
                record_videos=record_videos,
                num_videos=num_videos,
                log_dir=log_dir,
                recorder=recorder,
            )
            if valid:
                var_success_rates[variation] = success_rate
        self.env.shutdown()
        var_success_rates["mean"] = sum(var_success_rates.values()) / max(
            len(var_success_rates), 1
        )
        return var_success_rates

    def _evaluate_task_on_one_variation(
        self,
        task_str: str,
        task,
        max_steps: int,
        variation: int,
        num_demos: int,
        actioner: Actioner,
        max_tries: int = 1,
        offline: bool = False,
        dense_interpolation: bool = False,
        interpolation_length: int = 100,
        verbose: bool = False,
        record_videos: bool = False,
        num_videos: int = 10,
        log_dir=None,
        recorder: TaskRecorder | None = None,
    ):
        success_rate = 0
        missing_demos = 0
        total_reward = 0.0

        # Video recording: register the recorder as a per-sim-step callback
        # on the arm action mode so every planned sub-step is captured
        # (reference utils_with_rlbench.py:512-528).  A pre-built recorder
        # may be injected for sim-free testing.
        if record_videos and recorder is None:
            from .video import make_cinematic_recorder

            recorder = make_cinematic_recorder(task_str=task_str)
        if record_videos and hasattr(self, "action_mode"):
            self.action_mode.arm_action_mode.set_callable_each_step(
                recorder.take_snap
            )

        for demo_id in range(num_demos):
            try:
                demo = self.get_demo(task_str, variation, episode_index=demo_id)[0]
            except Exception:
                missing_demos += 1
                continue

            if record_videos and demo_id < num_videos:
                recorder.cam_motion_save_pose()

            descriptions, obs = task.reset_to_demo(demo)
            lang_goal = descriptions[0] if descriptions else ""
            actioner.load_episode(task_str, variation)
            move = Mover(task, max_tries=max_tries)
            reward = 0.0
            max_reward = 0.0

            gt_actions, gt_trajectories, gt_masks = self.get_actions_from_demo(
                demo
            )
            n_steps = min(max_steps, len(gt_actions))

            for step_id in range(n_steps):
                rgb, pcd, gripper = self.get_rgb_pcd_gripper_from_obs(obs)
                if dense_interpolation:
                    trajectory_mask = np.zeros(
                        (1, interpolation_length), bool
                    )
                else:
                    trajectory_mask = gt_masks[step_id]

                output = actioner.predict(
                    rgb, pcd, gripper,
                    gt_action=gt_actions[step_id][None],
                    trajectory_mask=trajectory_mask,
                )
                action = (
                    gt_actions[step_id] if offline else output["action"]
                )

                if record_videos and demo_id < num_videos:
                    # keystep snapshot with prediction overlays
                    # (reference utils_with_rlbench.py:627-637: full GT and
                    # predicted gripper-pose matrices plus optional
                    # coarse/fine position markers)
                    recorder.take_snap(
                        obs,
                        gt_keyframe_gripper_matrices=(
                            self.get_gripper_matrix_from_action(
                                gt_actions[step_id][-1]
                            )[None]
                        ),
                        pred_keyframe_gripper_matrices=(
                            self.get_gripper_matrix_from_action(
                                np.asarray(output["action"])[-1]
                            )[None]
                        ),
                        pred_coarse_position=output.get("coarse_position"),
                        pred_fine_position=output.get("fine_position"),
                    )

                try:
                    if output.get("trajectory") is not None:
                        traj = np.asarray(output["trajectory"])[0]
                        if traj.shape[-1] != 8:
                            # append the held gripper state, then the
                            # predicted keypose row (gripper toggle last)
                            traj = np.concatenate(
                                [
                                    traj,
                                    np.tile(
                                        gripper[:, -1:], (traj.shape[0], 1)
                                    ),
                                ],
                                axis=-1,
                            )
                            traj = np.concatenate(
                                [traj, np.asarray(output["action"])], axis=0
                            )
                        traj[:, -1] = traj[:, -1].round()
                        for action_np in traj[1:]:
                            # Skip only unreachable poses (IK/planner/sim
                            # rejections) and continue down the trajectory;
                            # anything else is a real bug and propagates.
                            # The reference's inner loop swallows *all*
                            # exceptions here (utils_with_rlbench.py:687-691
                            # bare `except: pass`) — deliberately narrowed.
                            try:
                                obs, reward, terminate, _ = move(action_np)
                            except (
                                IKError,
                                ConfigurationPathError,
                                InvalidActionError,
                            ):
                                pass
                    else:
                        action_np = np.asarray(action)[-1]
                        obs, reward, terminate, _ = move(action_np)

                    max_reward = max(max_reward, reward)
                    if reward == 1:
                        success_rate += 1
                        break
                    if terminate and verbose:
                        print("The episode has terminated!")
                except (IKError, ConfigurationPathError, InvalidActionError) as e:
                    print(task_str, demo, step_id, success_rate, e)
                    reward = 0
                    break

            if record_videos and demo_id < num_videos:
                video_dir = Path(log_dir or ".") / "videos"
                recorder.save(
                    video_dir / f"{task_str}_ep{demo_id}_rew{reward}",
                    lang_goal,
                )
                recorder.cam_motion_restore_pose()

            total_reward += max_reward
            print(
                task_str, "Variation", variation, "Demo", demo_id,
                "Reward", f"{reward:.2f}",
                f"SR: {success_rate}/{demo_id + 1}",
                "Missing", missing_demos,
            )

        if (num_demos - missing_demos) == 0:
            return 0.0, False
        return success_rate * num_demos / (num_demos - missing_demos), True

    # ---------------------------------------------------------------- misc
    @staticmethod
    def create_obs_config(
        image_size, apply_rgb, apply_depth, apply_pc, apply_cameras
    ):
        unused_cams = CameraConfig()
        unused_cams.set_all(False)
        used_cams = CameraConfig(
            rgb=apply_rgb,
            point_cloud=apply_pc,
            depth=apply_depth,
            mask=False,
            image_size=image_size,
            render_mode=RenderMode.OPENGL,
        )
        kwargs = {n: used_cams for n in apply_cameras}
        return ObservationConfig(
            front_camera=kwargs.get("front", unused_cams),
            left_shoulder_camera=kwargs.get("left_shoulder", unused_cams),
            right_shoulder_camera=kwargs.get("right_shoulder", unused_cams),
            wrist_camera=kwargs.get("wrist", unused_cams),
            overhead_camera=kwargs.get("overhead", unused_cams),
            joint_forces=False,
            joint_positions=False,
            joint_velocities=True,
            task_low_dim_state=False,
            gripper_touch_forces=False,
            gripper_pose=True,
            gripper_open=True,
            gripper_matrix=True,
            gripper_joint_positions=True,
        )
