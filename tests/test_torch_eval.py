"""The port's closed-loop evaluation modules against the JAX package's.

``eval/{keypoint,mover,fake_sim,pcd_render,video,rlbench_env,real_robot}``
are numpy on both sides, so every comparison is exact (atol 0): keyframes,
the Mover's steps, observation tensors, the sim-free backend's stream for
one seed, rendered point-cloud frames, and the whole RLBench loop under a
scripted actioner (a plain class returning fixed numpy actions and
trajectories): the same success-rate dict and the same sequence of
``FakeTask.step`` actions, with dense and demo-length trajectory masks and
with the per-pose ``IKError`` skip.
"""

import numpy as np
import pytest

from act3d_tpu.eval import fake_sim as jax_fake_sim
from act3d_tpu.eval import keypoint as jax_keypoint
from act3d_tpu.eval import mover as jax_mover
from act3d_tpu.eval import pcd_render as jax_pcd_render
from act3d_tpu.eval import real_robot as jax_real_robot
from act3d_tpu.eval import rlbench_env as jax_rlbench_env
from act3d_tpu.eval import video as jax_video
from act3d_tpu_torch.eval import fake_sim, keypoint, mover, pcd_render, real_robot, rlbench_env
from act3d_tpu_torch.eval import video

IMAGE = (24, 32)
CAMS = ("left_shoulder", "wrist")
GOAL = np.array(jax_fake_sim._DEFAULT_GOAL)
PACKAGES = {"jax": (jax_rlbench_env, jax_fake_sim), "port": (rlbench_env, fake_sim)}


def _same(a, b):
    """Equal structure, equal values (atol 0)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _observations(obs):
    """Every attribute of a (fake) RLBench observation."""
    return {k: v for k, v in vars(obs).items()}


# ------------------------------------------------------------------ numpy parts


@pytest.mark.parametrize("seed", range(4))
def test_keypoint_discovery_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    gripper = (rng.uniform(size=n) < 0.8).astype(np.float64)
    vel = rng.normal(size=(n, 7))
    vel[rng.uniform(size=n) < 0.3] = 0.0
    got = keypoint.keypoint_discovery_arrays(gripper, vel)
    assert got == jax_keypoint.keypoint_discovery_arrays(gripper, vel)
    demo = fake_sim.FakeDemo(rng, IMAGE, CAMS, GOAL, n_frames=8 + seed)
    assert keypoint.keypoint_discovery(demo) == jax_keypoint.keypoint_discovery(demo)


class _ConvergingTask:
    """Moves 60% of the way to the commanded pose each step; reward 1 within
    2e-3 of ``GOAL``."""

    def __init__(self):
        self.pose = np.zeros(7)
        self.actions = []

    def step(self, action, collision_checking=False):
        self.actions.append(np.array(action, copy=True))
        self.pose = self.pose + 0.6 * (np.asarray(action[:7], np.float64) - self.pose)
        obs = fake_sim.FakeObservation(self.pose, float(action[7] > 0.5),
                                       np.random.default_rng(len(self.actions)), (4, 4),
                                       ("wrist",))
        return obs, float(np.linalg.norm(self.pose[:3] - GOAL) < 2e-3), False, []


@pytest.mark.parametrize("max_tries", [1, 3, 10])
def test_mover_matches_jax(max_tries):
    targets = [np.concatenate([p, [0, 0, 0, 1], [g]])
               for p, g in ((np.full(3, 0.1), 1.0), (np.full(3, 0.05), 0.0), (GOAL, 0.0),
                            (GOAL, 1.0))]
    runs = []
    for mod in (jax_mover, mover):
        task = _ConvergingTask()
        move = mod.Mover(task, max_tries=max_tries)
        outs = []
        for target in targets:
            obs, reward, terminate, images = move(target.copy())
            outs.append((_observations(obs), reward, terminate, images))
        runs.append((outs, task.actions))
    _same(runs[0], runs[1])


def test_observation_helpers_match_jax():
    rng = np.random.default_rng(0)
    envs = [mod.RLBenchEnv("unused", image_size=IMAGE, apply_cameras=CAMS, env=object())
            for mod in (jax_rlbench_env, rlbench_env)]
    demo = fake_sim.FakeDemo(rng, IMAGE, CAMS, GOAL, n_frames=12)
    obs = demo[3]
    _same(envs[1].get_rgb_pcd_gripper_from_obs(obs), envs[0].get_rgb_pcd_gripper_from_obs(obs))
    for _ in range(4):
        action = np.concatenate([rng.normal(size=3), rng.normal(size=4), [1.0]])
        _same(rlbench_env.RLBenchEnv.get_gripper_matrix_from_action(action),
              jax_rlbench_env.RLBenchEnv.get_gripper_matrix_from_action(action))
    _same(rlbench_env.RLBenchEnv.get_actions_from_demo(demo),
          jax_rlbench_env.RLBenchEnv.get_actions_from_demo(demo))
    for cam in CAMS:
        extrinsics = np.eye(4)
        extrinsics[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        obs.misc = {f"{cam}_camera_extrinsics": extrinsics,
                    f"{cam}_camera_intrinsics": np.array([[110.0, 0, 16], [0, 120.0, 12],
                                                          [0, 0, 1.0]])}
        assert rlbench_env.obs_to_attn(obs, cam) == jax_rlbench_env.obs_to_attn(obs, cam)


def test_fake_sim_stream_matches_jax():
    streams = []
    for mod in (jax_fake_sim, fake_sim):
        env = mod.FakeSimEnv(image_size=IMAGE, cameras=CAMS, seed=5)
        env.launch()
        task = env.get_task("pick_and_lift")
        stream = []
        for demo_id in range(2):
            (demo,) = env.get_demos("pick_and_lift", 0, 1, demo_id, False)
            stream.append([_observations(o) for o in demo])
            descriptions, obs = task.reset_to_demo(demo)
            stream.append((descriptions, _observations(obs)))
            for i in range(3):
                action = np.concatenate([GOAL * i / 2, [0, 0, 0, 1], [i % 2]])
                out = task.step(action)
                stream.append((_observations(out[0]), *out[1:]))
        streams.append(stream)
    _same(streams[1], streams[0])


@pytest.mark.parametrize("position_prediction_only", [False, True])
def test_point_cloud_images_match_jax(position_prediction_only):
    rng = np.random.default_rng(1)
    pcd = rng.uniform(-0.3, 0.3, (2, 12, 16, 3))
    pcd[..., 2] += 0.8
    rgb = rng.uniform(0, 1, (2, 12, 16, 3))
    grasp = np.eye(4)
    grasp[:3, 3] = [0.05, -0.02, 0.8]
    kwargs = dict(view_names=["left_shoulder", "wrist"],
                  gt_keyframe_gripper_matrices=grasp[None],
                  pred_keyframe_gripper_matrices=(grasp @ jax_pcd_render.euler_matrix(
                      0.1, 0.2, 0.3))[None],
                  pred_coarse_position=np.array([0.0, 0.0, 0.8]),
                  pred_fine_position=np.array([0.02, 0.01, 0.8]),
                  position_prediction_only=position_prediction_only,
                  fine_sampling_ball_diameter=0.16, image_size=(40, 48))
    _same(pcd_render.get_point_cloud_images(rgb, pcd, **kwargs),
          jax_pcd_render.get_point_cloud_images(rgb, pcd, **kwargs))


# ------------------------------------------------------------------ the loop


class ScriptedActioner:
    """Fixed numpy outputs, no model: the keypose ``target`` with a gripper
    value of 0.3 (as a sigmoid gives it; the loop rounds it to closed), and
    (``trajectory``) a straight line from the current gripper to it over the
    mask's length, 7 wide as the sampler returns it."""

    def __init__(self, target, trajectory=True):
        self.target = np.asarray(target, np.float32)
        self.trajectory = trajectory
        self.calls = []

    def load_episode(self, task_str, variation):
        self.calls.append(("load_episode", task_str, variation))

    def predict(self, rgb, pcd, gripper, gt_action=None, trajectory_mask=None):
        self.calls.append(("predict", rgb.shape, pcd.shape, gripper.copy(),
                           None if gt_action is None else gt_action.copy(),
                           trajectory_mask.shape))
        action = np.concatenate([self.target, [0, 0, 0, 1], [0.3]]).astype(np.float32)[None]
        traj = None
        if self.trajectory:
            n = trajectory_mask.shape[1]
            pos = np.linspace(gripper[0, :3], self.target, n)
            traj = np.concatenate([pos, np.tile([0, 0, 0, 1.0], (n, 1))], -1)
            traj = traj[None].astype(np.float32)
        return {"action": action, "trajectory": traj}


def _run_loop(pkg, actioner, raises=(), recorder=None, **kw):
    env_mod, sim_mod = PACKAGES[pkg]
    raises = [getattr(env_mod, r) if isinstance(r, str) else r for r in raises]
    sim = sim_mod.FakeSimEnv(image_size=IMAGE, cameras=CAMS, seed=3, raises=raises)
    steps = []
    get_task = sim.get_task

    def recording_get_task(task_type):
        task = get_task(task_type)
        step = task.step

        def recorded(action, collision_checking=False):
            steps.append(np.array(action, copy=True))
            return step(action, collision_checking=collision_checking)

        task.step = recorded
        return task

    sim.get_task = recording_get_task
    env = env_mod.RLBenchEnv("unused", image_size=IMAGE, apply_cameras=CAMS, env=sim)
    rates = env.evaluate_task_on_multiple_variations(
        "pick_and_lift", max_steps=3, num_variations=1, num_demos=1, actioner=actioner,
        recorder=recorder, **kw)
    return rates, steps


LOOP_CASES = {
    "dense_reaches_goal": dict(target=GOAL, dense_interpolation=True, interpolation_length=6),
    "dense_ik_error_skipped": dict(target=GOAL, dense_interpolation=True,
                                   interpolation_length=6, raises=("IKError",)),
    "demo_mask_misses": dict(target=GOAL + 0.5, dense_interpolation=False, max_tries=2),
    "misses_after_two_ik_errors": dict(target=GOAL - 0.4, dense_interpolation=True,
                                       interpolation_length=4,
                                       raises=("IKError", "ConfigurationPathError")),
    "keypose_only": dict(target=GOAL, trajectory=False, max_tries=2),
    "offline_keypose": dict(target=GOAL + 1.0, trajectory=False, offline=True),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_matches_jax_under_a_scripted_actioner(case):
    kw = dict(LOOP_CASES[case])
    target, trajectory = kw.pop("target"), kw.pop("trajectory", True)
    runs = {}
    for pkg in PACKAGES:
        actioner = ScriptedActioner(target, trajectory)
        rates, steps = _run_loop(pkg, actioner, **kw)
        runs[pkg] = (rates, steps, actioner.calls)
    _same(runs["port"], runs["jax"])
    rates, steps, _ = runs["port"]
    assert steps and set(rates) == {0, "mean"}
    reaches = np.linalg.norm(np.asarray(target) - GOAL) < 0.2 or kw.get("offline")
    assert rates["mean"] == (2.0 if reaches else 0.0)  # num_demos // 1 + 1 demos


def test_loop_propagates_other_exceptions_like_jax():
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            _run_loop(pkg, ScriptedActioner(GOAL), raises=(ValueError,),
                      dense_interpolation=True, interpolation_length=4)


class _Camera:
    def __init__(self, rng):
        self._rng = rng

    def capture_rgb(self):
        return self._rng.uniform(0, 1, (48, 64, 3))

    def get_pose(self):
        return np.zeros(7)

    def set_pose(self, pose):
        pass


def test_loop_records_videos(tmp_path):
    pytest.importorskip("cv2")
    recorder = video.TaskRecorder(cameras=CAMS, fps=5, pcd_overlay=True,
                                  cam_motion=video.StaticCameraMotion(
                                      _Camera(np.random.default_rng(0))))
    rates, _ = _run_loop("port", ScriptedActioner(GOAL), recorder=recorder,
                         dense_interpolation=True, interpolation_length=4,
                         record_videos=True, num_videos=1, log_dir=tmp_path)
    assert rates["mean"] == 2.0
    names = sorted(v.name for v in (tmp_path / "videos").glob("*.mp4"))
    assert "pick_and_lift_ep0_rew1.0.mp4" in names, names
    assert "pick_and_lift_ep0_rew1.0_pcd.mp4" in names, names
    assert all((tmp_path / "videos" / n).stat().st_size > 1000 for n in names)


def test_recorder_frames_match_jax():
    frames = []
    for mod in (jax_video, video):
        recorder = mod.TaskRecorder(cameras=CAMS, pcd_overlay=True,
                                    cam_motion=mod.StaticCameraMotion(
                                        _Camera(np.random.default_rng(0))))
        demo = fake_sim.FakeDemo(np.random.default_rng(2), IMAGE, CAMS, GOAL)
        grasp = np.eye(4)
        grasp[:3, 3] = GOAL
        recorder.take_snap(demo[0], gt_keyframe_gripper_matrices=grasp[None],
                           pred_keyframe_gripper_matrices=grasp[None],
                           pred_coarse_position=GOAL, pred_fine_position=GOAL + 0.01)
        recorder.take_snap(demo[1])
        frames.append((recorder._snaps, recorder._pcd_snaps, recorder._step_metrics))
    _same(frames[1], frames[0])


# ------------------------------------------------------------- the real robot


class _Robot:
    """Duck-typed RobotInterface: seeded observations, logged commands."""

    def __init__(self):
        self._rng = np.random.default_rng(4)
        self.log = []
        self.pose = np.array([0.0, 0.0, 0.8, 0, 0, 0, 1.0])

    def observe(self):
        return {"rgb": self._rng.uniform(-1, 1, (2, 3, 8, 8)),
                "pcd": self._rng.uniform(-1, 1, (2, 3, 8, 8)),
                "gripper": np.concatenate([self.pose, [1.0]])}

    def move_to_pose(self, pose):
        self.log.append(("move", np.array(pose)))
        self.pose = np.asarray(pose, np.float64)
        return True

    def set_gripper(self, open_):
        self.log.append(("gripper", open_))


@pytest.mark.parametrize("trajectory", [True, False])
def test_real_robot_evaluator_matches_jax(trajectory):
    runs = []
    for mod in (jax_real_robot, real_robot):
        robot, actioner = _Robot(), ScriptedActioner(GOAL, trajectory)
        evaluator = mod.RealRobotEvaluator(robot, actioner, interpolation_length=5,
                                           settle_time_s=0.0)
        out = evaluator.run_episode("pick_and_lift", max_keysteps=3, verbose=False)
        runs.append((out, robot.log, actioner.calls))
    _same(runs[1], runs[0])
    assert runs[1][0]["keyposes"].shape == (3, 8)
