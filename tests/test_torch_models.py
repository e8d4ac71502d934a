"""Act3D, the DiffusionPlanner sampler and one chained keystep of the port
against the JAX package on the CPU.

Small configurations (64^2 images, 2 cameras, emb 24, 2 pyramid levels,
5 diffusion steps, trajectory length 8), instructions on.  The samplers'
random draws are injected on both sides: ghost points through
``ghost_points_override``, and for the trajectory the exact noise that
JAX's key schedule produces (``k_init, k_steps = split(key)``;
``split(k_steps, T)``).  Tolerance 1e-3, the full-model bound of
tests/README.md (the 50-layer trunk's float32 error carried through the
attention stacks); Act3D positions must agree exactly, which the test
makes safe by asserting that every level's top-2 mask margin exceeds the
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.models import Act3D as JAct3D
from act3d_tpu.models import DiffusionPlanner as JDiffusionPlanner
from act3d_tpu.models import compute_trajectory as jax_compute_trajectory
from act3d_tpu_torch.convert import act3d_from_flax, diffusion_planner_from_flax
from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.models import Act3D, DiffusionPlanner, compute_trajectory

from tests.torch_parity import close, random_params, t

TOL = 1e-3
BOUNDS = ((-0.3, -0.5, 0.75), (0.7, 0.5, 1.5))
NCAM, IMAGE, N_INSTR, LENGTH, STEPS = 2, 64, 7, 8, 5
ACT3D_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, num_attn_heads=4,
                 num_sampling_level=2, use_instruction=True, num_ghost_points_val=60,
                 gripper_loc_bounds=BOUNDS)
PLANNER_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, output_dim=7,
                   num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
                   use_instruction=True, use_goal=True, diffusion_timesteps=STEPS,
                   gripper_loc_bounds=BOUNDS)


def _observation(seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)
    rgb = rng.uniform(0, 1, (1, NCAM, 3, IMAGE, IMAGE)).astype(np.float32)
    pcd = rng.uniform(lo, hi, (1, NCAM, IMAGE, IMAGE, 3)).astype(np.float32)
    pcd = np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3))
    instr = rng.normal(size=(1, N_INSTR, 512)).astype(np.float32)
    quat = rng.normal(size=4)
    gripper = np.concatenate([rng.uniform(lo, hi), quat / np.linalg.norm(quat), [1.0]])
    ghosts = [rng.uniform(lo, hi, (1, 10, 3)).astype(np.float32) for _ in range(2)]
    return rgb, pcd, instr, gripper[None].astype(np.float32), ghosts


@pytest.fixture(scope="module")
def act3d():
    rgb, pcd, instr, gripper, _ = _observation(0)
    jm = JAct3D(**ACT3D_CFG)
    params = random_params(jm, 12, rgb, pcd, instr, gripper,
                           sample_rng=jax.random.PRNGKey(0), train_mode=False)
    apply = jax.jit(lambda p, rgb, pcd, instr, grip, ghosts: jm.apply(
        {"params": p}, rgb, pcd, instr, grip, sample_rng=jax.random.PRNGKey(0),
        train_mode=False, ghost_points_override=ghosts))
    port = Act3D(**ACT3D_CFG, device="cpu")
    port.load_state_dict(act3d_from_flax(params), strict=True)
    return params, apply, port.eval()


@pytest.fixture(scope="module")
def planner():
    rgb, pcd, instr, gripper, _ = _observation(0)
    grip7 = gripper[:, :7]
    models = {}
    for at_test in (True, False):
        jm = JDiffusionPlanner(**PLANNER_CFG, use_goal_at_test=at_test)
        models[at_test] = jm
    jm = models[True]
    params = random_params(
        jm, 11, np.zeros((1, LENGTH, 7), np.float32), np.zeros((1, LENGTH), bool),
        rgb, pcd, instr, grip7, grip7, noise_rng=jax.random.PRNGKey(0))
    sample = {
        at_test: jax.jit(lambda p, mask, rgb, pcd, instr, curr, goal, key, m=m:
                         jax_compute_trajectory(m, {"params": p}, mask, rgb, pcd,
                                                instr, curr, goal, key))
        for at_test, m in models.items()
    }
    ports = {}
    for at_test in (True, False):
        port = DiffusionPlanner(**PLANNER_CFG, use_goal_at_test=at_test, device="cpu")
        port.load_state_dict(diffusion_planner_from_flax(params), strict=True)
        ports[at_test] = port.eval()
    return params, jm, sample, ports


def _jax_noise(key, d=9):
    k_init, k_steps = jax.random.split(key)
    init = jax.random.normal(k_init, (1, LENGTH, d), dtype=jnp.float32)
    steps = jnp.stack([jax.random.normal(k, (1, LENGTH, d), dtype=jnp.float32)
                       for k in jax.random.split(k_steps, STEPS)])
    return t(init), t(steps)


def _assert_margins(masks_pyramid):
    for masks in masks_pyramid:
        top2 = np.sort(np.asarray(masks[-1]), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > TOL).all(), top2


def test_act3d_eval_forward_matches_jax(act3d):
    params, apply, port = act3d
    rgb, pcd, instr, gripper, ghosts = _observation(1)
    want = apply(params, rgb, pcd, instr, gripper, [jnp.asarray(g) for g in ghosts])
    _assert_margins(want["ghost_pcd_masks_pyramid"])
    with torch.no_grad():
        got = port(t(rgb), t(pcd), t(instr), t(gripper),
                   ghost_points_override=[t(g) for g in ghosts])
    for g_level, w_level in zip(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"]):
        for g, w in zip(g_level, w_level):
            close(g, w, TOL, TOL)
    for g, w in zip(got["position_pyramid"], want["position_pyramid"]):
        close(g, w, 0)
    close(got["position"], want["position"], 0)
    close(got["rotation"], want["rotation"], TOL)
    close(got["gripper"], want["gripper"], TOL)


def test_act3d_samples_ghost_points_from_a_generator(act3d):
    _, _, port = act3d
    rgb, pcd, instr, gripper, _ = _observation(2)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            runs.append(port(t(rgb), t(pcd), t(instr), t(gripper), generator=gen))
    lo, hi = torch.tensor(BOUNDS)
    for a, b in zip(runs[0]["ghost_pcd_pyramid"], runs[1]["ghost_pcd_pyramid"]):
        assert a.shape == (1, 30, 3) and torch.equal(a, b)  # 60 // 2 levels
        assert ((a >= lo - 1e-6) & (a <= hi + 1e-6)).all()
    fine = runs[0]["ghost_pcd_pyramid"][1] - runs[0]["position_pyramid"][0][:, None]
    assert (torch.linalg.norm(fine, dim=-1) < 0.08).all()  # inside the level-1 ball


def test_planner_encode_and_denoise_step_match_jax(planner):
    params, jm, _, ports = planner
    port = ports[True]
    rgb, pcd, instr, gripper, _ = _observation(4)
    goal = gripper[:, :7] + np.float32(0.05)
    mask = np.zeros((1, LENGTH), bool)
    mask[0, -2:] = True
    variables = {"params": params}
    context, curr, goal_n = jm.apply(variables, rgb, pcd, instr, gripper[:, :7], goal,
                                     method=JDiffusionPlanner.encode)
    traj = np.random.default_rng(5).normal(size=(1, LENGTH, 9)).astype(np.float32)
    want = jm.apply(variables, traj, mask, jnp.asarray([3]), context,
                    method=JDiffusionPlanner.denoise_step)
    with torch.no_grad():
        got_context, got_curr, got_goal = port.encode(t(rgb), t(pcd), t(instr),
                                                      t(gripper[:, :7]), t(goal))
        got = port.denoise_step(t(traj), t(mask), torch.tensor([3]), got_context)
    close(got_curr, curr, 1e-6)
    close(got_goal, goal_n, 1e-6)
    close(got_context["rgb_feats_pyramid"][0], context["rgb_feats_pyramid"][0], 2e-4, 1e-3)
    close(got, want, TOL, TOL)


def test_compute_trajectory_matches_jax_with_its_noise(planner):
    params, _, sample, ports = planner
    rgb, pcd, instr, gripper, _ = _observation(6)
    goal = gripper[:, :7] + np.float32(0.05)
    mask = np.zeros((1, LENGTH), bool)
    mask[0, -2:] = True  # padded tail: masked self-attention keys, goal at index 5
    key = jax.random.PRNGKey(7)
    want = sample[True](params, mask, rgb, pcd, instr, gripper[:, :7], goal, key)
    got = compute_trajectory(ports[True], t(mask), t(rgb), t(pcd), t(instr),
                             t(gripper[:, :7]), t(goal), noise=_jax_noise(key))
    assert got.shape == (1, LENGTH, 7)
    close(got, want, TOL, TOL)


def test_chained_keystep_matches_jax_pieces(act3d, planner):
    """The port's Actioner (Act3D keypose -> goal -> sampler, the keypose
    never leaving the device) against the JAX Act3D forward chained into
    JAX compute_trajectory, as the JAX Actioner chains them."""
    a_params, a_apply, a_port = act3d
    p_params, _, sample, p_ports = planner
    rgb, pcd, instr, gripper, ghosts = _observation(8)
    mask = np.zeros((1, LENGTH), bool)
    key = jax.random.PRNGKey(9)

    rgb01 = rgb / 2 + 0.5  # the Actioner maps [-1, 1] to [0, 1]
    pred = a_apply(a_params, rgb01, pcd, instr, gripper, [jnp.asarray(g) for g in ghosts])
    _assert_margins(pred["ghost_pcd_masks_pyramid"])
    action = jnp.concatenate([pred["position"], pred["rotation"], pred["gripper"]], axis=1)
    traj = sample[False](p_params, mask, rgb01, pcd, instr[:1], gripper[:, :7],
                         action[:, :7], key)

    actioner = Actioner(a_port, p_ports[False], instructions={"task": {0: [instr[0]]}},
                        device="cpu")
    actioner.load_episode("task", 0)
    out = actioner.predict(rgb, pcd, gripper, trajectory_mask=mask,
                           ghost_points_override=[t(g) for g in ghosts],
                           noise=_jax_noise(key))
    assert out["action"].shape == (1, 8) and out["trajectory"].shape == (1, LENGTH, 7)
    close(out["action"][:, :3], action[:, :3], 0)
    close(out["action"], action, TOL)
    close(out["trajectory"], traj, TOL, TOL)
