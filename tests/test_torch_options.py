"""The model options of both training CLIs, the port against the JAX package
on the CPU.

* the rotation functions of ``ops/rotations.py`` (1e-6, closed form);
* ``find_traj_nn`` with ties at the k-th boundary and duplicate points, and
  ``topk_nearest_context(approx=True)`` (exact on the CPU, as
  ``lax.approx_max_k`` is there): the same indices as JAX's;
* Act3D with every rotation parametrization, levels tied and untied, the
  ResNet-50 backbone and approximate top-k: masks, positions, rotation and
  gripper (1e-3, the full-model bound of tests/README.md), every level's
  top-2 mask margin asserted so the argmax picks agree; the gradient of one
  untied 6D step, whose rotation rows of ``gripper_state_fc2`` get none
  (JAX computes no rotation loss for 6D);
* the DiffusionPlanner with 2 or 3 feature scales and 2 attention rounds,
  with and without ``use_goal``, non-6D rotations and the ResNet-50
  backbone: every block's prediction, the loss and the sampler (1e-3), the
  trajectory-nearest context's k-th margin asserted; the gradient of one
  multi-block step (atol 1e-4 / rtol 1e-3);
* a bf16 multi-block loss (tests/test_torch_bf16.py's 2e-2) and a
  multi-block step at two gloo ranks against one (tests/test_torch_parallel.py's
  bounds);
* the ``.msgpack`` reader against the installed ``msgpack`` and flax.

Small sizes: 64^2 images, 2 cameras (128^2, 1 camera where the fine level
must hold more points than the top-k keeps), emb 12 / 24, 2-3 levels,
3 diffusion steps, batch 2.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.models import Act3D as JAct3D
from act3d_tpu.models import DiffusionPlanner as JDiffusionPlanner
from act3d_tpu.models import compute_trajectory as jax_compute_trajectory
from act3d_tpu.ops import geometry as jgeo
from act3d_tpu.ops import rotations as jR
from act3d_tpu.train import losses as jlosses
from act3d_tpu.train.flagship import keypose_loss_fn as jax_keypose_loss_fn
from act3d_tpu_torch.convert import act3d_from_flax, diffusion_planner_from_flax
from act3d_tpu_torch.core import msgpack as port_msgpack
from act3d_tpu_torch.models import Act3D, DiffusionPlanner, compute_trajectory
from act3d_tpu_torch.ops import geometry, rotations
from act3d_tpu_torch.train import losses
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_trajectory_batch

from tests import torch_parallel_workers as W
from tests.torch_parity import close, random_params, t

TOL = 1e-3
BATCH, N_INSTR, LENGTH, STEPS = 2, 7, 6, 3
ACT3D_KEYS = ("rgbs", "pcds", "instr", "curr_gripper")
PLANNER_KEYS = ("trajectory", "trajectory_mask", "rgbs", "pcds", "instr", "curr_gripper",
                "action")


# ------------------------------------------------------------ rotations
def _unit_quats(rng, n=32):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


ROTATION_CASES = {
    "standardize_quaternion": lambda rng: (rng.normal(size=(16, 4)).astype(np.float32),),
    "quat_xyzw_to_wxyz": lambda rng: (rng.normal(size=(3, 5, 4)).astype(np.float32),),
    "quat_wxyz_to_xyzw": lambda rng: (rng.normal(size=(3, 5, 4)).astype(np.float32),),
    "quaternion_raw_multiply": lambda rng: (_unit_quats(rng), _unit_quats(rng)),
    "quaternion_multiply": lambda rng: (_unit_quats(rng), _unit_quats(rng)),
    "quaternion_invert": lambda rng: (_unit_quats(rng),),
    "quaternion_apply": lambda rng: (_unit_quats(rng), rng.normal(size=(32, 3)).astype(
        np.float32)),
    # angles near zero take the Taylor branch
    "axis_angle_to_quaternion": lambda rng: (np.concatenate(
        [rng.normal(size=(30, 3)), np.full((2, 3), 1e-8)]).astype(np.float32),),
    "quaternion_to_axis_angle": lambda rng: (np.concatenate(
        [_unit_quats(rng, 30), np.array([[1, 0, 0, 0], [1, 1e-8, 0, 0]])]).astype(
        np.float32),),
    "axis_angle_to_matrix": lambda rng: (rng.normal(size=(32, 3)).astype(np.float32),),
    "matrix_to_axis_angle": lambda rng: (np.asarray(jR.quaternion_to_matrix(
        _unit_quats(rng))),),
    "rotation_from_svd": lambda rng: (rng.normal(size=(4, 10, 3)).astype(np.float32),
                                      rng.normal(size=(4, 10, 3)).astype(np.float32)),
    "orthonormalize_by_gram_schmidt": lambda rng: (rng.normal(size=(8, 3, 3)).astype(
        np.float32),),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotation_function_matches_jax(name):
    args = ROTATION_CASES[name](np.random.default_rng(len(name)))
    want = getattr(jR, name)(*(jnp.asarray(a) for a in args))
    got = getattr(rotations, name)(*(t(a) for a in args))
    close(got, want, 1e-6 if name != "rotation_from_svd" else 1e-5)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "XZX", "YXY"])
def test_euler_angles_match_jax(convention):
    rng = np.random.default_rng(3)
    angles = rng.uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    mat = jR.euler_angles_to_matrix(jnp.asarray(angles), convention)
    close(rotations.euler_angles_to_matrix(t(angles), convention), mat, 1e-6)
    close(rotations.matrix_to_euler_angles(t(np.asarray(mat)), convention),
          jR.matrix_to_euler_angles(mat, convention), 1e-5)
    with pytest.raises(ValueError, match="convention"):
        rotations.euler_angles_to_matrix(t(angles), "XYW")


def test_rotation_from_svd_with_centres_is_proper():
    rng = np.random.default_rng(4)
    p1, p2 = (rng.normal(size=(3, 8, 3)).astype(np.float32) for _ in range(2))
    c1, c2 = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    got = rotations.rotation_from_svd(t(p1), t(p2), t(c1), t(c2))
    close(got, jR.rotation_from_svd(p1, p2, c1, c2), 1e-5)
    close(torch.linalg.det(got), np.ones(3), 1e-5)


# ------------------------------------------------------------- geometry
def test_find_traj_nn_matches_jax_with_ties_at_the_boundary():
    """Duplicate points tie, and two of them sit at the k-th place: which of
    the equal distances are kept, and their order, are lax.top_k's (the
    lower index first)."""
    rng = np.random.default_rng(5)
    traj = rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)
    cloud = rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32)
    k = 5 * 3
    cloud[:, 150:160] = cloud[:, 140:150]  # duplicates anywhere
    d2 = ((traj[:, :, None] - cloud[:, None]) ** 2).sum(-1).min(1)
    for b in range(2):
        order = np.argsort(d2[b], kind="stable")
        # three points at the k-th distance, at places k - 2, k - 1 and k
        cloud[b, order[k + 3]] = cloud[b, order[k - 1]]
        cloud[b, order[2]] = cloud[b, order[k - 1]]
    want = jgeo.find_traj_nn(jnp.asarray(traj), jnp.asarray(cloud), nn_per_step=5)
    got = geometry.find_traj_nn(t(traj), t(cloud), nn_per_step=5)
    d2 = ((traj[:, :, None] - cloud[:, None]) ** 2).sum(-1).min(1)
    kth = np.take_along_axis(d2, np.asarray(want)[:, -1:], 1)
    assert ((d2 == kth).sum(1) >= 3).all()  # a tie across the k-th place in every row
    assert got.shape == (2, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_approx_topk_on_the_cpu_is_jax_s_selection():
    rng = np.random.default_rng(6)
    cloud = rng.uniform(-1, 1, (2, 4096, 3)).astype(np.float32)
    cloud[:, 2048:] = cloud[:, :2048]  # every distance tied twice
    anchor = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    exact = jgeo.topk_nearest_context(jnp.asarray(anchor), jnp.asarray(cloud), 1024)
    approx = jgeo.topk_nearest_context(jnp.asarray(anchor), jnp.asarray(cloud), 1024,
                                       approx=True)
    got = geometry.topk_nearest_context(t(anchor), t(cloud), 1024, approx=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exact))
    np.testing.assert_array_equal(np.sort(got.numpy(), -1), np.sort(np.asarray(approx), -1))


# ---------------------------------------------------------------- Act3D
def _act3d_batch(seed, image, ncam):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)

    def pose8():
        q = rng.normal(size=(BATCH, 4))
        return np.concatenate([rng.uniform(lo + 0.1, hi - 0.1, (BATCH, 3)),
                               q / np.linalg.norm(q, axis=-1, keepdims=True),
                               rng.integers(0, 2, (BATCH, 1))], axis=-1).astype(np.float32)

    pcd = rng.uniform(lo, hi, (BATCH, ncam, image, image, 3)).astype(np.float32)
    return {"rgbs": rng.uniform(0, 1, (BATCH, ncam, 3, image, image)).astype(np.float32),
            "pcds": np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3)),
            "instr": rng.normal(size=(BATCH, N_INSTR, 512)).astype(np.float32),
            "curr_gripper": pose8(), "action": pose8()}


def _act3d_cfg(rotation, tied, backbone="clip", image=64, approx=False):
    return dict(backbone=backbone, image_size=(image, image), embedding_dim=12,
                num_attn_heads=4, num_sampling_level=2, use_instruction=True,
                num_ghost_points=40, num_ghost_points_val=20, gripper_loc_bounds=BOUNDS,
                rotation_parametrization=rotation, weight_tying=tied, gp_emb_tying=tied,
                approx_topk=approx)


@functools.lru_cache(maxsize=None)
def _act3d_params(tied, rotation_dim, backbone, seed):
    """Seeded flax params of the small Act3D (their shapes depend on the
    tying, the rotation's width and the backbone only)."""
    rotation = "quat_from_query" if rotation_dim == 4 else "6D"
    batch = _act3d_batch(0, 64, 2)
    return random_params(JAct3D(**_act3d_cfg(rotation, tied, backbone)), seed,
                         *(batch[k] for k in ACT3D_KEYS), sample_rng=jax.random.PRNGKey(0),
                         gt_action=batch["action"])


def _act3d_pair(cfg, seed):
    jm = JAct3D(**cfg)
    params = _act3d_params(cfg["weight_tying"], jm.rotation_dim, cfg["backbone"], seed)
    port = Act3D(**cfg, device="cpu")
    port.load_state_dict(act3d_from_flax(params), strict=True)
    return jm, params, port


def _assert_margins(got_pyramid, want_pyramid):
    """Each level's top-2 margin of JAX's last mask exceeds twice the port's
    largest error on it, so both argmaxes pick the same ghost point."""
    for got, want in zip(got_pyramid, want_pyramid):
        want = np.asarray(want[-1])
        err = np.abs(got[-1].detach().numpy() - want).max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 2 * err).all(), (top2, err)


def _compare_act3d(got, want):
    _assert_margins(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"])
    for g_level, w_level in zip(got["ghost_pcd_masks_pyramid"],
                                want["ghost_pcd_masks_pyramid"]):
        for g, w in zip(g_level, w_level):
            close(g, w, TOL, TOL)
    for g, w in zip(got["position_pyramid"], want["position_pyramid"]):
        close(g, w, 0)
    close(got["position"], want["position"], 0)
    close(got["rotation"], want["rotation"], TOL, TOL)
    close(got["gripper"], want["gripper"], TOL, TOL)


ACT3D_CASES = [(rotation, tied, "clip", False) for rotation in
               ("quat_from_query", "6D", "quat_from_top_ghost", "6D_from_top_ghost")
               for tied in (True, False)] + [("quat_from_query", True, "resnet", False),
                                             ("quat_from_query", False, "clip", True)]


@pytest.mark.parametrize("rotation,tied,backbone,approx", ACT3D_CASES,
                         ids=[f"{r}-{'tied' if t_ else 'untied'}-{b}{'-approx' * a}"
                              for r, t_, b, a in ACT3D_CASES])
def test_act3d_option_matches_jax(rotation, tied, backbone, approx):
    """Eval mode with injected ghost points.  At 64^2 the fine levels keep
    every point, so ``approx_topk`` runs its selection on the whole level
    (the selection itself is held against JAX's in
    test_approx_topk_on_the_cpu_is_jax_s_selection)."""
    batch = _act3d_batch(1, 64, 2)
    cfg = _act3d_cfg(rotation, tied, backbone, approx=approx)
    jm, params, port = _act3d_pair(cfg, 11)
    names = set(port.state_dict())
    if tied:
        assert "ghost_points_embed" in names and "query_cross_attn_1.attn_0.norm.weight" not in names
    else:
        assert {"ghost_points_embed_0", "ghost_points_embed_1",
                "vis_ins_attn_1.attn_0.norm.weight"} <= names
    ghosts = [np.random.default_rng(2 + i).uniform(*BOUNDS, (BATCH, 10, 3)).astype(np.float32)
              for i in range(2)]
    # op by op: the cases share every shape but the head's, and JAX's op
    # cache serves them after the first
    want = jm.apply({"params": params}, *(batch[k] for k in ACT3D_KEYS),
                    sample_rng=jax.random.PRNGKey(0), train_mode=False,
                    ghost_points_override=[jnp.asarray(g) for g in ghosts])
    with torch.no_grad():
        got = port.eval()(*(t(batch[k]) for k in ACT3D_KEYS),
                          ghost_points_override=[t(g) for g in ghosts])
    assert got["rotation"].shape == ((BATCH, 4) if "quat" in rotation else (BATCH, 3, 3))
    _compare_act3d(got, want)


def _uniforms(sample_rng, n_ghost, levels=2):
    """The uniforms JAX's samplers draw in Act3D.__call__."""
    rngs = jax.random.split(sample_rng, levels)
    return [t(jax.random.uniform(rngs[i], (BATCH, n_ghost * (1 if i == 0 else 4), 3),
                                 dtype=jnp.float32)) for i in range(levels)]


def test_untied_6d_act3d_gradients_match_jax():
    """One untied ``6D_from_top_ghost`` training step: the loss and every
    trained gradient equal JAX's; JAX computes no rotation loss for the 6D
    parametrizations, so the six rotation rows of ``gripper_state_fc2``
    get a zero gradient on both sides (the reference's behaviour too)."""
    batch = _act3d_batch(4, 64, 2)
    rotation = "6D_from_top_ghost"
    jm, params, port = _act3d_pair(_act3d_cfg(rotation, False), 14)
    criterion = losses.KeyposeLossAndMetrics(rotation_parametrization=rotation)
    loss_fn = jax_keypose_loss_fn(jm, jlosses.KeyposeLossAndMetrics(
        rotation_parametrization=rotation))
    rng = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, rng)
    assert "rotation" not in want_aux
    sample_rng, _ = jax.random.split(rng)
    got = port.train()(*(t(batch[k]) for k in ACT3D_KEYS), gt_action=t(batch["action"]),
                       ghost_uniforms=_uniforms(sample_rng, 20))
    got_losses = criterion.compute_loss(got, t(batch["action"]))
    assert sorted(got_losses) == sorted(want_aux)
    loss = sum(got_losses.values())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want = act3d_from_flax(jax.device_get(want_grads))
    checked = 0
    for name, param in port.named_parameters():
        if "backbone" in name:
            continue
        if param.grad is None:
            assert not want[name].any(), name
            continue
        close(param.grad, want[name].numpy(), 1e-4, 1e-3)
        checked += 1
    assert checked > 60, checked
    fc2 = port.gripper_state_fc2
    assert not fc2.weight.grad[:6].any() and not fc2.bias.grad[:6].any()
    assert not want["gripper_state_fc2.weight"][:6].any()
    assert fc2.weight.grad[6].abs().sum() > 0  # the gripper row learns
    metrics = criterion.compute_metrics(got, t(batch["action"]))
    assert "rot_l1" not in metrics and "gripper" in metrics


# ---------------------------------------------------- DiffusionPlanner
def _planner_batch(seed, image=64):
    batch = synthetic_trajectory_batch(BATCH, 2, (image, image), LENGTH, seed=seed)
    batch["instr"] = batch["instr"][:, :N_INSTR]
    batch["trajectory_mask"][1, -2:] = True  # padded rows, zero-filled as the dataset does
    batch["trajectory"][1, -2:] = 0.0
    return {k: v.numpy() for k, v in batch.items()}


def _planner_cfg(scales=1, rounds=1, goal=True, rotation="6D", backbone="clip"):
    return dict(backbone=backbone, image_size=(64, 64), embedding_dim=24, output_dim=7,
                num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
                use_instruction=True, use_goal=goal, use_goal_at_test=False,
                feat_scales_to_use=scales, attn_rounds=rounds,
                rotation_parametrization=rotation, diffusion_timesteps=STEPS,
                gripper_loc_bounds=BOUNDS)


def _planner_pair(cfg, batch, seed):
    jm = JDiffusionPlanner(**cfg)
    params = random_params(jm, seed, *(batch[k] for k in PLANNER_KEYS),
                           noise_rng=jax.random.PRNGKey(0))
    port = DiffusionPlanner(**cfg, device="cpu")
    port.load_state_dict(diffusion_planner_from_flax(params), strict=True)
    return jm, params, port


def _noise(key, dim):
    """JAX's draws in DiffusionPlanner.__call__: (noise, timesteps)."""
    k_noise, k_time = jax.random.split(key)
    return (jax.random.normal(k_noise, (BATCH, LENGTH, dim), dtype=jnp.float32),
            jax.random.randint(k_time, (BATCH,), 0, STEPS))


def _assert_nn_margins(cfg, jax_outputs, pcd_pyramid):
    """Where a block attends to the trajectory-nearest points, the k-th and
    (k+1)-th distances from JAX's trajectory so far differ by more than
    the port's error could move them, so both pick the same points."""
    scales = cfg["feat_scales_to_use"]
    for i in range(len(jax_outputs)):
        scale = i % scales
        if not (cfg["use_goal"] and scale > 0):
            continue
        prev = np.asarray(jax_outputs[i - 1])[..., :3]
        cloud = np.asarray(pcd_pyramid[scale])
        d2 = np.sort(((prev[:, :, None] - cloud[:, None]) ** 2).sum(-1).min(1), -1)
        k = (64 if scale == 1 else 16) * LENGTH
        assert (d2[:, k] - d2[:, k - 1] > 1e-5).all(), d2[:, k - 1:k + 1]


PLANNER_CASES = {
    "scales3": dict(scales=3),
    "scales2-rounds2-no-goal": dict(scales=2, rounds=2, goal=False),
    "quat-resnet": dict(rotation="quat", backbone="resnet"),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_option_matches_jax(case):
    """Every block's prediction from one noisy trajectory, and the loss
    (summed over the blocks) with JAX's noise and timesteps."""
    cfg = _planner_cfg(**PLANNER_CASES[case])
    batch = _planner_batch(1)
    jm, params, port = _planner_pair(cfg, batch, 21)
    n_blocks = cfg["feat_scales_to_use"] * cfg["attn_rounds"]
    assert f"prediction_head.traj_attention_{n_blocks - 1}.layer_0.sa1.q_proj.weight" in \
        port.state_dict()
    dim = port.internal_dim
    assert dim == (9 if cfg["rotation_parametrization"] == "6D" else 7)
    obs = [batch[k] for k in ("rgbs", "pcds", "instr", "curr_gripper")]
    goal = batch["action"]
    traj = np.random.default_rng(5).normal(size=(BATCH, LENGTH, dim)).astype(np.float32) * 0.3
    mask = batch["trajectory_mask"]
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jax_side(p):
        context, _, _ = jm.apply({"params": p}, *obs, goal, method=JDiffusionPlanner.encode)
        blocks = jm.apply({"params": p}, traj, mask, jnp.asarray([2, 1]), context,
                          method=lambda m, *a: m.head.denoise(*a))
        loss = jm.apply({"params": p}, *(batch[k] for k in PLANNER_KEYS), noise_rng=key,
                        deterministic=True)
        return blocks, loss, context["pcd_pyramid"]

    want, want_loss, pcd_pyramid = jax_side(params)
    assert len(want) == n_blocks
    _assert_nn_margins(cfg, want, pcd_pyramid)
    port.eval()
    with torch.no_grad():
        got_context, _, _ = port.encode(*(t(x) for x in obs), t(goal))
        got = port.prediction_head.denoise(t(traj), t(mask), torch.tensor([2, 1]), got_context)
    assert len(got) == n_blocks
    for g, w in zip(got, want):
        close(g, w, TOL, TOL)

    noise, timesteps = _noise(key, dim)
    with torch.no_grad():
        got_loss = port(*(t(batch[k]) for k in PLANNER_KEYS), noise=t(noise),
                        timesteps=t(timesteps))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=TOL)


def test_non_6d_planner_sampler_matches_jax():
    """The 3-step reverse process with quaternion rotations (7 numbers a
    pose, normalised after the last step)."""
    cfg = _planner_cfg(rotation="quat")
    batch = _planner_batch(2)
    jm, params, port = _planner_pair(cfg, batch, 22)
    dim = port.internal_dim
    key = jax.random.PRNGKey(7)
    mask = batch["trajectory_mask"]
    obs = [batch[k] for k in ("rgbs", "pcds", "instr", "curr_gripper", "action")]
    want = jax.jit(lambda p: jax_compute_trajectory(jm, {"params": p}, mask, *obs, key))(params)
    k_init, k_steps = jax.random.split(key)
    noise = (t(jax.random.normal(k_init, (BATCH, LENGTH, dim), dtype=jnp.float32)),
             t(jnp.stack([jax.random.normal(k, (BATCH, LENGTH, dim), dtype=jnp.float32)
                          for k in jax.random.split(k_steps, STEPS)])))
    got = compute_trajectory(port.eval(), t(mask), *(t(x) for x in obs), noise=noise)
    assert got.shape == (BATCH, LENGTH, 7)
    close(got, want, TOL, TOL)
    close(torch.linalg.vector_norm(got[..., 3:7], dim=-1), np.ones((BATCH, LENGTH)), 1e-5)


def test_multi_block_planner_gradients_match_jax():
    """One step of a 2-scale planner: the loss and every trained gradient
    (through the trajectory-nearest gather's scatter-add) equal JAX's."""
    cfg = _planner_cfg(scales=2)
    batch = _planner_batch(3)
    jm, params, port = _planner_pair(cfg, batch, 23)
    key = jax.random.PRNGKey(4)

    def loss(p):
        return jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in PLANNER_KEYS),
                        noise_rng=key, deterministic=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    noise, timesteps = _noise(key, 9)
    got = port.eval()(*(t(batch[k]) for k in PLANNER_KEYS), noise=t(noise),
                      timesteps=t(timesteps))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=1e-4)
    want = diffusion_planner_from_flax(jax.device_get(want_grads))
    checked = 0
    for name, param in port.named_parameters():
        if "backbone" in name:
            continue
        if param.grad is None:
            assert not want[name].any(), name
            continue
        close(param.grad, want[name].numpy(), 1e-4, 1e-3)
        checked += 1
    assert checked > 150, checked
    # the scale-1 blocks' context reached the res1 FPN level through the gather
    assert port.prediction_head.visual.feature_pyramid.layer_res1.weight.grad.abs().sum() > 0


def test_multi_block_planner_bf16_matches_jax():
    """--mixed_precision 1 with a 2-scale planner: the head's bf16 blocks
    (params and inputs cast as JAX's _cast_tree casts them, the
    trajectory-nearest distances in bf16) within 2e-2 of JAX's bf16 blocks
    relative to their scale; the whole bf16 loss of the port float32 with a
    float32 gradient for every trained parameter
    (tests/test_torch_bf16.py's bounds)."""
    from act3d_tpu.train.flagship import _cast_tree
    from act3d_tpu_torch.train.flagship import diffusion_loss

    cfg = _planner_cfg(scales=2)
    batch = _planner_batch(4)
    jm, params, port = _planner_pair(cfg, batch, 24)
    bf = jnp.bfloat16
    obs = [batch[k] for k in ("rgbs", "pcds", "instr", "curr_gripper")]
    traj = np.random.default_rng(6).normal(size=(BATCH, LENGTH, 9)).astype(np.float32) * 0.3
    mask = batch["trajectory_mask"]

    @jax.jit
    def jax_side(p):
        context, _, _ = jm.apply({"params": p}, *obs, batch["action"],
                                 method=JDiffusionPlanner.encode)
        context = _cast_tree(context, bf)
        blocks = jm.apply({"params": _cast_tree(p, bf)}, _cast_tree(jnp.asarray(traj), bf),
                          mask, jnp.asarray([2, 1]), context,
                          method=lambda m, *a: m.head.denoise(*a))
        return blocks, context

    want, context = jax_side(jax.tree.map(jnp.asarray, params))
    port.eval()
    got_context = {k: None if v is None else
                   [t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16) for x in v]
                   if isinstance(v, list) else t(np.asarray(v.astype(jnp.float32))).to(
                       torch.bfloat16) for k, v in context.items()}
    head = copy.deepcopy(port.prediction_head).to(torch.bfloat16)  # JAX's _cast_tree
    with torch.no_grad():
        got = head.denoise(t(traj).to(torch.bfloat16), t(mask), torch.tensor([2, 1]),
                           got_context)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy() / scale, w / scale, atol=2e-2)

    noise, timesteps = _noise(jax.random.PRNGKey(5), 9)
    loss = diffusion_loss(port, {k: t(batch[k]) for k in PLANNER_KEYS}, None, torch.bfloat16,
                          noise=t(noise), timesteps=t(timesteps))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    grads = [p.grad for n, p in port.named_parameters()
             if "backbone" not in n and p.grad is not None]
    assert len(grads) > 150 and all(g.dtype == torch.float32 for g in grads)


def test_multi_block_planner_at_two_ranks_matches_one(tmp_path):
    """The (dp, fsdp) mesh with the options: a 2-scale, 2-round planner at
    two gloo ranks (DDP, dropout on, uneven padding) equals one device: the
    gradients of the global batch by JAX's per-leaf scaled rule and the
    losses within rtol 2e-4 (tests/test_torch_parallel.py's bounds), over
    one step.  After an update the runs' parameters differ by float32
    rounding, and the trajectory-nearest selection is discontinuous in
    them: a point at the k-th place can swap, so later losses may part by
    more than the rounding (1e-3 after three steps at these sizes; 1e-7
    without use_goal, where nothing is selected)."""
    from tests.test_torch_parallel import _assert_grads_close, _diffusion_batch

    batch = _diffusion_batch()
    options = dict(feat_scales_to_use=2, attn_rounds=2)
    ref = W.model_run(0, 1, "diffusion", 1, batch, 1, False, options)
    (run0, run1) = W.spawn(W.model_run, 2, tmp_path, "diffusion", 1, batch, 1, False, options)
    for run in (run0, run1):
        np.testing.assert_allclose(ref["losses"], run["losses"], rtol=2e-4)
        _assert_grads_close(ref["grads"], run["grads"])
    assert any("pos_attention_3" in name for name in ref["grads"])


# ------------------------------------------------------------- msgpack
def test_msgpack_reader_matches_flax_and_msgpack():
    """Every leaf kind flax writes: nested maps, ints, floats, str, None,
    bools, lists, numpy scalars, complex, float32 / int32 / bool / bfloat16
    arrays, and a chunked leaf (flax's chunk size lowered to force it)."""
    import msgpack
    from flax import serialization

    rng = np.random.default_rng(7)
    bf = rng.normal(size=(3, 5)).astype(jnp.bfloat16)
    tree = {"params": {"dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                                 "bias": np.zeros(3, np.float32)},
                       "big": np.arange(1000, dtype=np.float32).reshape(10, 100)},
            "opt": {"count": np.int32(7), "mask": np.array([True, False]),
                    "ids": np.arange(6, dtype=np.int32).reshape(2, 3), "bf16": bf},
            "step": 12, "neg": -40000, "loss": 0.25, "name": "x" * 40, "none": None,
            "flag": True, "items": [1, 2.5, "three"], "z": complex(1.5, -2.0),
            "f64": np.float64(3.25)}
    chunk = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 1024
    try:
        blob = serialization.msgpack_serialize(tree)
    finally:
        serialization.MAX_CHUNK_SIZE = chunk
    assert b"__msgpack_chunked_array__" in blob
    want = serialization.msgpack_restore(blob)
    raw = msgpack.unpackb(blob, raw=False, ext_hook=serialization._msgpack_ext_unpack)
    got_raw = port_msgpack.unpackb(blob)

    def same(a, b):
        if isinstance(a, dict):
            assert isinstance(b, dict) and sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, torch.Tensor):  # bfloat16
            assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, (a, b)

    same(got_raw, raw)  # the msgpack layer, chunks as written
    path = _write(blob)
    same(port_msgpack.load_msgpack(path), want)  # chunks reassembled
    assert port_msgpack.load_msgpack(path)["params"]["big"].shape == (10, 100)
    with pytest.raises(ValueError, match="trailing"):
        port_msgpack.unpackb(blob + b"\x00")
    with pytest.raises(ValueError, match="extension type 5"):
        port_msgpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"ab")))


def _write(blob):
    import tempfile
    from pathlib import Path

    path = Path(tempfile.mkdtemp()) / "tree.msgpack"
    path.write_bytes(blob)
    return path


def test_chip_smoke_msgpack_writer_writes_the_jax_trainer_layout(tmp_path):
    """chip_smoke.py writes the card's .msgpack checkpoints itself (no flax
    or msgpack there): its params tree has JAX's leaves and shapes (an
    untied 6D Act3D, a 2-scale 2-round planner), flax restores its bytes,
    and the port's eval loader reads back the exact state dict."""
    from flax import serialization

    import chip_smoke
    from act3d_tpu_torch.eval.main import load_params

    cases = [
        (_act3d_params(False, 6, "clip", 11), Act3D(**_act3d_cfg("6D", False), device="cpu"),
         act3d_from_flax),
        (_planner_pair(_planner_cfg(scales=2, rounds=2), _planner_batch(1), 21)[1],
         DiffusionPlanner(**_planner_cfg(scales=2, rounds=2), device="cpu"),
         diffusion_planner_from_flax),
    ]
    for want, model, flax_fn in cases:
        state = model.state_dict()
        tree = chip_smoke.flax_params(state)
        assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, want)
        blob = chip_smoke.msgpack_bytes({"params": tree, "step": 0})
        restored = serialization.msgpack_restore(blob)
        assert restored["step"] == 0
        for a, b in zip(jax.tree.leaves(restored["params"]), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
        path = tmp_path / "best.msgpack"
        path.write_bytes(blob)
        loaded = load_params(path, model, None, flax_fn).state_dict()
        assert all(torch.equal(loaded[k], state[k]) for k in state)
