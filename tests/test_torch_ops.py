"""Plain ops of the port against the JAX package on the CPU.

Closed-form math (rotations, rotary codes, schedules, samplers) is held at
1e-6..1e-5; the schedules also against the float64 oracle of
tests/test_schedulers_golden.py.  The samplers are fed the uniforms that
``jax.random.uniform`` drew, so both sides see the same numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.ops import geometry as jgeo
from act3d_tpu.ops import rotary as jrot
from act3d_tpu.ops import rotations as jR
from act3d_tpu.ops import sampling as jsamp
from act3d_tpu.ops.schedulers import make_ddpm_schedule as jax_schedule
from act3d_tpu_torch.ops import geometry, rotary, rotations, sampling
from act3d_tpu_torch.ops.schedulers import make_ddpm_schedule

from tests.test_schedulers_golden import oracle_add_noise, oracle_betas, oracle_step
from tests.torch_parity import close, t


def _quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def test_quaternion_functions_match_jax():
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    close(rotations.normalise_quat(t(q)), jR.normalise_quat(q), 1e-6)
    mat = np.asarray(jR.quaternion_to_matrix(jR.normalise_quat(q)))
    close(rotations.quaternion_to_matrix(rotations.normalise_quat(t(q))), mat, 1e-6)
    close(rotations.matrix_to_quaternion(t(mat)), jR.matrix_to_quaternion(mat), 1e-6)
    close(rotations.normalise_quat(torch.zeros(2, 4)), jR.normalise_quat(np.zeros((2, 4))), 0)


def test_ortho6d_functions_match_jax():
    rng = np.random.default_rng(1)
    six = rng.normal(size=(3, 5, 6)).astype(np.float32)
    mat = np.asarray(jR.rotation_matrix_from_ortho6d(six))
    close(rotations.rotation_matrix_from_ortho6d(t(six)), mat, 1e-6)
    close(rotations.ortho6d_from_rotation_matrix(t(mat)), jR.ortho6d_from_rotation_matrix(mat), 0)


@pytest.mark.parametrize("dim", [12, 60, 120])
def test_rotary_pe_3d_matches_jax(dim):
    xyz = np.random.default_rng(2).uniform(-2, 2, (2, 17, 3)).astype(np.float32)
    close(rotary.rotary_pe_3d(t(xyz), dim), jrot.rotary_pe_3d(jnp.asarray(xyz), dim), 1e-6)


@pytest.mark.parametrize("matmul_form", ["0", "1"])
def test_embed_rotary_matches_both_jax_forms(monkeypatch, matmul_form):
    """JAX has two forms of the pair rotation (a lane shuffle, and a ±1
    matmul under ACT3D_ROTARY_MATMUL=1); the port's one form matches each.
    Head dim 15 at E=60: the pairs cross head boundaries."""
    monkeypatch.setenv("ACT3D_ROTARY_MATMUL", matmul_form)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 60)).astype(np.float32)
    code = np.asarray(jrot.rotary_pe_3d(jnp.asarray(rng.uniform(-1, 1, (2, 9, 3))), 60))
    want = jrot.embed_rotary(jnp.asarray(x), jnp.asarray(code))
    close(rotary.embed_rotary(t(x), t(code)), want, 1e-6)


def test_sinusoidal_pos_emb_matches_jax():
    x = np.array([0, 1, 7, 50, 99], np.int32)
    close(rotary.sinusoidal_pos_emb(t(x), 120), jrot.sinusoidal_pos_emb(jnp.asarray(x), 120), 2e-6)


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_schedule_tables_match_jax_and_float64_oracle(schedule):
    ours, theirs = make_ddpm_schedule(schedule, 100), jax_schedule(schedule, 100)
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "posterior_x0_coeff",
                 "posterior_xt_coeff", "posterior_variance"):
        close(getattr(ours, name), getattr(theirs, name), 0)
    close(ours.betas, oracle_betas(schedule, 100), 1e-7)


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_schedule_step_and_add_noise_match_float64_oracle(schedule):
    rng = np.random.default_rng(4)
    sched = make_ddpm_schedule(schedule, 100)
    x0 = (rng.normal(size=(2, 5, 3)) * 1.5).astype(np.float32)  # exercises the clip
    xt = rng.normal(size=(2, 5, 3)).astype(np.float32)
    eps = rng.normal(size=(2, 5, 3)).astype(np.float32)
    for step in (0, 1, 50, 99):
        want = oracle_step(schedule, 100, x0.astype(np.float64), step,
                           xt.astype(np.float64), eps.astype(np.float64))
        close(sched.step(t(x0), step, t(xt), t(eps)), want, 5e-6, 1e-5)
    ts = np.array([0, 99])
    got = sched.add_noise(t(x0), t(eps), torch.as_tensor(ts))
    for i, step in enumerate(ts):
        want = oracle_add_noise(schedule, 100, x0[i].astype(np.float64), step,
                                eps[i].astype(np.float64))
        close(got[i], want, 5e-6, 1e-5)


def test_cube_sampler_matches_jax_with_the_same_uniforms():
    key = jax.random.PRNGKey(5)
    bounds = jnp.asarray([[[-0.3, -0.5, 0.7], [0.7, 0.5, 1.5]]] * 2, jnp.float32)
    want = jsamp.sample_uniform_cube(key, bounds, 40)
    u = jax.random.uniform(key, (2, 40, 3), dtype=jnp.float32)
    close(sampling.sample_uniform_cube(t(bounds), 40, u=t(u)), want, 1e-6)
    drawn = sampling.sample_uniform_cube(t(bounds), 40, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 40, 3)
    assert (drawn >= t(bounds)[:, None, 0] - 1e-6).all()
    assert (drawn <= t(bounds)[:, None, 1] + 1e-6).all()


def test_ball_sampler_and_bounds_match_jax_with_the_same_uniforms():
    key = jax.random.PRNGKey(6)
    workspace = jnp.asarray([[-0.3, -0.5, 0.7], [0.7, 0.5, 1.5]], jnp.float32)
    center = jnp.asarray([[0.65, 0.0, 1.0], [0.1, -0.1, 1.1]], jnp.float32)
    diameter = 0.16
    box = jsamp.ghost_point_bounds(center, diameter, workspace)
    close(sampling.ghost_point_bounds(t(center), diameter, t(workspace)), box, 0)
    want = jsamp.sample_uniform_ball(key, center, diameter / 2, box, 50)
    u = jax.random.uniform(key, (2, 200, 3), dtype=jnp.float32)
    got = sampling.sample_uniform_ball(t(center), diameter / 2, t(box), 50, u=t(u))
    close(got, want, 1e-6)
    assert (torch.linalg.norm(got - t(center)[:, None], dim=-1) < diameter / 2).all()


def test_topk_nearest_context_and_gather_match_jax():
    rng = np.random.default_rng(7)
    cloud = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 500, 6)).astype(np.float32)
    anchor = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    want = np.sort(np.asarray(jgeo.topk_nearest_context(jnp.asarray(anchor), jnp.asarray(cloud), 64)), -1)
    got = torch.sort(geometry.topk_nearest_context(t(anchor), t(cloud), 64), -1).values
    np.testing.assert_array_equal(got.numpy(), want)
    close(geometry.gather_tokens(t(feats), got),
          jgeo.gather_tokens(jnp.asarray(feats), jnp.asarray(want)), 0)


@pytest.mark.parametrize("n", [1, 2, 10])
def test_sample_grid_matches_jax(n):
    bounds = np.asarray([[-0.3, -0.5, 0.75], [0.7, 0.5, 1.5]], np.float32)
    want = jsamp.sample_grid(jnp.asarray(bounds), n)
    got = sampling.sample_grid(t(bounds), n)
    assert got.shape == (n ** 3, 3) and got.dtype == torch.float32
    close(got, want, 1e-6)


def test_find_cylinder_points_matches_jax_but_at_the_radius():
    rng = np.random.default_rng(8)
    cloud = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    start = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    end = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    n = 50
    want = np.asarray(jgeo.find_cylinder_points(jnp.asarray(start), jnp.asarray(end), n,
                                                jnp.asarray(cloud)))
    got = geometry.find_cylinder_points(t(start), t(end), n, t(cloud)).numpy()
    assert got.dtype == np.bool_ and got.shape == (2, 500)
    # float64 distance to the nearest line sample against the radius
    s64, e64 = start.astype(np.float64), end.astype(np.float64)
    line = s64[:, None] + (e64 - s64)[:, None] / (n - 1) * np.arange(n)[None, :, None]
    d = np.linalg.norm(line[:, :, None] - cloud[:, None].astype(np.float64), axis=-1).min(1)
    margin = np.abs(d - np.abs(e64 - s64).max(1)[:, None])
    clear = margin > 1e-5
    assert want[clear].any() and not want[clear].all()  # both sides of the radius occur
    np.testing.assert_array_equal(got[clear], want[clear])
