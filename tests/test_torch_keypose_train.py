"""The Act3D keypose training step of the port against the JAX package on
the CPU.

Small configuration: 128^2 images, 1 camera, emb 24, 2 pyramid levels, 20
training ghost points per level, instructions on, batch 2.  At 128^2 the
fine level holds 64*64 points and the top-k context keeps 32*32 of them, so
the sorted fine-context gather and its adjoint do real work (at 64^2 the
context would be every point).  Ghost points are drawn in training mode,
the fine balls centred on the ground-truth position; the uniforms JAX's key
schedule draws (``split(sample_rng, levels)``, one ``uniform`` per level)
are injected into the port.  Every level's top-2 mask margin is asserted to
exceed twice the port's error on it, so the argmax positions (which pick
the next level's context) must agree exactly and a flip shows as a flip;
the seeds give margins of 1e-4 and more against errors near 1e-5 (nearby
fine ghost points have nearly equal masks).  Tolerances: 1e-3
for masks and outputs (the full-model bound of tests/README.md), 1e-6 for
the loss arithmetic on given predictions, atol 1e-4 / rtol 1e-3 for the loss
and every non-backbone gradient (as tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.models import Act3D as JAct3D
from act3d_tpu.train import losses as jlosses
from act3d_tpu.train.flagship import keypose_loss_fn as jax_keypose_loss_fn
from act3d_tpu.utils.testing import synthetic_keypose_batch as jax_keypose_batch
from act3d_tpu_torch.convert import act3d_from_flax
from act3d_tpu_torch.models import Act3D
from act3d_tpu_torch.train import losses
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import keypose_loss_fn, keypose_metrics_fn
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_keypose_batch

from tests.torch_parity import close, random_params, t

TOL = 1e-3
NCAM, IMAGE, N_INSTR, BATCH, LEVELS, N_TRAIN = 1, 128, 7, 2, 2, 40
KEYS = ("rgbs", "pcds", "instr", "curr_gripper")


def _cfg(regress):
    return dict(image_size=(IMAGE, IMAGE), embedding_dim=24, num_attn_heads=4,
                num_sampling_level=LEVELS, use_instruction=True, num_ghost_points=N_TRAIN,
                num_ghost_points_val=60, gripper_loc_bounds=BOUNDS,
                regress_position_offset=regress)


def _batch(seed):
    """A keypose batch whose cloud and targets lie in the workspace."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)

    def pose8():
        q = rng.normal(size=(BATCH, 4))
        return np.concatenate([rng.uniform(lo + 0.1, hi - 0.1, (BATCH, 3)),
                               q / np.linalg.norm(q, axis=-1, keepdims=True),
                               rng.integers(0, 2, (BATCH, 1))], axis=-1).astype(np.float32)

    pcd = rng.uniform(lo, hi, (BATCH, NCAM, IMAGE, IMAGE, 3)).astype(np.float32)
    return {
        "rgbs": rng.uniform(0, 1, (BATCH, NCAM, 3, IMAGE, IMAGE)).astype(np.float32),
        "pcds": np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3)),
        "instr": rng.normal(size=(BATCH, N_INSTR, 512)).astype(np.float32),
        "curr_gripper": pose8(),
        "action": pose8(),
    }


def _uniforms(sample_rng, n_ghost):
    """The uniforms JAX's samplers draw in Act3D.__call__."""
    rngs = jax.random.split(sample_rng, LEVELS)
    return [t(jax.random.uniform(rngs[i], (BATCH, n_ghost * (1 if i == 0 else 4), 3),
                                 dtype=jnp.float32)) for i in range(LEVELS)]


@pytest.fixture(scope="module")
def models():
    batch = _batch(0)
    out = {}
    for regress in (False, True):
        jm = JAct3D(**_cfg(regress))
        params = random_params(jm, 31 + regress, *(batch[k] for k in KEYS),
                               sample_rng=jax.random.PRNGKey(0), gt_action=batch["action"])
        out[regress] = (jm, params)
    return out


def _port(params, regress):
    port = Act3D(**_cfg(regress), device="cpu")
    port.load_state_dict(act3d_from_flax(params), strict=True)
    return port


def _assert_margins(got_pyramid, want_pyramid):
    """Each level's top-2 margin of JAX's last mask exceeds twice the port's
    largest error on that mask, so neither side's argmax can differ from
    the other's (a flip would need the two top values to move by more than
    the margin together)."""
    for got, want in zip(got_pyramid, want_pyramid):
        want = np.asarray(want[-1])
        err = np.abs(got[-1].detach().numpy() - want).max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 2 * err).all(), (top2, err)


@pytest.mark.parametrize("regress", [False, True])
def test_training_forward_matches_jax(models, regress):
    jm, params = models[regress]
    batch = _batch(3)
    key = jax.random.PRNGKey(2)
    want = jax.jit(lambda p: jm.apply(
        {"params": p}, *(batch[k] for k in KEYS), sample_rng=key,
        gt_action=batch["action"], train_mode=True))(params)
    port = _port(params, regress).train()
    with torch.no_grad():
        got = port(*(t(batch[k]) for k in KEYS), gt_action=t(batch["action"]),
                   ghost_uniforms=_uniforms(key, N_TRAIN // LEVELS))
    _assert_margins(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"])
    gt = batch["action"][:, None, :3]
    for i, (g, w) in enumerate(zip(got["ghost_pcd_pyramid"], want["ghost_pcd_pyramid"])):
        assert g.shape == (BATCH, N_TRAIN // LEVELS, 3)
        close(g, w, 1e-6)
        if i:  # the fine ball is centred on the ground truth
            assert (np.linalg.norm(g.numpy() - gt, axis=-1) < 0.08 + 1e-6).all()
    for g, w in zip(got["position_pyramid"], want["position_pyramid"]):
        close(g, w, 1e-6)  # the same ghost point, up to the sampler's last ulp
    for g_level, w_level in zip(got["ghost_pcd_masks_pyramid"],
                                want["ghost_pcd_masks_pyramid"]):
        for g, w in zip(g_level, w_level):
            close(g, w, TOL, TOL)
    if regress:
        close(got["fine_ghost_pcd_offsets"], want["fine_ghost_pcd_offsets"], TOL, TOL)
        assert not torch.equal(got["position"], got["position_pyramid"][-1])
    else:
        assert got["fine_ghost_pcd_offsets"] is None and want["fine_ghost_pcd_offsets"] is None
    close(got["position"], want["position"], TOL)
    close(got["rotation"], want["rotation"], TOL)
    close(got["gripper"], want["gripper"], TOL)


def _pred(seed, offsets):
    rng = np.random.default_rng(seed)
    n = 30
    q = rng.normal(size=(BATCH, 4))
    pred = {
        "ghost_pcd_masks_pyramid": [[rng.normal(size=(BATCH, n)) * 3 for _ in range(2)]
                                    for _ in range(3)],
        "ghost_pcd_pyramid": [rng.uniform(-0.5, 1.5, (BATCH, n, 3)) for _ in range(3)],
        "position": rng.uniform(-0.5, 1.5, (BATCH, 3)),
        "rotation": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "gripper": rng.uniform(0, 1, (BATCH, 1)),
        "fine_ghost_pcd_offsets": rng.normal(size=(BATCH, n, 3)) * 0.01 if offsets else None,
    }
    pred["position_pyramid"] = [pred["position"] + 0.01 * i for i in range(3)]
    pred = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), pred)
    action = np.concatenate([rng.uniform(-0.5, 1.5, (BATCH, 3)), -pred["rotation"] + 0.01,
                             [[1.0], [0.0]]], axis=-1).astype(np.float32)
    return pred, action


@pytest.mark.parametrize("options,offsets", [
    (dict(), False),
    (dict(position_loss="ce+mse", compute_loss_at_all_layers=True, label_smoothing=0.1,
          symmetric_rotation_loss=True), True),
    (dict(position_loss="mse", rotation_parametrization="6D"), False),
])
def test_loss_and_metrics_match_jax(options, offsets):
    pred, action = _pred(5, offsets)
    jc = jlosses.KeyposeLossAndMetrics(**options)
    pc = losses.KeyposeLossAndMetrics(**options)
    tpred = jax.tree_util.tree_map(t, pred)
    for j_fn, p_fn in ((jc.compute_loss, pc.compute_loss),
                       (jc.compute_metrics, pc.compute_metrics)):
        want = j_fn(jax.tree_util.tree_map(jnp.asarray, pred), jnp.asarray(action))
        got = p_fn(tpred, t(action))
        assert list(got) == list(want)
        for name in want:
            close(got[name], want[name], 1e-6, 1e-6)
    tasks = ["a", "b"]
    metrics = pc.compute_metrics(tpred, t(action))
    want = jlosses.split_metrics_by_task(jc.compute_metrics(pred, action), tasks)
    got = losses.split_metrics_by_task(metrics, tasks)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)


def test_loss_and_gradients_match_jax(models):
    jm, params = models[False]
    batch = _batch(3)
    criterion = losses.KeyposeLossAndMetrics()
    rng = jax.random.PRNGKey(3)
    loss_fn = jax_keypose_loss_fn(jm, jlosses.KeyposeLossAndMetrics())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_aux), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, rng)
    sample_rng, _ = jax.random.split(rng)
    pred = jax.jit(lambda p: jm.apply(
        {"params": p}, *(jbatch[k] for k in KEYS), sample_rng=sample_rng,
        gt_action=jbatch["action"], train_mode=True))(params)
    port = _port(params, False).train()
    got = port(*(t(batch[k]) for k in KEYS), gt_action=t(batch["action"]),
               ghost_uniforms=_uniforms(sample_rng, N_TRAIN // LEVELS))
    _assert_margins(got["ghost_pcd_masks_pyramid"], pred["ghost_pcd_masks_pyramid"])
    for g, w in zip(got["position_pyramid"], pred["position_pyramid"]):
        close(g, w, 1e-6)  # no argmax flip: the same fine context on both sides
    got_losses = criterion.compute_loss(got, t(batch["action"]))
    assert sorted(got_losses) == sorted(want_aux)  # jit returns the aux dict key-sorted
    for name, value in got_losses.items():
        close(value, want_aux[name], 1e-4, 1e-4)
    loss = sum(got_losses.values())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)

    want = act3d_from_flax(jax.device_get(want_grads))
    checked = 0
    for name, param in port.named_parameters():
        if "backbone" in name:
            continue
        if param.grad is None:  # unused here (FPN levels of other scales)
            assert not want[name].any(), name
            continue
        close(param.grad, want[name].numpy(), 1e-4, 1e-3)
        checked += 1
    assert checked > 50, checked
    # the fine-level gradient reached the FPN through the gather adjoint
    assert port.visual.feature_pyramid.layer_res1.weight.grad.abs().sum() > 0


def test_synthetic_keypose_batch_is_jax_s():
    want = jax_keypose_batch(2, 2, (32, 32), seed=7)
    got = synthetic_keypose_batch(2, 2, (32, 32), seed=7)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trainer_step_and_evaluate(models):
    _, params = models[True]
    model = _port(params, True)
    criterion = losses.KeyposeLossAndMetrics()
    trainer = Trainer(keypose_loss_fn(model, criterion), model,
                      metrics_fn=keypose_metrics_fn(model, criterion), lr=1e-3, seed=3)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = {k: t(v) for k, v in _batch(5).items()}
    out = trainer.step(batch)
    assert torch.isfinite(out["loss"]) and {"position_offset", "rotation"} <= out.keys()
    changed = 0
    for name, p in model.named_parameters():
        if "backbone" in name:
            assert torch.equal(p, before[name]), name
        else:
            changed += not torch.equal(p, before[name])
    assert changed > 50, changed

    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append(
        out["ghost_pcd_pyramid"][0].shape[1]))
    metrics = trainer.evaluate([batch])
    assert not model.training and seen == [60 // LEVELS]  # num_ghost_points_val
    assert all(np.isfinite(v) for v in metrics.values()) and "pos_l2_level1" in metrics
