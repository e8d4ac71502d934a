"""bf16 mixed-precision training (``--mixed_precision 1``) of the port
against the JAX package on the CPU.

* Kernels: the port's bf16 plain versions (what the wrappers run on a CPU
  tensor, and what the bf16 CUDA kernels are held to on the card) against
  the JAX package's Pallas kernels run in interpret mode on bf16 inputs:
  the fused-MHA forward (plain, masked) and its ``jax.vjp`` backward
  (``_mha_bwd_body``), at one bf16 ulp of the output's largest magnitude
  (the two round at the same points and sum in another order).  With
  dropout, interpret mode runs JAX's emulation instead of the kernel
  (``_dropout_interpret_fwd`` / ``_bwd``, its mask from ``_emulated_keep``
  fed to the port through ``keep=``); it rounds the normalised weights
  where the kernel rounds the unnormalised ones, so the bound there is two
  bf16 ulps.  The single-head-layout core against ``attention_core`` in
  interpret mode at one ulp, and the three row scatters bit-exact.
* Models (the small widths of test_torch_train / test_torch_keypose_train):
  the dtype every submodule returns, exactly flax's under JAX's cast; the
  bf16 loss against JAX's bf16 loss (2e-2 relative, and no farther from
  JAX's float32 loss than JAX's bf16 loss is, plus 1e-2 relative); the bf16
  gradients against JAX's: float32, within cosine 0.99 / relative L2 5e-2
  as a whole, and per tensor cosine 0.99 where JAX's own bf16 gradient
  keeps cosine 0.999 to its float32 one.  Both sides round to bf16, but at
  other points: the port where the TPU kernels round (ds to bf16 before its
  products), JAX on the CPU in its XLA attention (ds float32); and Act3D's
  level-0 argmax picks among bf16 near-ties, which moves the fine context.
  Gradients that are sums of nearly cancelling terms (key biases under
  rotary codes) keep mostly rounding noise on either side, which is why
  the per-tensor bound is held where JAX's bf16 gradient is well
  determined and the whole gradient is held to 0.99 / 5e-2.
* The master state of a bf16 Trainer (float32 params, gradients, AdamW
  moments and ``.pt``; evaluation in float32), and top-k ties in JAX's
  order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu_torch.kernels import bf16_ulp
from act3d_tpu_torch.kernels.attention import (
    attention_core,
    fused_mha_backward_reference,
    fused_mha_forward,
    fused_mha_forward_reference,
)
from act3d_tpu_torch.kernels.gather import (
    scatter_rows,
    scatter_rows_chunked,
    scatter_rows_reference,
    scatter_rows_sorted,
)

BF16 = torch.bfloat16


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides: (torch bf16, jax bf16)."""
    return torch.from_numpy(x).to(BF16), jnp.asarray(x, jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulps(got, want, ulps=1):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=ulps * bf16_ulp(float(np.abs(want).max())))


def _attention_inputs(seed, b, l, s, e, heads, mask_kind):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, l, e)) * (e // heads) ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(b, s, e)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, l, e)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = rng.uniform(size=(b, s)) < 0.3
        mask[:, 0] = False
        if mask_kind == "full_row":
            mask[-1] = True
    return [_bf16(x) for x in (q, k, v, g)], mask


@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("b,l,s,e,heads", [(2, 37, 29, 60, 4), (1, 133, 53, 120, 8)])
def test_plain_bf16_forward_and_backward_match_pallas_kernels(b, l, s, e, heads, mask_kind):
    from act3d_tpu.kernels.attention import _fused_mha_fwd_impl, fused_mha

    ((q, jq), (k, jk), (v, jv), (g, jg)), mask = _attention_inputs(
        0, b, l, s, e, heads, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want_out, want_stats = _fused_mha_fwd_impl(jq, jk, jv, heads, jmask, 128, True)
    out, stats = fused_mha_forward(q, k, v, heads, tmask, return_stats=True)  # CPU: plain
    assert out.dtype == BF16 and stats.dtype == torch.float32
    _within_ulps(out, want_out)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats)[:, :l], atol=1e-5,
                               rtol=1e-5)
    _, vjp = jax.vjp(lambda a, c, d: fused_mha(a, c, d, heads, jmask, 128, True), jq, jk, jv)
    want = vjp(jg)
    got = fused_mha_backward_reference(q, k, v, out, stats, g, heads, tmask)
    for a, w in zip(got, want):
        assert a.dtype == BF16 and w.dtype == jnp.bfloat16
        _within_ulps(a, w)


@pytest.mark.parametrize("mask_kind", [None, "padded"])
def test_plain_bf16_dropout_matches_interpret_emulation(mask_kind):
    from act3d_tpu.kernels.attention import (
        _dropout_interpret_bwd,
        _dropout_interpret_fwd,
        _emulated_keep,
    )

    b, l, s, e, heads, rate, seed = 2, 21, 45, 60, 4, 0.25, 11
    ((q, jq), (k, jk), (v, jv), (g, jg)), mask = _attention_inputs(
        2, b, l, s, e, heads, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jseed = jnp.asarray([seed], jnp.int32)
    keep = torch.from_numpy(np.array(_emulated_keep(jseed, b, heads, l, s, rate)))
    out, stats = fused_mha_forward_reference(q, k, v, heads, tmask, rate, seed, keep=keep)
    _within_ulps(out, _dropout_interpret_fwd(jq, jk, jv, heads, jmask, rate, jseed), 2)
    got = fused_mha_backward_reference(q, k, v, out, stats, g, heads, tmask, rate, seed,
                                       keep=keep)
    want = _dropout_interpret_bwd(jq, jk, jv, jmask, jg, heads, rate, jseed)
    for a, w in zip(got, want):
        _within_ulps(a, w, 2)


def test_plain_bf16_rounds_where_the_kernel_rounds():
    """At bf16 the plain forward is ``_mha_fwd_body``'s formula written out
    (one head): the unnormalised weights rounded to bf16 before p v, the
    sum and the scale in float32, out rounded once; at float32 nothing is
    rounded."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 8)).astype(np.float32)).to(BF16)
               for n in (5, 9, 9))
    out, stats = fused_mha_forward_reference(q, k, v, 1)
    s = q[0].float() @ k[0].float().T
    ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = ex.sum(dim=-1, keepdim=True)
    want = ((ex.to(BF16).float() @ v[0].float()) * (1.0 / lsum)).to(BF16)
    assert torch.equal(out[0], want)
    torch.testing.assert_close(stats[0, :, 1:], lsum, atol=0, rtol=1e-6)
    out32, _ = fused_mha_forward_reference(q.float(), k.float(), v.float(), 1)
    torch.testing.assert_close(out32[0], (ex @ v[0].float()) * (1.0 / lsum), atol=1e-6,
                               rtol=1e-6)
    assert not torch.equal(out32[0].to(BF16), out[0])  # bf16 rounds ex; float32 does not


@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bf16_matches_pallas_kernel(masked):
    """The single-head-layout core at bf16: its plain forward against
    ``attention_core`` in interpret mode, and its jnp VJP through
    :class:`AttentionCore` on the CPU (the same casts)."""
    from act3d_tpu.kernels.attention import attention_core as jax_core

    rng = np.random.default_rng(5)
    bh, l, s, d = 6, 33, 40, 15
    (q, jq), (k, jk), (v, jv), (g, jg) = (
        _bf16((rng.normal(size=(bh, n, d)) * sc).astype(np.float32))
        for n, sc in ((l, d ** -0.5), (s, 1.0), (s, 1.0), (l, 1.0)))
    mask = rng.uniform(size=(bh, s)) < 0.3 if masked else None
    if masked:
        mask[:, 0] = False
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda a, b_, c: jax_core(a, b_, c, jmask, 128, True), jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_core(*leaves, None if mask is None else torch.from_numpy(mask))
    _within_ulps(out, want)
    out.backward(g)
    for leaf, w in zip(leaves, vjp(jg)):
        assert leaf.grad.dtype == BF16
        _within_ulps(leaf.grad, w)


@pytest.mark.parametrize("kernel", ["unsorted", "sorted", "chunked"])
def test_row_scatters_bf16_bit_exact(kernel):
    """bf16 cotangents through the three plain row scatters equal JAX's
    one-hot Pallas kernels in interpret mode bit for bit (each output row is
    one copy); no launch is counted on the CPU."""
    from act3d_tpu.kernels import gather as jg

    rng = np.random.default_rng(1)
    b, p, k, c = 2, 1024, 256, 60
    idx = np.stack([rng.permutation(p)[:k] for _ in range(b)])
    if kernel != "unsorted":
        idx = np.sort(idx, axis=-1)
    g, jgv = _bf16(rng.normal(size=(b, k, c)).astype(np.float32))
    jidx = jnp.asarray(idx.astype(np.int32))
    if kernel == "chunked":
        want = jg.onehot_scatter_rows_chunked(jgv, jidx, p, p_tile=128, n_chunks=4,
                                              interpret=True)
    else:
        fn = jg.onehot_scatter_rows if kernel == "unsorted" else jg.onehot_scatter_rows_sorted
        want = fn(jgv, jidx, p, p_tile=128, interpret=True)
    assert want.dtype == jnp.bfloat16
    wrapper = {"unsorted": scatter_rows, "sorted": scatter_rows_sorted,
               "chunked": scatter_rows_chunked}[kernel]
    before = wrapper.launches, wrapper.launches_bf16
    got = wrapper(g, torch.from_numpy(idx), p)
    assert (wrapper.launches, wrapper.launches_bf16) == before
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got, scatter_rows_reference(g, torch.from_numpy(idx), p))


def test_wrappers_reject_mixed_and_unsupported_dtypes():
    """q, k, v of several dtypes raise; the card's kernels take float32 and
    bf16 only (a float16 tensor on the card raises before any launch, which
    _check_cuda shows here without one)."""
    from act3d_tpu_torch.kernels import attention

    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="dtypes"):
        fused_mha_forward(q, q.to(BF16), q, 2)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        attention._check_cuda(None, 4, torch.float16, q=q.half(), k=q.half(), v=q.half())
    with pytest.raises(ValueError, match="beside q"):
        attention._check_cuda(None, 4, BF16, q=q.to(BF16), k=q, v=q.to(BF16))
    with pytest.raises(ValueError, match="stats"):
        attention._check_cuda(None, 4, BF16, q.to(BF16), q=q.to(BF16))


# ------------------------------------------------------------------ models
# Small widths: the configurations of tests/test_torch_train.py (64^2, 2
# cameras, emb 24, 3 query layers, trajectory 8) and
# tests/test_torch_keypose_train.py (128^2, 1 camera, emb 24, 2 levels,
# 20 ghost points per level), instructions on in both.
BF = jnp.bfloat16
PLANNER_CFG = dict(image_size=(64, 64), embedding_dim=24, output_dim=7,
                   num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
                   use_instruction=True, use_goal=True, use_goal_at_test=False,
                   diffusion_timesteps=10)
PLANNER_KEYS = ("trajectory", "trajectory_mask", "rgbs", "pcds", "instr", "curr_gripper",
                "action")
ACT3D_CFG = dict(image_size=(128, 128), embedding_dim=24, num_attn_heads=4,
                 num_sampling_level=2, use_instruction=True, num_ghost_points=40,
                 num_ghost_points_val=60)
ACT3D_KEYS = ("rgbs", "pcds", "instr", "curr_gripper")
N_GHOST, LEVELS, BATCH = 20, 2, 2


def _planner_batch(seed):
    from act3d_tpu_torch.utils.testing import synthetic_trajectory_batch

    batch = synthetic_trajectory_batch(BATCH, 2, (64, 64), 8, seed=seed)
    batch["instr"] = batch["instr"][:, :7]
    batch["trajectory_mask"][1, -3:] = True
    batch["trajectory"][1, -3:] = 0.0
    return {k: v.numpy() for k, v in batch.items()}


def _act3d_batch(seed):
    from act3d_tpu_torch.utils.testing import BOUNDS

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)

    def pose8():
        q = rng.normal(size=(BATCH, 4))
        return np.concatenate([rng.uniform(lo + 0.1, hi - 0.1, (BATCH, 3)),
                               q / np.linalg.norm(q, axis=-1, keepdims=True),
                               rng.integers(0, 2, (BATCH, 1))], axis=-1).astype(np.float32)

    pcd = rng.uniform(lo, hi, (BATCH, 1, 128, 128, 3)).astype(np.float32)
    return {"rgbs": rng.uniform(0, 1, (BATCH, 1, 3, 128, 128)).astype(np.float32),
            "pcds": np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3)),
            "instr": rng.normal(size=(BATCH, 7, 512)).astype(np.float32),
            "curr_gripper": pose8(), "action": pose8()}


@pytest.fixture(scope="module")
def models():
    """{kind: (JAX model, params as jax arrays, port model, numpy batch)};
    the params are device arrays as in JAX's Trainer (numpy leaves would
    promote the frozen batch norms' bf16 arithmetic to float32)."""
    from act3d_tpu.models import Act3D as JAct3D
    from act3d_tpu.models import DiffusionPlanner as JDiffusionPlanner
    from act3d_tpu_torch.convert import act3d_from_flax, diffusion_planner_from_flax
    from act3d_tpu_torch.models import Act3D, DiffusionPlanner
    from act3d_tpu_torch.utils.testing import BOUNDS

    from tests.torch_parity import random_params

    out = {}
    batch = _planner_batch(1)
    jm = JDiffusionPlanner(**PLANNER_CFG, gripper_loc_bounds=BOUNDS)
    params = random_params(jm, 21, *(batch[k] for k in PLANNER_KEYS),
                           noise_rng=jax.random.PRNGKey(0))
    port = DiffusionPlanner(**PLANNER_CFG, gripper_loc_bounds=BOUNDS, device="cpu")
    port.load_state_dict(diffusion_planner_from_flax(params), strict=True)
    out["diffusion"] = (jm, jax.tree.map(jnp.asarray, params), port, batch)
    batch = _act3d_batch(3)
    jm = JAct3D(**ACT3D_CFG, gripper_loc_bounds=BOUNDS)
    params = random_params(jm, 31, *(batch[k] for k in ACT3D_KEYS),
                           sample_rng=jax.random.PRNGKey(0), gt_action=batch["action"])
    port = Act3D(**ACT3D_CFG, gripper_loc_bounds=BOUNDS, device="cpu")
    port.load_state_dict(act3d_from_flax(params), strict=True)
    out["keypose"] = (jm, jax.tree.map(jnp.asarray, params), port, batch)
    return out


def _draws(kind, key):
    """The port's injected draws for JAX's key schedule: the DDPM noise and
    timesteps of ``DiffusionPlanner.__call__``, or the ghost-point uniforms
    of ``Act3D.__call__`` (``split(sample_rng, levels)``)."""
    if kind == "diffusion":
        k_noise, k_time = jax.random.split(key)
        return dict(noise=torch.from_numpy(np.array(
                        jax.random.normal(k_noise, (BATCH, 8, 9), dtype=jnp.float32))),
                    timesteps=torch.from_numpy(np.array(
                        jax.random.randint(k_time, (BATCH,), 0, 10))))
    rngs = jax.random.split(key, LEVELS)
    return dict(ghost_uniforms=[torch.from_numpy(np.array(jax.random.uniform(
        rngs[i], (BATCH, N_GHOST * (1 if i == 0 else 4), 3), dtype=jnp.float32)))
        for i in range(LEVELS)])


def _jax_forward(kind, jm, params, batch, key, capture=False):
    """JAX's bf16 forward as its flagship loss functions run it: params and
    the model inputs through ``_cast_tree`` (Act3D's ``gt_action`` uncast),
    deterministic (the planner's dropout off; Act3D has none)."""
    from act3d_tpu.train.flagship import _cast_tree

    keys = PLANNER_KEYS if kind == "diffusion" else ACT3D_KEYS
    args = [jnp.asarray(batch[k]) if k == "trajectory_mask"
            else _cast_tree(jnp.asarray(batch[k]), BF) for k in keys]
    kwargs = (dict(noise_rng=key, deterministic=True) if kind == "diffusion" else
              dict(sample_rng=key, gt_action=jnp.asarray(batch["action"]), train_mode=True))
    if capture:
        kwargs.update(capture_intermediates=True, mutable=["intermediates"])
    return jm.apply({"params": _cast_tree(params, BF)}, *args, **kwargs)


def _port_forward(kind, port, batch, draws):
    from act3d_tpu_torch.train.flagship import diffusion_loss, keypose_pred

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if kind == "diffusion":
        return diffusion_loss(port.eval(), tbatch, None, BF16, **draws)
    return keypose_pred(port.train(), tbatch, None, True, BF16, **draws)


def _flat_dtypes(out):
    if isinstance(out, torch.Tensor):
        return [str(out.dtype).replace("torch.", "")]
    if isinstance(out, dict):
        return [d for k in sorted(out) for d in _flat_dtypes(out[k])]
    if isinstance(out, (list, tuple)):
        return [d for x in out for d in _flat_dtypes(x)]
    return []


@pytest.mark.parametrize("kind", ["diffusion", "keypose"])
def test_dtype_trace_matches_jax(models, kind):
    """Under bf16 every submodule of the port returns the dtypes its flax
    counterpart returns (the same names: convert.py maps them leaf by
    leaf), call by call: where JAX's promotion turns bf16 into float32 and
    back, the port casts alike."""
    jm, params, port, batch = models[kind]
    key = jax.random.PRNGKey(3)
    _, state = _jax_forward(kind, jm, params, batch, key, capture=True)
    want = {}

    def walk(node, path):
        for name, value in node.items():
            if name == "__call__":
                want["/".join(path)] = [str(leaf.dtype) for call in value
                                        for leaf in jax.tree_util.tree_leaves(call)]
            elif isinstance(value, dict):
                walk(value, path + [name])

    walk(state["intermediates"], [])
    got = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name.replace(".", "/"):
        got.setdefault(name, []).extend(_flat_dtypes(out)))
        for name, m in port.named_modules() if name]
    try:
        _port_forward(kind, port, batch, _draws(kind, key))
    finally:
        for h in hooks:
            h.remove()
    assert set(got) <= set(want), sorted(set(got) - set(want))
    assert len(got) > 150, len(got)
    assert {name: got[name] for name in got} == {name: want[name] for name in got}
    assert sum("bfloat16" in d for d in got.values()) > 150  # the run is bf16


def _jax_loss_fn(kind, jm, compute_dtype):
    """(params, batch, key) -> (float32 loss, sample key): JAX's flagship
    keypose_loss_fn as it is; for the planner the same cast and call with
    deterministic=True (the flagship function's dropout draws from JAX's
    RNG, which the port cannot reproduce), at compute_dtype bf16 or None."""
    from act3d_tpu.train import losses as jlosses
    from act3d_tpu.train.flagship import _cast_tree, keypose_loss_fn

    if kind == "keypose":
        loss_fn = keypose_loss_fn(jm, jlosses.KeyposeLossAndMetrics(), compute_dtype)
        return lambda p, batch, key: loss_fn(p, batch, key)[0]

    def loss_fn(p, batch, key):
        args = [batch[k] if k == "trajectory_mask" else _cast_tree(batch[k], compute_dtype)
                for k in PLANNER_KEYS]
        loss = jm.apply({"params": _cast_tree(p, compute_dtype)}, *args, noise_rng=key,
                        deterministic=True)
        return loss.astype(jnp.float32)

    return loss_fn


def _port_loss(kind, port, batch, key):
    from act3d_tpu_torch.train import losses

    if kind == "diffusion":
        return _port_forward(kind, port, batch, _draws(kind, key))
    sample_key, _ = jax.random.split(key)  # keypose_loss_fn's sample_rng
    pred = _port_forward(kind, port, batch, _draws(kind, sample_key))
    action = torch.from_numpy(batch["action"])
    return sum(losses.KeyposeLossAndMetrics().compute_loss(pred, action).values())


@pytest.mark.parametrize("kind", ["diffusion", "keypose"])
def test_bf16_loss_and_gradients_match_jax(models, kind):
    """The port's bf16 loss and gradients against JAX's (JAX's cast, the
    same draws).  The loss: within 2e-2 relative of JAX's bf16 loss, and no
    farther from JAX's float32 loss than JAX's own bf16 loss is, plus 1e-2
    relative.  The gradients: float32 for every trained parameter, one
    wherever JAX's is nonzero; the whole trained gradient (every trained
    parameter's, concatenated) within cosine similarity 0.99 and relative
    L2 distance 5e-2 of JAX's bf16 gradient; and cosine similarity >= 0.99
    for every parameter whose bf16 gradient JAX itself keeps at cosine
    >= 0.999 to its float32 one.  Both round to bf16 but at other points
    (the port where the TPU kernels round, JAX on the CPU in its XLA
    attention: ds stays float32 there, and the key-bias gradients, sums of
    nearly cancelling terms, keep only noise in either), and Act3D's
    level-0 argmax among bf16 near-ties picks the fine context; so single
    gradients of cancelling sums differ by rounding noise as JAX's own
    bf16 and float32 gradients do: on these widths with random weights,
    JAX's own bf16 gradient of a ghost-point embedding lies at cosine ~0.7
    from its float32 one, so a per-tensor bound holds only where JAX's
    bf16 gradient is itself well determined."""
    from act3d_tpu_torch.convert import act3d_from_flax, diffusion_planner_from_flax

    jm, params, port, batch = models[kind]
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = {}
    for dtype in (BF, None):
        value, grads[dtype] = jax.jit(jax.value_and_grad(_jax_loss_fn(kind, jm, dtype)))(
            params, jbatch, key)
        grads[dtype] = jax.device_get(grads[dtype])
        if dtype is None:
            want_f32 = float(value)
        else:
            want_bf16 = float(value)
    port.zero_grad(set_to_none=True)
    loss = _port_loss(kind, port, batch, key)
    assert loss.dtype == torch.float32
    loss.backward()
    got = loss.item()
    np.testing.assert_allclose(got, want_bf16, rtol=2e-2)
    assert abs(got - want_f32) <= abs(want_bf16 - want_f32) + 1e-2 * abs(want_f32), (
        got, want_bf16, want_f32)

    convert = diffusion_planner_from_flax if kind == "diffusion" else act3d_from_flax
    want, want32 = convert(grads[BF]), convert(grads[None])

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()

    got_all, want_all, conditioned = [], [], 0
    for name, param in port.named_parameters():
        if "backbone" in name:
            continue
        w, w32 = want[name].double(), want32[name].double()
        if param.grad is None:  # unused here (FPN levels of other scales)
            assert not w.any(), name
            continue
        assert param.dtype == param.grad.dtype == torch.float32, name
        g = param.grad.double()
        assert torch.isfinite(g).all(), name
        got_all.append(g.flatten())
        want_all.append(w.flatten())
        if cos(w, w32) >= 0.999:
            assert cos(g, w) >= 0.99, (name, cos(g, w))
            conditioned += 1
    assert len(got_all) > 50 and conditioned > 10, (len(got_all), conditioned)
    g, w = torch.cat(got_all), torch.cat(want_all)
    assert cos(g, w) >= 0.99 and ((g - w).norm() / w.norm()).item() <= 5e-2, (
        cos(g, w), ((g - w).norm() / w.norm()).item())


def test_bf16_trainer_keeps_float32_master_state(models, tmp_path):
    """Under compute_dtype bf16 the Trainer's master state stays float32:
    the parameters and their accumulated gradients after a micro-batch,
    AdamW's moments after the step, a ``.pt`` round trip; the frozen
    backbone does not move; evaluation runs in float32 (every submodule
    returns float32 there, as JAX's metric functions apply the uncast
    params)."""
    from act3d_tpu_torch.convert import diffusion_planner_from_flax
    from act3d_tpu_torch.models import DiffusionPlanner
    from act3d_tpu_torch.train.engine import Trainer
    from act3d_tpu_torch.train.flagship import diffusion_loss_fn, diffusion_metrics_fn
    from act3d_tpu_torch.utils.testing import BOUNDS

    _, params, _, batch = models["diffusion"]

    def fresh():
        model = DiffusionPlanner(**PLANNER_CFG, gripper_loc_bounds=BOUNDS, device="cpu")
        model.load_state_dict(diffusion_planner_from_flax(jax.device_get(params)))
        return model, Trainer(diffusion_loss_fn(model, BF16), model,
                              metrics_fn=diffusion_metrics_fn(model), lr=1e-3,
                              accumulate_grad_batches=2, seed=5)

    model, trainer = fresh()
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = trainer.step(tbatch)  # the first micro-batch: gradients kept
    assert out["loss"].dtype == torch.float32 and torch.isfinite(out["loss"])
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert len(trained) > 100 and all("backbone" not in n for n, _ in trained)
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for n, p in trained
               if "feature_pyramid" not in n)
    trainer.step(tbatch)  # the optimizer step
    state = trainer.optimizer.state_dict()["state"]
    assert state and all(v.dtype == torch.float32 for st in state.values()
                         for v in st.values() if torch.is_tensor(v) and v.is_floating_point())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        if "backbone" in name:
            assert torch.equal(p, before[name]), name

    trainer.save_checkpoint(tmp_path, new_loss=1.0)
    payload = torch.load(tmp_path / "last.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in payload["model"].values()
               if v.is_floating_point())
    model2, trainer2 = fresh()
    trainer2.load_checkpoint(tmp_path / "last.pt")
    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert b.dtype == a.dtype and torch.equal(a, b), name

    dtypes = set()
    hooks = [m.register_forward_hook(lambda mod, args, o: dtypes.update(_flat_dtypes(o)))
             for m in model2.modules()]
    try:
        metrics = trainer2.evaluate([tbatch])
    finally:
        for h in hooks:
            h.remove()
    assert np.isfinite(metrics["noise_mse"]) and dtypes == {"float32"}, dtypes


def test_topk_ties_pick_jax_indices():
    """Equal distances (points whose coordinates round to the same bf16
    values) come in index order, as ``lax.top_k`` returns them, and the
    selection at the k-th place keeps the lower indices."""
    from act3d_tpu.ops.geometry import topk_nearest_context as jax_topk
    from act3d_tpu_torch.ops.geometry import topk_nearest_context

    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.0, 1.0, (2, 300, 3)).astype(np.float32)
    cloud = np.asarray(torch.from_numpy(cloud).to(BF16).float())[:, rng.integers(0, 40, 300)]
    anchor = rng.uniform(0.0, 1.0, (2, 3)).astype(np.float32)
    d2 = ((anchor[:, None] - cloud) ** 2).sum(-1)
    assert all(len(np.unique(row)) < 50 for row in d2)  # many exact ties
    for k in (1, 7, 64, 100):
        want = np.asarray(jax_topk(jnp.asarray(anchor), jnp.asarray(cloud), k))
        got = topk_nearest_context(torch.from_numpy(anchor), torch.from_numpy(cloud), k)
        np.testing.assert_array_equal(got.numpy(), want)
