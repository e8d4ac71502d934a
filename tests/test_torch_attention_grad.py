"""Fused-MHA backward and attention dropout of the port against the JAX
package's Pallas kernels, on the CPU.

* Rate 0: the port's plain backward (``fused_mha_backward_reference``,
  what the wrapper runs on a CPU tensor) against ``jax.vjp`` of
  ``act3d_tpu.kernels.attention.fused_mha`` in interpret mode (the Pallas
  backward ``_mha_bwd_body``), and against torch autograd of the plain
  forward; atol/rtol 1e-5 (two float32 softmax-matmul chains).
* Rate > 0: JAX's interpret-mode emulation draws its keep mask from
  ``jax.random`` (``_emulated_keep``); that mask is fed to the port's plain
  forward and backward through ``keep=`` and both are held against
  ``_dropout_interpret_fwd`` / ``_dropout_interpret_bwd`` at 1e-5.
* The port's own hash mask: keep fraction, seeds, determinism, the
  linearity identity <dv, v> == <g, out>, and pinned bits.
* On the card (``-m gpu``): both CUDA kernels against their plain versions.

JAX and the JAX package are imported inside the tests that use them, so the
gpu-marked tests also run where neither is installed:

    python -m pytest --noconftest tests/test_torch_attention_grad.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels import attention
from act3d_tpu_torch.kernels.attention import (
    BwdPlan,
    FusedMHA,
    bwd_plan,
    dropout_bits,
    dropout_keep,
    fused_mha_backward,
    fused_mha_backward_reference,
    fused_mha_forward,
    fused_mha_forward_reference,
)

TOL = 1e-5


# This file also runs on the card, where another installed package may own
# the name ``tests``; so it keeps its own copies of the two parity helpers.
def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=atol, rtol=rtol)


def _inputs(seed, b, l, s, e, heads, mask_kind):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, l, e)) * (e // heads) ** -0.5).astype(np.float32)
    k = rng.normal(size=(b, s, e)).astype(np.float32)
    v = rng.normal(size=(b, s, e)).astype(np.float32)
    g = rng.normal(size=(b, l, e)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = rng.uniform(size=(b, s)) < 0.3
        mask[:, 0] = False  # every row keeps a key
        if mask_kind == "full_row":
            mask[-1] = True  # the last batch row has every key masked
    return q, k, v, g, mask


def _port_grads(q, k, v, g, heads, mask, rate=0.0, seed=None, keep=None):
    mask_t = None if mask is None else t(mask)
    out, stats = fused_mha_forward_reference(t(q), t(k), t(v), heads, mask_t, rate, seed,
                                             keep=keep)
    grads = fused_mha_backward_reference(t(q), t(k), t(v), out, stats, t(g), heads, mask_t,
                                         rate, seed, keep=keep)
    return out, grads


CASES = [
    (2, 37, 29, 60, 4),  # head dim 15
    (1, 133, 53, 12, 4),  # head dim 3, L ragged against the 128 tile
]


@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("b,l,s,e,heads", CASES)
def test_plain_backward_matches_pallas_vjp(b, l, s, e, heads, mask_kind):
    import jax
    import jax.numpy as jnp
    from act3d_tpu.kernels.attention import fused_mha

    q, k, v, g, mask = _inputs(0, b, l, s, e, heads, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    want_out, vjp = jax.vjp(lambda q, k, v: fused_mha(q, k, v, heads, jmask, 128, True),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, got = _port_grads(q, k, v, g, heads, mask)
    close(out, want_out, TOL, TOL)
    for a, w in zip(got, want):
        close(a, w, TOL, TOL)


@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("b,l,s,e,heads", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(b, l, s, e, heads, mask_kind):
    """Away from fully masked rows the kernel formula is the exact gradient.
    On a fully masked row masked_fill makes every score a constant, so
    autograd gives dq = 0 and dk = 0 there, while the kernel formula (the
    TPU kernel's, held by the test above) keeps ds = p (dp - delta); dv
    agrees in both."""
    q, k, v, g, mask = _inputs(1, b, l, s, e, heads, mask_kind)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out, _ = fused_mha_forward_reference(qt, kt, vt, heads, None if mask is None else t(mask))
    want = torch.autograd.grad(out, (qt, kt, vt), t(g))
    _, got = _port_grads(q, k, v, g, heads, mask)
    if mask_kind == "full_row":
        got = [x[:-1] for x in got[:2]] + [got[2]]
        want = [x[:-1] for x in want[:2]] + [want[2]]
    for a, w in zip(got, want):
        close(a, w, TOL, TOL)


@pytest.mark.parametrize("mask_kind", [None, "padded"])
@pytest.mark.parametrize("b,l,s,e,heads", [(2, 21, 45, 60, 4), (2, 16, 33, 120, 8)])
def test_dropout_with_jax_mask_matches_interpret_emulation(b, l, s, e, heads, mask_kind):
    import jax.numpy as jnp
    from act3d_tpu.kernels.attention import (
        _dropout_interpret_bwd,
        _dropout_interpret_fwd,
        _emulated_keep,
    )

    rate, seed = 0.25, 11
    q, k, v, g, mask = _inputs(2, b, l, s, e, heads, mask_kind)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = jnp.asarray([seed], jnp.int32)
    keep = t(_emulated_keep(jseed, b, heads, l, s, rate))
    want_out = _dropout_interpret_fwd(jq, jk, jv, heads, jmask, rate, jseed)
    want = _dropout_interpret_bwd(jq, jk, jv, jmask, jg, heads, rate, jseed)
    out, got = _port_grads(q, k, v, g, heads, mask, rate, seed, keep=keep)
    close(out, want_out, TOL, TOL)
    for a, w in zip(got, want):
        close(a, w, TOL, TOL)


def test_keep_fraction_and_seeds():
    keep = dropout_keep(7, 4, 8, 64, 300, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    assert not torch.equal(keep, dropout_keep(8, 4, 8, 64, 300, 0.1))
    assert torch.equal(keep, dropout_keep(7, 4, 8, 64, 300, 0.1))
    # the mask is a function of absolute coordinates: a sub-shape is a slice
    assert torch.equal(dropout_keep(7, 2, 3, 10, 20, 0.1), keep[:2, :3, :10, :20])


def test_same_seed_same_outputs_other_seed_other_outputs():
    q, k, v, g, mask = _inputs(3, 2, 24, 30, 16, 2, "padded")
    runs = [_port_grads(q, k, v, g, 2, mask, 0.3, seed) for seed in (5, 5, 6)]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])


def test_dropout_gradients_use_the_forward_mask():
    """out is linear in v for a fixed mask, so <dv, v> == <g, out>; dq and
    dk against directional finite differences of the seeded forward."""
    b, heads, l, s, e = 2, 2, 24, 30, 16
    rate, seed = 0.25, 11
    q, k, v, g, mask = _inputs(4, b, l, s, e, heads, "padded")
    q, k, v, g, mask = (t(x) for x in (q, k, v, g, mask))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = FusedMHA.apply(qt, kt, vt, heads, mask, rate, seed)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), g)
    np.testing.assert_allclose(float((dv * v).sum()), float((g * out.detach()).sum()),
                               rtol=1e-5)

    def f(q, k):
        return float((fused_mha_forward(q, k, v, heads, mask, dropout_rate=rate,
                                        dropout_seed=seed) * g).sum())

    rng = np.random.default_rng(5)
    for grad, name in ((dq, "q"), (dk, "k")):
        u = torch.from_numpy(rng.normal(size=grad.shape).astype(np.float32))
        eps = 1e-3
        args = {"q": lambda x: (x, k), "k": lambda x: (q, x)}[name]
        x0 = q if name == "q" else k
        fd = (f(*args(x0 + eps * u)) - f(*args(x0 - eps * u))) / (2 * eps)
        np.testing.assert_allclose(float((grad * u).sum()), fd, rtol=5e-3, err_msg=name)


def test_hash_bits_are_pinned():
    """Literal bits of csrc/dropout_hash.cuh for fixed (seed, b, h, row,
    col): the plain version, and any later kernel, must keep them."""
    pinned = {
        (0, 0, 0, 0, 0): 4125828455,
        (1, 0, 0, 0, 1): 189243150,
        (2147483646, 15, 7, 3071, 52): 1652205840,
        (12345, 1, 2, 3, 4): 4161946152,
        (987654321, 0, 5, 49, 3073): 2251171186,
    }
    for (seed, b, h, row, col), bits in pinned.items():
        got = dropout_bits(seed, b + 1, h + 1, row + 1, col + 1)[b, h, row, col]
        assert int(got) == bits, (seed, b, h, row, col)


def test_cpu_backward_takes_the_plain_version_and_counts_no_launch():
    q, k, v, g, mask = _inputs(5, 1, 5, 7, 12, 4, "padded")
    args = [t(x) for x in (q, k, v)]
    out, stats = fused_mha_forward(*args, 4, t(mask), return_stats=True, dropout_rate=0.1,
                                   dropout_seed=3)
    before = fused_mha_backward.launches
    got = fused_mha_backward(*args, out, stats, t(g), 4, t(mask), 0.1, 3)
    want = fused_mha_backward_reference(*args, out, stats, t(g), 4, t(mask), 0.1, 3)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert fused_mha_backward.launches == before
    with pytest.raises(ValueError):  # dropout without a seed
        fused_mha_forward(*args, 4, dropout_rate=0.1)


@pytest.mark.parametrize("slot_competition", [False, True])
def test_multi_head_attention_dropout_is_seeded_by_the_host_generator(slot_competition):
    """One int31 seed per call from the host generator: the same generator
    state gives the same output, another state another output; the
    slot-competition core drops with the same hash mask."""
    from act3d_tpu_torch.ops.attention import AttentionParams, multi_head_attention

    rng = np.random.default_rng(7)
    e, heads = 12, 4
    params = AttentionParams(*(t((rng.normal(size=(e, e)) / np.sqrt(e)).astype(np.float32))
                               for _ in range(4)))
    x = t(rng.normal(size=(2, 9, e)).astype(np.float32))
    y = t(rng.normal(size=(2, 11, e)).astype(np.float32))

    def run(seed, rate=0.3):
        return multi_head_attention(params, x, y, y, heads, slot_competition=slot_competition,
                                    dropout_rate=rate,
                                    generator=torch.Generator().manual_seed(seed))

    a = run(1)
    assert torch.equal(a, run(1))
    assert not torch.equal(a, run(2))
    assert not torch.equal(a, run(1, rate=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("b,l,s,e,heads", [(4, 3072, 53, 120, 8), (4, 50, 3074, 120, 8),
                                           (3, 50, 50, 120, 8), (2, 133, 70, 12, 4),
                                           (2, 37, 29, 60, 4)])
def test_cuda_kernels_match_plain_versions(b, l, s, e, heads, mask_kind, rate):
    """On the card: forward out and stats at atol 2e-5 / rtol 1e-4, and
    dq, dk, dv at atol 1e-4 / rtol 1e-3 (float32 sums over up to 3072 rows
    in another order than the plain version's matmuls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, g, mask = _inputs(6, b, l, s, e, heads, mask_kind)
    dev = torch.device("cuda")
    q, k, v, g = (torch.as_tensor(x, device=dev) for x in (q, k, v, g))
    mask = None if mask is None else torch.as_tensor(mask, device=dev)
    seed = 1234 if rate else None
    fwd0, bwd0 = fused_mha_forward.launches, fused_mha_backward.launches
    out, stats = fused_mha_forward(q, k, v, heads, mask, True, rate, seed)
    grads = fused_mha_backward(q, k, v, out, stats, g, heads, mask, rate, seed)
    torch.cuda.synchronize()
    assert (fused_mha_forward.launches, fused_mha_backward.launches) == (fwd0 + 1, bwd0 + 1)
    want_out, want_stats = fused_mha_forward_reference(q, k, v, heads, mask, rate, seed)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(stats, want_stats, atol=2e-5, rtol=1e-4)
    want = fused_mha_backward_reference(q, k, v, out, stats, g, heads, mask, rate, seed)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-3)


# (B, L, S, H, d) of every backward site of chip_smoke.py (both training
# steps, B = 16)
SMOKE_BWD_SITES = [
    (16, 3072, 53, 8, 15), (16, 50, 53, 8, 15), (16, 50, 3074, 8, 15), (16, 50, 50, 8, 15),
    (16, 3073, 53, 4, 15), (16, 333, 3126, 4, 15), (16, 1, 3126, 4, 15),
]


def test_bwd_plan_covers_s_and_l_exactly():
    """Key tiles cover S and L splits cover L, with no empty tile or split;
    the workspace holds the dq slabs, then the dk/dv slabs, as the C
    interface reads them."""
    rng = np.random.default_rng(1)
    cases = list(SMOKE_BWD_SITES) + [
        (int(rng.integers(1, 20)), int(rng.integers(1, 4000)), int(rng.integers(1, 4000)),
         int(rng.integers(1, 9)), int(rng.integers(1, 65))) for _ in range(200)]
    for b, l, s, h, d in cases:
        plan = bwd_plan(b, l, s, h, d)
        keys = 16 * plan.key_warps
        assert plan.key_warps in (1, 2, 4, 8)
        assert (plan.key_tiles - 1) * keys < s <= plan.key_tiles * keys
        assert (plan.nsplit - 1) * plan.rows_per_split < l <= plan.nsplit * plan.rows_per_split
        assert plan.blocks == plan.key_tiles * plan.nsplit * h * b
        e = h * d
        assert plan.dq_floats == (plan.key_tiles * b * l * e if plan.key_tiles > 1 else 0)
        assert plan.dkv_floats == (2 * plan.nsplit * b * s * e if plan.nsplit > 1 else 0)
        assert plan.workspace_floats == plan.dq_floats + plan.dkv_floats
        assert plan.kernels == 1 + (plan.key_tiles > 1) + (plan.nsplit > 1)


@pytest.mark.parametrize("b,l,s,h,d", SMOKE_BWD_SITES)
def test_bwd_plan_fills_the_card(b, l, s, h, d):
    """Every training site launches at least one block per SM: the S = 53
    sites through the L split, the L = 1 site through its key tiles."""
    assert bwd_plan(b, l, s, h, d).blocks >= 132


def test_bwd_wrapper_tells_the_c_interface_its_plan(monkeypatch):
    """The launch passes the plan's key warps, rows per split and nsplit, and
    a workspace of the plan's size, to act3d_fused_mha_bwd_f32 (a fake
    library function here, since there is no card)."""
    calls, sizes = [], []
    monkeypatch.setattr(attention, "_bwd_fn", lambda: lambda *a: calls.append(a) or 0)
    workspace = attention._workspace
    monkeypatch.setattr(attention, "_workspace",
                        lambda n, dev: sizes.append(n) or workspace(n, dev))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    for b, l, s, h, d in [(2, 3072, 53, 8, 15), (2, 50, 3074, 8, 15), (1, 20, 30, 2, 16)]:
        q, k, v = (torch.zeros(b, n, h * d) for n in (l, s, s))
        stats = torch.ones(b, l, 2 * h)
        plan = bwd_plan(b, l, s, h, d)
        attention._launch_bwd(q, k, v, q, stats, q, h, None, 0.0, None)
        args = calls[-1]
        assert args[11:20] == (b, l, s, h, d, plan.key_warps, plan.rows_per_split,
                               plan.nsplit, 0)
        assert sizes[-1] == plan.workspace_floats
        assert (args[10] is None) == (plan.workspace_floats == 0)


def _cuda_case(seed, b, l, s, e, heads, mask_kind):
    q, k, v, g, mask = _inputs(seed, b, l, s, e, heads, mask_kind)
    dev = torch.device("cuda")
    return ([torch.as_tensor(x, device=dev) for x in (q, k, v, g)],
            None if mask is None else torch.as_tensor(mask, device=dev))


def _check_grads(q, k, v, g, heads, mask, rate, seed, plan=None):
    out, stats = fused_mha_forward(q, k, v, heads, mask, True, rate, seed)
    runs = [attention._launch_bwd(q, k, v, out, stats, g, heads, mask, rate, seed, plan)
            for _ in range(2)]
    torch.cuda.synchronize()
    want = fused_mha_backward_reference(q, k, v, out, stats, g, heads, mask, rate, seed)
    for got, again, w in zip(*runs, want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-3)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", [None, "full_row"])
@pytest.mark.parametrize("l", [1, 17, 65])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 65, 129])
@pytest.mark.parametrize("e,heads", [(16, 2), (60, 4), (32, 2), (64, 2), (128, 2)])
def test_cuda_backward_ragged_edges_and_head_dims(e, heads, s, l, mask_kind, rate):
    """On the card: L and S at the edges of the 8-row chunk, the 16-key warp
    tile and the 64-key block tile, head dims 8, 15, 16, 32 and 64, masked
    (a fully masked row: the TPU gradient) with and without dropout; dq, dk,
    dv at atol 1e-4 / rtol 1e-3 and bit-identical when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (q, k, v, g), mask = _cuda_case(7, 2, l, s, e, heads, mask_kind)
    _check_grads(q, k, v, g, heads, mask, rate, 5 if rate else None)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("key_warps,rows_per_split", [(1, 300), (2, 64), (4, 128), (8, 70),
                                                      (8, 1)])
def test_cuda_backward_any_plan(key_warps, rows_per_split, rate):
    """On the card: any key tile and L split (dq slabs, dk/dv slabs, both)
    gives the plain version's gradients, bit-identical when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, e, heads = 2, 300, 150, 60, 4
    (q, k, v, g), mask = _cuda_case(8, b, l, s, e, heads, "padded")
    key_tiles = -(-s // (16 * key_warps))
    nsplit = -(-l // rows_per_split)
    dq = key_tiles * b * l * e if key_tiles > 1 else 0
    dkv = 2 * nsplit * b * s * e if nsplit > 1 else 0
    plan = BwdPlan(key_warps, key_tiles, rows_per_split, nsplit,
                   key_tiles * nsplit * heads * b, dq, dkv,
                   1 + (key_tiles > 1) + (nsplit > 1))
    _check_grads(q, k, v, g, heads, mask, rate, 3 if rate else None, plan)


def _bf16_case(seed, b, l, s, e, heads, mask_kind):
    """A card case in bf16 and its float32 upcast (the same values)."""
    (q, k, v, g), mask = _cuda_case(seed, b, l, s, e, heads, mask_kind)
    low = [x.to(torch.bfloat16) for x in (q, k, v, g)]
    return low, [x.float() for x in low], mask


def _check_bf16(low, f32, heads, mask, rate, seed, plan=None):
    """The bf16 kernels against the bf16 plain versions and the float32
    plain version on the same bf16-rounded inputs: each kernel result
    within bf16_errors' bound (the gradients' with the float32-noise floor
    BWD_FLOOR, for S = 1 without dropout, where dq and dk cancel to zero),
    the stats at the float32 tolerance, a
    repeat bit-identical, one bf16 launch of each wrapper and no float32
    one."""
    from act3d_tpu_torch.kernels import BWD_FLOOR, bf16_errors

    q, k, v, g = low
    counts = (fused_mha_forward.launches, fused_mha_backward.launches,
              fused_mha_forward.launches_bf16, fused_mha_backward.launches_bf16)
    out, stats = fused_mha_forward(q, k, v, heads, mask, True, rate, seed)
    runs = [attention._launch_bwd(q, k, v, out, stats, g, heads, mask, rate, seed, plan)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (fused_mha_forward.launches, fused_mha_backward.launches,
            fused_mha_forward.launches_bf16, fused_mha_backward.launches_bf16) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 2)
    assert out.dtype == torch.bfloat16 and stats.dtype == torch.float32
    plain_out, plain_stats = fused_mha_forward_reference(q, k, v, heads, mask, rate, seed)
    ref_out, _ = fused_mha_forward_reference(*f32[:3], heads, mask, rate, seed)
    fwd = bf16_errors(out, plain_out, ref_out)
    assert fwd["ok"], fwd
    torch.testing.assert_close(stats, plain_stats, atol=2e-5, rtol=1e-4)
    plain = fused_mha_backward_reference(q, k, v, out, stats, g, heads, mask, rate, seed)
    ref = fused_mha_backward_reference(*f32[:3], out.float(), stats, f32[3], heads, mask,
                                       rate, seed)
    for got, again, p, r in zip(*runs, plain, ref):
        assert got.dtype == torch.bfloat16
        errs = bf16_errors(got, p, r, BWD_FLOOR)
        assert errs["ok"], errs
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("b,l,s,e,heads", [(4, 3072, 53, 120, 8), (4, 50, 3074, 120, 8),
                                           (3, 50, 50, 120, 8), (4, 333, 3126, 60, 4),
                                           (4, 1, 3126, 60, 4), (2, 37, 29, 60, 4)])
def test_cuda_bf16_kernels_within_the_bf16_bound(b, l, s, e, heads, mask_kind, rate):
    """On the card, at bf16 (--mixed_precision 1): forward and backward
    against the bf16 plain versions, which round where the TPU kernels
    round, and the float32 plain version, at both training steps' sites."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    low, f32, mask = _bf16_case(9, b, l, s, e, heads, mask_kind)
    _check_bf16(low, f32, heads, mask, rate, 1234 if rate else None)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", [None, "full_row"])
@pytest.mark.parametrize("l", [1, 17, 65])
@pytest.mark.parametrize("s", [1, 16, 17, 65, 129])
@pytest.mark.parametrize("e,heads", [(16, 2), (60, 4), (32, 2), (64, 2), (128, 2)])
def test_cuda_bf16_ragged_edges_and_head_dims(e, heads, s, l, mask_kind, rate):
    """On the card, at bf16: L and S at the edges of the 16-row and 16-key
    operands and the 32-key tile, head dims 8, 15, 16, 32 and 64 (padded to
    16, 16, 16, 32, 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    low, f32, mask = _bf16_case(10, 2, l, s, e, heads, mask_kind)
    _check_bf16(low, f32, heads, mask, rate, 5 if rate else None)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("key_warps,rows_per_split", [(1, 300), (2, 64), (4, 128), (8, 70),
                                                      (8, 1)])
def test_cuda_bf16_backward_any_plan(key_warps, rows_per_split, rate):
    """On the card, at bf16: any key tile and L split (float32 dq slabs,
    dk/dv slabs, both, summed and rounded to bf16 once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, e, heads = 2, 300, 150, 60, 4
    low, f32, mask = _bf16_case(11, b, l, s, e, heads, "padded")
    key_tiles = -(-s // (16 * key_warps))
    nsplit = -(-l // rows_per_split)
    dq = key_tiles * b * l * e if key_tiles > 1 else 0
    dkv = 2 * nsplit * b * s * e if nsplit > 1 else 0
    plan = BwdPlan(key_warps, key_tiles, rows_per_split, nsplit,
                   key_tiles * nsplit * heads * b, dq, dkv,
                   1 + (key_tiles > 1) + (nsplit > 1))
    _check_bf16(low, f32, heads, mask, rate, 3 if rate else None, plan)


@pytest.mark.gpu
def test_cuda_bf16_dropout_drops_what_float32_drops():
    """For one seed the bf16 and float32 forward kernels drop the same
    weights (the hash of absolute coordinates): with v the identity of
    each head (S <= d), out is the kept weights, zero where dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, heads, d = 2, 40, 16, 2, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, l, heads * d, generator=gen, device=dev) * 0.25
    k = torch.randn(b, s, heads * d, generator=gen, device=dev)
    v = torch.eye(s, d, device=dev).repeat(b, 1, heads)
    zeros = []
    for dtype in (torch.float32, torch.bfloat16):
        out = fused_mha_forward(q.to(dtype), k.to(dtype), v.to(dtype), heads, None,
                                dropout_rate=0.3, dropout_seed=77)
        zeros.append(out.reshape(b, l, heads, d)[..., :s].transpose(1, 2) == 0)
    torch.cuda.synchronize()
    keep = dropout_keep(77, b, heads, l, s, 0.3, dev)
    assert torch.equal(zeros[0], ~keep) and torch.equal(zeros[1], ~keep)
