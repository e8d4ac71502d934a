"""Fused-MHA forward of the port against the JAX package's Pallas kernel.

The port's plain version (``act3d_tpu_torch.kernels.attention
.fused_mha_forward_reference``, what the wrapper runs on a CPU tensor) is
held against ``act3d_tpu.kernels.attention._fused_mha_fwd_impl`` run in
interpret mode, for out and for the (m, l) row stats, at atol/rtol 1e-5
(one softmax-matmul chain in float32).  The CUDA kernel itself is held
against the plain version by the gpu-marked tests below, on the card.
JAX and the JAX package are imported inside the tests that use them, so
the gpu-marked tests also run where neither is installed:

    python -m pytest --noconftest tests/test_torch_attention_kernel.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels import attention
from act3d_tpu_torch.kernels.attention import (
    FwdPlan,
    fused_mha_forward,
    fused_mha_forward_reference,
    fwd_plan,
)

TOL = 1e-5


# This file also runs on the card, where another installed package may own
# the name ``tests``; so it keeps its own copies of the two parity helpers.
def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=atol, rtol=rtol)


def _inputs(seed, b, l, s, e, heads, masked):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, l, e)) * (e // heads) ** -0.5).astype(np.float32)
    k = rng.normal(size=(b, s, e)).astype(np.float32)
    v = rng.normal(size=(b, s, e)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, s)) < 0.3
        mask[:, 0] = False  # every row keeps a key
    return q, k, v, mask


def _jax(q, k, v, heads, mask):
    import jax.numpy as jnp
    from act3d_tpu.kernels.attention import _fused_mha_fwd_impl

    out, stats = _fused_mha_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        None if mask is None else jnp.asarray(mask), 128, True,
    )
    return np.asarray(out), np.asarray(stats)[:, : q.shape[1]]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,l,s,e,heads",
    [
        (2, 37, 29, 60, 4),  # head dim 15 (the serving widths' head dim)
        (1, 133, 53, 12, 4),  # head dim 3, L ragged against the 128 tile
        (2, 1, 70, 30, 2),  # a single query row
    ],
)
def test_plain_version_matches_pallas_kernel(b, l, s, e, heads, masked):
    q, k, v, mask = _inputs(0, b, l, s, e, heads, masked)
    want_out, want_stats = _jax(q, k, v, heads, mask)
    got_out, got_stats = fused_mha_forward(
        t(q), t(k), t(v), heads, None if mask is None else t(mask), return_stats=True
    )
    assert got_stats.shape == (b, l, 2 * heads)
    close(got_out, want_out, TOL, TOL)
    close(got_stats, want_stats, TOL, TOL)


def test_fully_masked_row_gets_uniform_weights():
    """A fully masked row scores -1e30 everywhere: the Pallas kernel and
    the port both give uniform weights (the mean of v).  The JAX eager
    path masks with -inf instead and gives NaN there (shown below), so
    the port follows the kernel, not the eager path."""
    import jax.numpy as jnp
    from act3d_tpu.ops.attention import AttentionParams, multi_head_attention

    b, l, s, e, heads = 2, 9, 11, 12, 4
    q, k, v, _ = _inputs(1, b, l, s, e, heads, False)
    mask = np.zeros((b, s), bool)
    mask[1] = True
    mask[0, 3:5] = True
    want_out, want_stats = _jax(q, k, v, heads, mask)
    got_out, got_stats = fused_mha_forward(t(q), t(k), t(v), heads, t(mask),
                                           return_stats=True)
    close(got_out, want_out, TOL, TOL)
    close(got_stats, want_stats, TOL, TOL)
    close(got_out[1], np.broadcast_to(v[1].mean(axis=0), (l, e)), TOL, TOL)

    eye = jnp.eye(e, dtype=jnp.float32)
    eager = multi_head_attention(
        AttentionParams(eye, eye, eye, eye), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), heads, key_padding_mask=jnp.asarray(mask),
    )
    assert np.isnan(np.asarray(eager)[1]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 12)
    with pytest.raises(ValueError):
        fused_mha_forward(q, torch.zeros(1, 5, 8), torch.zeros(1, 5, 8), 4)
    with pytest.raises(ValueError):
        fused_mha_forward(q, q, q, 5)
    with pytest.raises(ValueError):
        fused_mha_forward(q, q, q, 4, key_padding_mask=torch.zeros(1, 4))
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        fused_mha_forward(q.to("meta"), q.to("meta"), q.to("meta"), 4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v, mask = _inputs(2, 1, 5, 7, 12, 4, True)
    before = fused_mha_forward.launches
    out = fused_mha_forward(t(q), t(k), t(v), 4, t(mask))
    want, _ = fused_mha_forward_reference(t(q), t(k), t(v), 4, t(mask))
    assert torch.equal(out, want)
    assert fused_mha_forward.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,s,e,heads", [(1, 3333, 3126, 60, 4), (1, 50, 3074, 120, 8),
                                           (2, 50, 50, 120, 8), (1, 1, 3126, 60, 4)])
def test_cuda_kernel_matches_plain_version(b, l, s, e, heads, masked):
    """On the card: the CUDA kernel against its plain version at atol 2e-5 /
    rtol 1e-4 (float32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = _inputs(3, b, l, s, e, heads, masked)
    dev = torch.device("cuda")
    args = [torch.as_tensor(x, device=dev) for x in (q, k, v)]
    mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
    before = fused_mha_forward.launches
    out, stats = fused_mha_forward(*args, heads, mask_t, return_stats=True)
    torch.cuda.synchronize()
    assert fused_mha_forward.launches == before + 1
    want_out, want_stats = fused_mha_forward_reference(*args, heads, mask_t)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(stats, want_stats, atol=2e-5, rtol=1e-4)


# (B, L, S, H, d) of every forward site of chip_smoke.py: serving (B = 1)
# and both training steps (B = 16)
SMOKE_FWD_SITES = [
    (1, 3073, 53, 4, 15), (1, 3333, 3126, 4, 15), (1, 1, 3126, 4, 15),
    (1, 3072, 53, 8, 15), (1, 50, 53, 8, 15), (1, 50, 3074, 8, 15), (1, 50, 50, 8, 15),
    (16, 3072, 53, 8, 15), (16, 50, 53, 8, 15), (16, 50, 3074, 8, 15), (16, 50, 50, 8, 15),
    (16, 3073, 53, 4, 15), (16, 333, 3126, 4, 15), (16, 1, 3126, 4, 15),
]


def _fwd_plan_cases():
    rng = np.random.default_rng(0)
    cases = list(SMOKE_FWD_SITES)
    for _ in range(200):
        cases.append((int(rng.integers(1, 20)), int(rng.integers(1, 400)),
                      int(rng.integers(1, 5000)), int(rng.integers(1, 9)),
                      int(rng.integers(1, 65))))
    return cases


def test_fwd_plan_covers_l_and_s_exactly():
    """Query tiles cover L with no empty tile; the key chunks cover S with
    no empty chunk; the workspace is what the C interface reads."""
    for b, l, s, h, d in _fwd_plan_cases():
        plan = fwd_plan(b, l, s, h, d)
        rows = 16 * plan.warps
        assert plan.warps in (1, 2, 4, 8)
        assert (plan.q_tiles - 1) * rows < l <= plan.q_tiles * rows
        assert (plan.nsplit - 1) * plan.chunk < s <= plan.nsplit * plan.chunk
        assert plan.blocks == plan.q_tiles * plan.nsplit * h * b
        split = plan.nsplit > 1
        assert plan.workspace_floats == (plan.nsplit * b * l * (h * d + 2 * h) if split else 0)
        assert plan.kernels == 1 + split


@pytest.mark.parametrize("b,l,s,h,d", [(1, 1, 3126, 4, 15), (1, 50, 3074, 8, 15),
                                       (16, 1, 3126, 4, 15)])
def test_fwd_plan_fills_the_card_where_query_tiles_cannot(b, l, s, h, d):
    """The serving query and sampler cross sites and the keypose query
    site: query tiles x H x B alone give fewer than 132 blocks (one per SM);
    the split over S gives at least that many."""
    plan = fwd_plan(b, l, s, h, d)
    assert plan.q_tiles * h * b < 132
    assert plan.nsplit > 1 and plan.blocks >= 132


def test_fwd_wrapper_tells_the_c_interface_its_plan(monkeypatch):
    """The launch passes the plan's warps, chunk and nsplit, and a workspace
    of the plan's size, to act3d_fused_mha_fwd_f32 (run here with a fake
    library function, since there is no card)."""
    calls, sizes = [], []
    monkeypatch.setattr(attention, "_fwd_fn", lambda: lambda *a: calls.append(a) or 0)
    workspace = attention._workspace
    monkeypatch.setattr(attention, "_workspace",
                        lambda n, dev: sizes.append(n) or workspace(n, dev))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    for b, l, s, h, d in [(1, 50, 3074, 8, 15), (2, 70, 40, 2, 16)]:
        q, k, v = (torch.zeros(b, n, h * d) for n in (l, s, s))
        plan = fwd_plan(b, l, s, h, d)
        attention._launch_fwd(q, k, v, h, None, 0.0, None)
        args = calls[-1]
        assert args[7:16] == (b, l, s, h, d, plan.warps, plan.chunk, plan.nsplit, 0)
        assert sizes[-1] == plan.workspace_floats
        assert (args[6] is None) == (plan.nsplit == 1)
        assert args[-1] == 7


def _cuda_inputs(seed, b, l, s, e, heads, mask_kind):
    q, k, v, _ = _inputs(seed, b, l, s, e, heads, False)
    mask = None
    if mask_kind is not None:
        mask = np.random.default_rng(seed + 1).uniform(size=(b, s)) < 0.3
        mask[:, 0] = False
        if mask_kind == "full_row":
            mask[-1] = True
    dev = torch.device("cuda")
    return ([torch.as_tensor(x, device=dev) for x in (q, k, v)],
            None if mask is None else torch.as_tensor(mask, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("l", [1, 17, 65])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("e,heads", [(16, 2), (60, 4), (32, 2), (64, 2), (128, 2)])
def test_cuda_kernel_ragged_edges_and_head_dims(e, heads, s, l, mask_kind):
    """On the card: L and S at the edges of the 16-row query tile, the
    64-key tile and the 64-key chunk, head dims 8, 15, 16, 32 and 64, with a
    padded and a fully masked row (uniform weights), at atol 2e-5 / rtol
    1e-4; a second call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = 2
    (q, k, v), mask = _cuda_inputs(4, b, l, s, e, heads, mask_kind)
    out, stats = fused_mha_forward(q, k, v, heads, mask, return_stats=True)
    again = fused_mha_forward(q, k, v, heads, mask, return_stats=True)
    torch.cuda.synchronize()
    want_out, want_stats = fused_mha_forward_reference(q, k, v, heads, mask)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(stats, want_stats, atol=2e-5, rtol=1e-4)
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1])
    if mask_kind == "full_row":
        torch.testing.assert_close(out[-1], v[-1].mean(dim=0).expand(l, e), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("warps,chunk", [(1, 8), (2, 40), (4, 64), (8, 65), (4, 1000)])
def test_cuda_kernel_any_plan(warps, chunk, rate):
    """On the card: any query tile and key chunk gives the plain version's
    result (masked, with and without dropout), bit-identical when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, e, heads = 2, 70, 300, 60, 4
    (q, k, v), mask = _cuda_inputs(5, b, l, s, e, heads, "padded")
    chunk = min(chunk, s)
    nsplit = -(-s // chunk)
    q_tiles = -(-l // (16 * warps))
    plan = FwdPlan(warps, q_tiles, chunk, nsplit, q_tiles * nsplit * heads * b,
                   nsplit * b * l * (e + 2 * heads) if nsplit > 1 else 0, 1 + (nsplit > 1))
    seed = 99 if rate else None
    runs = [attention._launch_fwd(q, k, v, heads, mask, rate, seed, plan) for _ in range(2)]
    torch.cuda.synchronize()
    want_out, want_stats = fused_mha_forward_reference(q, k, v, heads, mask, rate, seed)
    torch.testing.assert_close(runs[0][0], want_out, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(runs[0][1], want_stats, atol=2e-5, rtol=1e-4)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,s,e,heads", [(16, 3073, 53, 60, 4), (16, 333, 3126, 60, 4),
                                           (16, 1, 3126, 60, 4), (16, 3072, 53, 120, 8),
                                           (16, 50, 3074, 120, 8), (16, 50, 50, 120, 8)])
def test_cuda_bf16_kernel_within_the_bf16_bound(b, l, s, e, heads, masked):
    """On the card, at bf16 (--mixed_precision 1) and the training steps'
    shapes: the kernel against the bf16 plain version and the float32
    plain version on the same bf16-rounded inputs (bf16_errors' bound),
    the float32 stats at atol 2e-5 / rtol 1e-4; one bf16 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from act3d_tpu_torch.kernels import bf16_errors

    q, k, v, mask = _inputs(4, b, l, s, e, heads, masked)
    dev = torch.device("cuda")
    low = [torch.as_tensor(x, device=dev).to(torch.bfloat16) for x in (q, k, v)]
    mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
    before = fused_mha_forward.launches, fused_mha_forward.launches_bf16
    out, stats = fused_mha_forward(*low, heads, mask_t, return_stats=True)
    torch.cuda.synchronize()
    assert (fused_mha_forward.launches, fused_mha_forward.launches_bf16) == (
        before[0], before[1] + 1)
    plain_out, plain_stats = fused_mha_forward_reference(*low, heads, mask_t)
    ref_out, _ = fused_mha_forward_reference(*(x.float() for x in low), heads, mask_t)
    errs = bf16_errors(out, plain_out, ref_out)
    assert errs["ok"], errs
    torch.testing.assert_close(stats, plain_stats, atol=2e-5, rtol=1e-4)
