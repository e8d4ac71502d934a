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

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels.attention import (
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
