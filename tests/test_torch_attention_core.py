"""The port's single-head-layout attention core against the JAX package.

``act3d_tpu_torch.kernels.attention.attention_core`` on CPU tensors (its
plain version, ``attention_core_reference``, forward; JAX's jnp VJP in torch
ops, backward) is held against JAX ``attention_core(..., interpret=True)``
(the Pallas kernel run in interpret mode, and its custom VJP) at the
shapes of tests/test_kernels.py:24-47 and tests/test_kernels_grad.py:
forward at atol 2e-5, gradients against ``jax.vjp`` at atol 1e-4, masked
and unmasked, with a fully masked row (uniform weights under the -1e30
rule).  On the card the core is the fused forward kernel at H = 1
without stats; a CPU test checks what the wrapper tells that kernel's C
interface.  The gpu-marked cases hold the kernel against the plain
version on the card, forward and through autograd:

    python -m pytest --noconftest tests/test_torch_attention_core.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels import attention
from act3d_tpu_torch.kernels.attention import (
    attention_core,
    attention_core_forward,
    attention_core_reference,
    fused_mha_forward,
    fwd_plan,
)


def _inputs(rng, bh, l, s, d, scale=None):
    q = rng.normal(size=(bh, l, d)).astype(np.float32) * (d ** -0.5 if scale is None else scale)
    k = rng.normal(size=(bh, s, d)).astype(np.float32) * (1.0 if scale is None else scale)
    v = rng.normal(size=(bh, s, d)).astype(np.float32)
    return q, k, v


def _mask(bh, s, kind):
    if kind is None:
        return None
    mask = np.zeros((bh, s), bool)
    mask[0, -7:] = True  # padded keys
    if kind == "full_row":
        mask[1] = True  # every key of one leading index masked
    return mask


def _jax_core(q, k, v, mask, l_tile):
    import jax.numpy as jnp
    from act3d_tpu.kernels.attention import attention_core as jax_attention_core

    return jax_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask),
                              l_tile=l_tile, interpret=True)


# (bh, l, s, d, mask kind, l_tile): tests/test_kernels.py:24-47, plus a
# fully masked row
FORWARD_CASES = [
    (4, 64, 96, 16, None, 64),
    (4, 100, 57, 15, None, 64),
    (4, 512, 300, 8, None, 64),
    (2, 32, 40, 16, "padded", 32),
    (2, 32, 40, 15, "full_row", 32),
]


@pytest.mark.parametrize("bh,l,s,d,kind,l_tile", FORWARD_CASES)
def test_forward_matches_the_pallas_kernel(rng, bh, l, s, d, kind, l_tile):
    q, k, v = _inputs(rng, bh, l, s, d)
    mask = _mask(bh, s, kind)
    want = np.asarray(_jax_core(q, k, v, mask, l_tile))
    tm = None if mask is None else torch.from_numpy(mask)
    before = attention_core.launches
    got = attention_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm)
    assert attention_core.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    if kind == "full_row":  # uniform weights over every (masked) key
        np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1].mean(0), (l, d)),
                                   atol=2e-5, rtol=0)


# (bh, l, s, d, mask kind, l_tile, scale): tests/test_kernels_grad.py:11-63
GRAD_CASES = [
    (2, 24, 40, 16, "padded", 24, 0.3),
    (2, 16, 20, 8, None, 16, 0.3),
    (3, 24, 40, 15, "full_row", 24, 0.3),
]


@pytest.mark.parametrize("bh,l,s,d,kind,l_tile,scale", GRAD_CASES)
def test_gradients_match_jax_vjp(rng, bh, l, s, d, kind, l_tile, scale):
    import jax
    import jax.numpy as jnp

    q, k, v = _inputs(rng, bh, l, s, d, scale)
    mask = _mask(bh, s, kind)
    g = rng.normal(size=(bh, l, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: _jax_core(*a, mask, l_tile), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = attention_core(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=2e-5, rtol=0)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


def test_wrapper_checks():
    q, k = torch.zeros(2, 3, 4), torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="mask"):
        attention_core_forward(q, k, k, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="mismatch"):
        attention_core_forward(q, torch.zeros(3, 5, 4), torch.zeros(3, 5, 4))
    with pytest.raises(ValueError, match="BH"):
        attention_core_forward(q[0], k, k)


def test_core_wrapper_launches_the_forward_kernel_without_stats(monkeypatch):
    """On a CUDA tensor (faked here, with a fake library function) the
    wrapper passes act3d_fused_mha_fwd_f32 H = 1, E = D, no stats pointer,
    rate 0 and the core's plan, and counts attention_core, not
    fused_mha_forward."""
    calls = []
    monkeypatch.setattr(attention, "_fwd_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    for bh, l, s, d in [(128, 50, 3074, 15), (64, 333, 3126, 15)]:
        q, k, v = (torch.zeros(bh, n, d) for n in (l, s, s))
        before = attention_core.launches, fused_mha_forward.launches
        attention._launch_core(q, k, v, None)
        plan = fwd_plan(bh, l, s, 1, d)
        args = calls[-1]
        assert args[5] is None  # stats
        assert args[7:16] == (bh, l, s, 1, d, plan.warps, plan.chunk, plan.nsplit, 0)
        assert (args[6] is None) == (plan.nsplit == 1)
        assert (attention_core.launches, fused_mha_forward.launches) == (before[0] + 1,
                                                                          before[1])


def _cuda_inputs(bh, l, s, d, kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(x).cuda() for x in _inputs(rng, bh, l, s, d))
    mask = _mask(bh, s, kind)
    return q, k, v, None if mask is None else torch.from_numpy(mask).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("bh,l,s,d,kind", [
    (64, 333, 3126, 15, None),  # the Act3D ghost site of a training step, flattened
    (128, 50, 3074, 15, None),  # the ChainedDiffuser cross-attention site
    (64, 1, 3126, 15, None),
    (128, 50, 50, 15, "full_row"),
    (4, 100, 57, 16, None),
    (4, 512, 300, 8, "padded"),
    (3, 17, 70, 64, "padded"),
])
def test_cuda_kernel_matches_plain_version(bh, l, s, d, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = _cuda_inputs(bh, l, s, d, kind)
    before = attention_core.launches, fused_mha_forward.launches
    got = attention_core_forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert (attention_core.launches, fused_mha_forward.launches) == (before[0] + 1,
                                                                      before[1])
    torch.testing.assert_close(got, attention_core_reference(q, k, v, mask), atol=2e-5,
                               rtol=1e-4)
    assert torch.equal(got, attention_core_forward(q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [None, "padded", "full_row"])
@pytest.mark.parametrize("l,s", [(1, 1), (1, 61), (1, 3126), (17, 70), (50, 53), (50, 3074),
                                 (65, 129), (333, 501)])
@pytest.mark.parametrize("d", [8, 15, 16, 33, 64])
def test_cuda_kernel_ragged_edges_and_head_dims(d, l, s, kind):
    """Every head-dim template (DP 8 / 16 / 32 / 64, D padded in shared
    memory), L = 1, S not a multiple of 8, the split over S and its
    combine, padded keys (at S < 8 every key of row 0) and a fully masked
    row (uniform weights); a repeated call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh = 6
    q, k, v, mask = _cuda_inputs(bh, l, s, d, kind, seed=d + l + s)
    got = attention_core_forward(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, attention_core_reference(q, k, v, mask), atol=2e-5,
                               rtol=1e-4)
    assert torch.equal(got, attention_core_forward(q, k, v, mask))
    if kind == "full_row":
        torch.testing.assert_close(got[1], v[1].mean(dim=0).expand(l, d), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_cuda_gradients_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = _cuda_inputs(3, 24, 40, 15, "full_row", seed=1)
    g = torch.randn_like(q)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        attention_core(*leaves, mask.to(dev)).backward(g.to(dev))
        grads.append([x.grad.cpu() for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
