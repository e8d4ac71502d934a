"""The port's single-head-layout attention core against the JAX package.

``act3d_tpu_torch.kernels.attention.attention_core`` on CPU tensors (its
plain version, ``attention_core_reference``, forward; JAX's jnp VJP in torch
ops, backward) is held against JAX ``attention_core(..., interpret=True)``
(the Pallas kernel run in interpret mode, and its custom VJP) at the
shapes of tests/test_kernels.py:24-47 and tests/test_kernels_grad.py:
forward at atol 2e-5, gradients against ``jax.vjp`` at atol 1e-4, masked
and unmasked, with a fully masked row (uniform weights under the -1e30
rule).  The gpu-marked cases hold the CUDA kernel against the plain
version on the card, forward and through autograd:

    python -m pytest --noconftest tests/test_torch_attention_core.py -m gpu
"""

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels.attention import (
    attention_core,
    attention_core_forward,
    attention_core_reference,
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
    before = attention_core.launches
    got = attention_core_forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(got, attention_core_reference(q, k, v, mask), atol=2e-5,
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
