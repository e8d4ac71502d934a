"""The row-gather adjoint of the port against the JAX package.

The port's plain version (``act3d_tpu_torch.kernels.gather
.scatter_rows_reference``, what both wrappers run on a CPU tensor) is held
against the three Pallas kernels of ``act3d_tpu/kernels/gather.py`` run in
interpret mode, and against an explicit numpy scatter, at atol 0: with
unique indices every output row is one copy of a cotangent row or zeros.
The index layouts are those of tests/test_kernels.py (uniform, clustered,
K-edge-hugging, a small K below the windowed kernel's two blocks, a P that
needs tile padding).  The port's ``gather_tokens`` gradient, sorted and
unsorted, is held against ``jax.grad`` of JAX's ``gather_tokens``, also at
atol 0.  The CUDA kernels are held against the plain version by the
gpu-marked tests, on the card (JAX is imported only inside the tests that
use it):

    python -m pytest --noconftest tests/test_torch_gather.py -m gpu
"""

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels.gather import (
    scatter_rows,
    scatter_rows_reference,
    scatter_rows_sorted,
)
from act3d_tpu_torch.ops.geometry import gather_tokens


def _indices(rng, layout, b, p, k):
    """(B, K) int64 unique indices, ascending unless ``layout`` is
    'permutation'."""
    if layout == "permutation":
        return np.stack([rng.permutation(p)[:k] for _ in range(b)])
    if layout == "uniform":
        return np.stack([np.sort(rng.permutation(p)[:k]) for _ in range(b)])
    if layout == "clustered":  # two tight spans: many tiles empty, two dense
        span = max(160, (k // 2) * 5 // 4)
        lo = np.sort(rng.permutation(span)[:k // 2])
        hi = np.sort(rng.permutation(span)[:k - k // 2]) + p - span
        return np.stack([np.concatenate([lo, hi]) for _ in range(b)])
    if layout == "edges":  # the first and last possible positions
        return np.stack([np.concatenate([np.arange(k // 2),
                                         p - k + k // 2 + np.arange(k - k // 2)])
                         for _ in range(b)])
    raise ValueError(layout)


def _explicit(g, idx, p):
    want = np.zeros((g.shape[0], p, g.shape[2]), np.float32)
    for bi in range(g.shape[0]):
        want[bi, idx[bi]] = g[bi]
    return want


def _jax_kernel(name, g, idx, p, p_tile):
    import jax.numpy as jnp
    from act3d_tpu.kernels import gather as jg

    g, idx = jnp.asarray(g), jnp.asarray(idx.astype(np.int32))
    if name == "chunked":
        return jg.onehot_scatter_rows_chunked(g, idx, p, p_tile=p_tile, n_chunks=4,
                                              interpret=True)
    fn = jg.onehot_scatter_rows if name == "unsorted" else jg.onehot_scatter_rows_sorted
    return fn(g, idx, p, p_tile=p_tile, interpret=True)


# (JAX kernel, index layout, B, P, K, C, p_tile): tests/test_kernels.py:50-148
CASES = [
    ("unsorted", "permutation", 3, 200, 17, 60, 64),
    ("unsorted", "permutation", 3, 512, 64, 8, 128),
    ("sorted", "uniform", 2, 1024, 256, 12, 64),
    ("sorted", "clustered", 2, 1024, 256, 12, 64),
    ("sorted", "edges", 2, 1024, 256, 12, 64),
    ("sorted", "small_k", 2, 300, 40, 8, 128),
    ("chunked", "uniform", 2, 2048, 256, 12, 128),
    ("chunked", "clustered", 2, 2048, 256, 12, 128),
    ("chunked", "edges", 2, 2048, 256, 12, 128),
]


@pytest.mark.parametrize("kernel,layout,b,p,k,c,p_tile", CASES,
                         ids=[f"{c[0]}-{c[1]}-P{c[3]}" for c in CASES])
def test_plain_version_matches_the_pallas_kernels(kernel, layout, b, p, k, c, p_tile):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(b, k, c)).astype(np.float32)
    idx = _indices(rng, "uniform" if layout == "small_k" else layout, b, p, k)
    want = _explicit(g, idx, p)
    np.testing.assert_array_equal(np.asarray(_jax_kernel(kernel, g, idx, p, p_tile)), want)

    wrapper = scatter_rows if kernel == "unsorted" else scatter_rows_sorted
    before = wrapper.launches
    got = wrapper(torch.from_numpy(g), torch.from_numpy(idx), p)  # CPU: the plain version
    assert wrapper.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        scatter_rows_reference(torch.from_numpy(g), torch.from_numpy(idx), p).numpy(), want)


@pytest.mark.parametrize("sorted_indices", [False, True])
def test_gather_tokens_gradient_matches_jax(sorted_indices):
    import jax
    import jax.numpy as jnp
    from act3d_tpu.ops.geometry import gather_tokens as jax_gather_tokens

    rng = np.random.default_rng(1)
    b, p, c, k = 2, 512, 24, 128
    x = rng.normal(size=(b, p, c)).astype(np.float32)
    w = rng.normal(size=(b, k, c)).astype(np.float32)
    idx = _indices(rng, "uniform" if sorted_indices else "permutation", b, p, k)

    def loss(x):
        out = jax_gather_tokens(x, jnp.asarray(idx.astype(np.int32)),
                                sorted_indices=sorted_indices)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = gather_tokens(xt, torch.from_numpy(idx), sorted_indices=sorted_indices)
    np.testing.assert_array_equal(out.detach().numpy(), x[np.arange(b)[:, None], idx])
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_gather_without_gradient_and_wrapper_checks():
    x = torch.randn(2, 10, 3)
    idx = torch.tensor([[1, 4, 7], [0, 2, 9]])
    out = gather_tokens(x, idx, sorted_indices=True)
    assert out.grad_fn is None  # the (B, P, 3) xyz gather has no adjoint to run
    torch.testing.assert_close(out, x[torch.arange(2)[:, None], idx], atol=0, rtol=0)
    g = torch.randn(2, 3, 4)
    with pytest.raises(ValueError, match="idx"):
        scatter_rows_sorted(g, idx[:, :2], 10)
    with pytest.raises(ValueError, match="integer"):
        scatter_rows(g, idx.float(), 10)
    with pytest.raises(ValueError, match="empty"):
        scatter_rows(g, idx, 0)


def _cuda_case(layout, b, p, k, c, seed=0):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    idx = _indices(rng, layout, b, p, k)
    g = torch.as_tensor(rng.normal(size=(b, k, c)).astype(np.float32), device=dev)
    return g, torch.as_tensor(idx, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["uniform", "clustered", "edges"])
@pytest.mark.parametrize("b,p,k,c", [(16, 49152, 3072, 60), (2, 1000, 300, 7),
                                     (3, 2048, 256, 12)])
def test_cuda_kernels_match_plain_version(layout, b, p, k, c):
    """On the card: both entry points equal the plain version exactly
    (each output row is one copy), the unsorted one on a shuffled order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, idx = _cuda_case(layout, b, p, k, c)
    want = scatter_rows_reference(g, idx, p)
    before = scatter_rows_sorted.launches, scatter_rows.launches
    got_sorted = scatter_rows_sorted(g, idx, p)
    perm = torch.randperm(k, device=g.device)
    got_any = scatter_rows(g[:, perm], idx[:, perm].contiguous(), p)
    torch.cuda.synchronize()
    assert (scatter_rows_sorted.launches, scatter_rows.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    assert torch.equal(got_sorted, want)
    assert torch.equal(got_any, want)


@pytest.mark.gpu
def test_cuda_kernels_take_strided_rows():
    """A cotangent that is a slice of a wider tensor (the gather output's
    slice of Act3D's concatenated context) is read in place, with the
    float4 path (C = 60) and the scalar path (an offset of one float)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, idx = _cuda_case("uniform", 4, 8192, 1024, 60)
    wide = torch.cat([g, torch.randn_like(g[:, :1])], dim=1)
    for view in (wide[:, :1024], wide[:, 1:]):
        want = scatter_rows_reference(view.contiguous(), idx, 8192)
        assert torch.equal(scatter_rows_sorted(view, idx, 8192), want)
    shifted = torch.empty(4 * 1024 * 60 + 1, device=g.device)[1:].view(4, 1024, 60)
    shifted.copy_(g)
    assert torch.equal(scatter_rows_sorted(shifted, idx, 8192),
                       scatter_rows_reference(g, idx, 8192))
    assert torch.equal(scatter_rows(shifted, idx, 8192), scatter_rows_reference(g, idx, 8192))
