"""Shared helpers of the tests/test_torch_*.py parity tests (JAX package
against its PyTorch port, on the CPU)."""

from __future__ import annotations

import numpy as np
import torch


def random_params(module, seed: int, *args, **kwargs):
    """Seeded random numpy params for a flax module, from its init shapes.

    ``jax.eval_shape`` gives the tree without compiling ``init``; every
    leaf is then drawn so that no layer is trivial (AdaLN and the frozen
    batch norms get non-identity values, unlike their inits).
    """
    import jax

    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)
    )["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        shape = sd.shape
        if name in ("kernel", "q_kernel", "k_kernel", "v_kernel", "out_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape) / np.sqrt(fan_in)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name in ("bias", "mean") or name.endswith("_bias"):
            return 0.1 * rng.normal(size=shape)
        return rng.normal(size=shape)  # learned embeddings

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU float tensor (bool stays bool)."""
    return torch.from_numpy(np.array(x))


def close(got, want, atol, rtol=0.0):
    """Compare a torch tensor with a numpy/jax array."""
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), atol=atol, rtol=rtol,
    )
