"""Shared helpers of the tests/test_torch_*.py parity tests (JAX package
against its PyTorch port, on the CPU)."""

from __future__ import annotations

import sys
from pathlib import Path

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


FAKE_REFERENCE = Path(__file__).parent / "fake_reference"


def fake_reference_models():
    """(Act3D, DiffusionPlanner) of the torch-only reference doubles in
    tests/fake_reference, whose state dicts have the upstream layout."""
    sys.path.insert(0, str(FAKE_REFERENCE))
    try:
        from model.keypose_optimization.act3d import Act3D
        from model.trajectory_optimization.diffusion_model import DiffusionPlanner
    finally:
        sys.path.remove(str(FAKE_REFERENCE))
    return Act3D, DiffusionPlanner


def save_reference_checkpoint(model, path, seed: int):
    """Seeded non-trivial weights for a reference-layout model (every
    parameter perturbed, BatchNorm statistics drawn; tied modules stay
    tied), saved as the reference trainer does: ``{"weight": state_dict}``
    with DDP's ``module.`` prefixes."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    state = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"weight": state, "iter": 0}, path)
    return state
