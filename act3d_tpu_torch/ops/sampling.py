"""Ghost-point sampling with static shapes (PyTorch).

Counterpart of ``act3d_tpu/ops/sampling.py``.  The sphere sampler is the
fixed-shape equivalent of rejection sampling: oversample 4x uniformly in
the (bounds-clipped) cube, then keep the first N points inside the ball,
in sampling order, by a stable sort of the rejected points to the back.

Each sampler draws from an explicit ``torch.Generator``, or takes the
uniforms ``u`` it would have drawn, so a test can feed both packages the
same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_uniform_cube", "sample_uniform_ball", "sample_grid", "ghost_point_bounds"]

OVERSAMPLE = 4


def sample_grid(bounds: torch.Tensor, num_points_per_dim: int = 10) -> torch.Tensor:
    """Regular grid over a (2, 3) [min, max] box (reference
    sample_ghost_points_grid, model/utils/utils.py:59-65): (N^3, 3) points
    in x-major order, on the device and in the dtype of ``bounds``.  Each
    axis is ``jnp.linspace``'s arithmetic: ``lo * (1 - s) + hi * s`` at
    s = i / (N - 1), the last point ``hi`` itself."""
    n = num_points_per_dim
    lo, hi = bounds[0], bounds[1]
    if n == 1:
        axes = lo[None]
    else:
        step = (torch.arange(n - 1, device=bounds.device, dtype=bounds.dtype) / (n - 1))[:, None]
        axes = torch.cat([lo * (1 - step) + hi * step, hi[None]])  # (N, 3)
    x, y, z = torch.meshgrid(axes[:, 0], axes[:, 1], axes[:, 2], indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def sample_uniform_cube(
    bounds: torch.Tensor,
    num_points: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform points in (..., 2, 3) [min, max] boxes -> (..., N, 3)."""
    lo = bounds[..., 0, :]
    hi = bounds[..., 1, :]
    if u is None:
        u = torch.rand(
            lo.shape[:-1] + (num_points, 3), generator=generator,
            device=bounds.device, dtype=torch.float32,
        )
    return lo[..., None, :] + u * (hi - lo)[..., None, :]


def sample_uniform_ball(
    center: torch.Tensor,
    radius: float,
    bounds: torch.Tensor,
    num_points: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform points in ball(center, radius) ∩ box(bounds) -> (..., N, 3).

    ``u``, when given, holds the (..., 4N, 3) cube uniforms.
    """
    pts = sample_uniform_cube(bounds, OVERSAMPLE * num_points, generator, u)
    d2 = torch.sum((pts - center[..., None, :]) ** 2, dim=-1)
    outside = (d2 >= radius * radius).to(torch.uint8)  # strict < inside
    order = torch.argsort(outside, dim=-1, stable=True)[..., :num_points]
    return torch.gather(pts, -2, order[..., None].expand(order.shape + (3,)))


def ghost_point_bounds(
    anchor: torch.Tensor, diameter: float, workspace_bounds: torch.Tensor
) -> torch.Tensor:
    """Anchor-centred cube of the given diameter clipped to the workspace:
    (..., 3) anchors, (2, 3) bounds -> (..., 2, 3)."""
    lo = torch.clamp(anchor - diameter / 2.0, workspace_bounds[0], workspace_bounds[1])
    hi = torch.clamp(anchor + diameter / 2.0, workspace_bounds[0], workspace_bounds[1])
    return torch.stack([lo, hi], dim=-2)
