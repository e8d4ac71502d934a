"""Fine-context selection for Act3D (PyTorch).

Counterpart of ``act3d_tpu/ops/geometry.py::topk_nearest_context`` and
the forward token gather.  Selection is exact top-k (the JAX package's
``approx_topk`` is a TPU feature and is not carried over).
"""

from __future__ import annotations

import torch

__all__ = ["topk_nearest_context", "gather_tokens"]


def topk_nearest_context(
    anchor: torch.Tensor, point_cloud: torch.Tensor, k: int
) -> torch.Tensor:
    """Indices (B, k) of the k points of (B, P, 3) nearest each (B, 3)
    anchor, nearest first."""
    d2 = torch.sum((anchor[:, None, :] - point_cloud) ** 2, dim=-1)
    return torch.topk(-d2, k, dim=-1).indices


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, P, C) rows picked by (B, K) indices -> (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))
