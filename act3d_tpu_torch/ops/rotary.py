"""Rotary 3D position codes and sinusoidal embeddings (PyTorch).

Counterpart of ``act3d_tpu/ops/rotary.py``.  A position code for N tokens
with feature dim F is ``(..., N, F, 2)``: ``[..., 0]`` the cos half,
``[..., 1]`` the sin half.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rotary_pe_3d", "embed_rotary", "sinusoidal_pos_emb"]


def _duplicate_interleave(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., 2d) via [a, b] -> [a, a, b, b]."""
    return torch.stack([x, x], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def rotary_pe_3d(xyz: torch.Tensor, feature_dim: int) -> torch.Tensor:
    """(..., N, 3) positions -> (..., N, F, 2) stacked (cos, sin) code.

    The F axis is three contiguous thirds, one per spatial axis.
    """
    d_axis = feature_dim // 3
    div_term = torch.exp(
        torch.arange(0, d_axis, 2, dtype=torch.float32, device=xyz.device)
        * (-math.log(10000.0) / d_axis)
    )
    angles = xyz[..., None].float() * div_term  # (..., N, 3, d_axis // 2)
    sin = _duplicate_interleave(torch.sin(angles))
    cos = _duplicate_interleave(torch.cos(angles))
    cos_pos = cos.reshape(cos.shape[:-2] + (3 * d_axis,))
    sin_pos = sin.reshape(sin.shape[:-2] + (3 * d_axis,))
    return torch.stack([cos_pos, sin_pos], dim=-1)


def embed_rotary(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """``x * cos + rotate_pairs(x) * sin`` with (x0, x1) -> (-x1, x0).

    Acts on the full embedding before the head split, so at an odd head
    dim (15) the pairs cross head boundaries, as in the JAX package.
    """
    code = code.to(x.dtype)
    cos, sin = code[..., 0], code[..., 1]
    x2 = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    return x * cos + x2 * sin


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) -> (B, dim) with [sin | cos] halves."""
    half_dim = dim // 2
    emb_scale = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=x.device) * -emb_scale
    )
    angles = x.float()[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
