"""Fine-context selection for Act3D (PyTorch).

Counterpart of ``act3d_tpu/ops/geometry.py::topk_nearest_context`` and
``gather_tokens``.  Selection is exact top-k with JAX's order among ties
(the JAX package's ``approx_topk`` is a TPU feature and is not carried
over).  The token
gather's backward is the row-scatter kernel of ``kernels/gather.py`` at
every width: the TPU routing floor (``c >= 16``) and the
``ACT3D_ONEHOT_GATHER_BWD`` flag stay out of the port.
"""

from __future__ import annotations

import torch

from ..kernels.gather import scatter_rows, scatter_rows_sorted

__all__ = ["topk_nearest_context", "gather_tokens"]


def topk_nearest_context(
    anchor: torch.Tensor, point_cloud: torch.Tensor, k: int
) -> torch.Tensor:
    """Indices (B, k) of the k points of (B, P, 3) nearest each (B, 3)
    anchor, nearest first, equal distances in index order, as
    ``lax.top_k`` orders ties (``torch.topk`` promises no order among them).
    Ties are common under bf16 training: points whose coordinates round to
    the same bf16 values lie at the same distance."""
    d2 = torch.sum((anchor[:, None, :] - point_cloud) ** 2, dim=-1)
    return torch.sort(d2, dim=-1, stable=True).indices[:, :k]


class _GatherTokens(torch.autograd.Function):
    """Forward ``torch.gather`` (``jax.lax.gather`` in JAX); backward the
    row scatter of the unique indices, sorted or not."""

    @staticmethod
    def forward(ctx, x, idx, sorted_indices):
        ctx.save_for_backward(idx)
        ctx.out_rows = x.shape[1]
        ctx.sorted_indices = sorted_indices
        return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        scatter = scatter_rows_sorted if ctx.sorted_indices else scatter_rows
        return scatter(grad, idx, ctx.out_rows), None, None


def gather_tokens(x: torch.Tensor, idx: torch.Tensor, *,
                  sorted_indices: bool = False) -> torch.Tensor:
    """(B, P, C) rows picked by (B, K) indices, unique per row -> (B, K, C).

    ``sorted_indices``: the caller promises ascending indices per row, and
    the backward takes the sorted kernel (Act3D sorts its fine-context
    picks)."""
    return _GatherTokens.apply(x, idx, sorted_indices)
