"""Nearest-point context selection and the token gather (PyTorch).

Counterpart of ``act3d_tpu/ops/geometry.py::find_traj_nn``,
``topk_nearest_context``, ``gather_tokens`` and ``find_cylinder_points``.
Exact selections keep JAX's order among equal distances (``lax.top_k``:
the lower index first).  ``find_traj_nn.calls`` counts the trajectory-nearest
selections (``utils/graphs.py``).
The token gather's backward is the row-scatter kernel of
``kernels/gather.py`` at every width: the TPU routing floor (``c >= 16``)
and the ``ACT3D_ONEHOT_GATHER_BWD`` flag stay out of the port.
"""

from __future__ import annotations

import torch

from ..kernels.gather import scatter_rows, scatter_rows_sorted
from ..utils.graphs import counted

__all__ = ["find_traj_nn", "topk_nearest_context", "gather_tokens", "find_cylinder_points"]


def _nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k smallest of (B, P) distances, nearest first,
    equal distances in index order, as ``lax.top_k`` orders ties
    (``torch.topk`` promises no order among them).  Ties are common under
    bf16 training (points whose coordinates round to the same bf16 values
    lie at the same distance) and among duplicate points; which of the
    equal distances at the k-th place are kept changes the selected set."""
    return torch.sort(d2, dim=-1, stable=True).indices[:, :k]


def find_traj_nn(trajectory: torch.Tensor, point_cloud: torch.Tensor,
                 nn_per_step: int = 64) -> torch.Tensor:
    """Indices (B, nn_per_step * L) of the cloud points (B, P, 3) nearest to
    any point of the (B, L, 3) trajectory (distance to the nearest
    trajectory point), nearest first, ties in index order.  The indices carry
    no gradient, so the (B, L, P) distances are not kept for a backward."""
    find_traj_nn.calls += 1
    trajectory, point_cloud = trajectory.detach(), point_cloud.detach()
    d2 = torch.sum((trajectory[:, :, None, :] - point_cloud[:, None, :, :]) ** 2, dim=-1)
    return _nearest(torch.amin(d2, dim=1), nn_per_step * trajectory.shape[1])


counted(find_traj_nn, "calls")


def topk_nearest_context(anchor: torch.Tensor, point_cloud: torch.Tensor, k: int,
                         approx: bool = False) -> torch.Tensor:
    """Indices (B, k) of the k points of (B, P, 3) nearest each (B, 3)
    anchor, nearest first, ties in index order.

    ``approx`` (JAX's ``approx_topk``: ``lax.approx_max_k``, recall ~0.95 on
    the TPU, exact on the CPU): on the CPU the same exact selection; on the
    card ``torch.topk(sorted=False)``, which keeps the exact set of the k
    nearest except which of the points tied with the k-th distance are
    kept, in no particular order (Act3D sorts the indices after)."""
    d2 = torch.sum((anchor[:, None, :] - point_cloud) ** 2, dim=-1)
    if approx and d2.is_cuda:
        return torch.topk(d2, k, dim=-1, largest=False, sorted=False).indices
    return _nearest(d2, k)


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


def find_cylinder_points(start: torch.Tensor, end: torch.Tensor, num_points: int,
                         point_cloud: torch.Tensor) -> torch.Tensor:
    """(B, P) bool mask of the cloud points (B, P, 3) within the 'cylinder'
    around the segments start -> end (B, 3) (reference
    model/utils/utils.py:7-35): the union of balls centred on
    ``num_points`` samples of the segment, of radius the largest per-axis
    extent of ``end - start``.  JAX's arithmetic: the (B, n, P) Euclidean
    distances compared with ``<=``."""
    size = torch.amax(torch.abs(end - start), dim=1)  # (B,)
    ts = torch.arange(num_points, device=start.device, dtype=start.dtype)
    slope = (end - start) / (num_points - 1)
    line = start[:, None, :] + slope[:, None, :] * ts[None, :, None]  # (B, n, 3)
    d = torch.sqrt(torch.sum((line[:, :, None, :] - point_cloud[:, None, :, :]) ** 2, dim=-1))
    return torch.any(d <= size[:, None, None], dim=1)
