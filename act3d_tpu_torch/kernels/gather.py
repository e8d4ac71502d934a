"""Row-gather adjoint: CUDA kernel wrappers and their plain version.

Replaces ``act3d_tpu/kernels/gather.py::onehot_scatter_rows_sorted`` and
``onehot_scatter_rows`` with ``csrc/scatter_rows.cu``, hand-written for
Hopper.  The contract is the TPU kernels': for a cotangent g (B, K, C) of
rows gathered at idx (B, K), unique per batch row,

    dx[b, p, :] = sum_j [idx[b, j] == p] * g[b, j, :]     (B, P, C)

which, the indices being unique, is one copy of a g row or zeros per output
row: exact, with no accumulation.  :func:`scatter_rows_sorted` also needs
the indices ascending per row (Act3D sorts its fine-context picks); that is
the caller's promise, as in JAX, and is not checked on the hot path.

Both wrappers send a CPU tensor to :func:`scatter_rows_reference` (the slot
map of ``act3d_tpu/ops/geometry.py::_slot_map_bwd`` in torch ops) and a
CUDA tensor to the kernel: on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["scatter_rows", "scatter_rows_reference", "scatter_rows_sorted"]

_SOURCE = "scatter_rows.cu"


def scatter_rows_reference(g: torch.Tensor, idx: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the inverse slot map
    ``inv[b, idx[b, j]] = j + 1``, then a dense row gather of g where a
    slot is set and zeros elsewhere."""
    b, k, c = g.shape
    inv = torch.zeros((b, out_rows), dtype=torch.int64, device=g.device)
    inv.scatter_(1, idx.long(), torch.arange(1, k + 1, device=g.device).expand(b, k))
    rows = torch.gather(g, 1, (inv - 1).clamp_min(0)[..., None].expand(b, out_rows, c))
    return rows.masked_fill(inv[..., None] == 0, 0.0)


def _check(g, idx, out_rows):
    if g.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != tuple(g.shape[:2]):
        raise ValueError(f"g must be (B, K, C) and idx (B, K): g {tuple(g.shape)} "
                         f"idx {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx is {idx.dtype}: an integer index tensor is needed")
    if min(g.shape) < 1 or out_rows < 1:
        raise ValueError(f"empty scatter: g {tuple(g.shape)}, out_rows {out_rows}")
    if g.device != idx.device:
        raise ValueError(f"tensors on several devices: {g.device}, {idx.device}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")


def _fn(name: str, n_pointers: int):
    from . import _build

    fn = getattr(_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(g, idx, out_rows, sorted_indices):
    if g.dtype != torch.float32:
        raise NotImplementedError(f"g is {g.dtype}: the kernel takes float32")
    if g.stride(2) != 1:
        raise ValueError("g must have unit stride along C")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int64 tensor on the card")
    b, k, c = g.shape
    # float4 rows: C % 4 == 0 and every g row 16-byte aligned (out is fresh)
    vec = int(c % 4 == 0 and g.data_ptr() % 16 == 0
              and g.stride(0) % 4 == 0 and g.stride(1) % 4 == 0)
    out = torch.empty((b, out_rows, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        shape = (b, k, out_rows, c, g.stride(0), g.stride(1), vec, stream)
        if sorted_indices:
            rc = _fn("act3d_scatter_rows_sorted_f32", 3)(
                g.data_ptr(), idx.data_ptr(), out.data_ptr(), *shape)
        else:
            inv = torch.empty((b, out_rows), dtype=torch.int32, device=g.device)
            rc = _fn("act3d_scatter_rows_f32", 4)(
                g.data_ptr(), idx.data_ptr(), inv.data_ptr(), out.data_ptr(), *shape)
    if rc != 0:
        raise RuntimeError(f"scatter_rows launch failed: CUDA error {rc}")
    return out


def scatter_rows_sorted(g: torch.Tensor, idx: torch.Tensor, out_rows: int) -> torch.Tensor:
    """(B, P, C) adjoint of a row gather at unique, ascending idx (B, K)."""
    _check(g, idx, out_rows)
    if g.device.type == "cpu":
        return scatter_rows_reference(g, idx, out_rows)
    out = _launch(g, idx, out_rows, sorted_indices=True)
    scatter_rows_sorted.launches += 1
    return out


scatter_rows_sorted.launches = 0  # kernel launches since the last reset


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, out_rows: int) -> torch.Tensor:
    """(B, P, C) adjoint of a row gather at unique idx (B, K) in any order."""
    _check(g, idx, out_rows)
    if g.device.type == "cpu":
        return scatter_rows_reference(g, idx, out_rows)
    out = _launch(g, idx, out_rows, sorted_indices=False)
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0  # kernel launches since the last reset
