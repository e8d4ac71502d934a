"""Row-gather adjoint: CUDA kernel wrappers and their plain version.

Replaces ``act3d_tpu/kernels/gather.py::onehot_scatter_rows_sorted``,
``onehot_scatter_rows`` and ``onehot_scatter_rows_chunked`` with the three
entries of ``csrc/scatter_rows.cu``, hand-written for Hopper.  The
contract is the TPU kernels': for a cotangent g (B, K, C) of
rows gathered at idx (B, K), unique per batch row,

    dx[b, p, :] = sum_j [idx[b, j] == p] * g[b, j, :]     (B, P, C)

which, the indices being unique, is one copy of a g row or zeros per output
row: exact, with no accumulation.  :func:`scatter_rows_sorted` and
:func:`scatter_rows_chunked` also need the indices ascending per row
(Act3D sorts its fine-context picks); that is the caller's promise, as in
JAX, and is not checked on the hot path.  The chunked function has no
model path, in JAX as here; its ``p_tile`` and ``n_chunks`` split the work
on the TPU and change neither the result nor, on the card, the grid: it
launches the sorted entry (:func:`launch_shape` gives the grid).

Every wrapper sends a CPU tensor to :func:`scatter_rows_reference` (the
slot map of ``act3d_tpu/ops/geometry.py::_slot_map_bwd`` in torch ops) and
a CUDA tensor to its kernel: on a CUDA tensor it launches the kernel or
raises.  g may be float32 or bfloat16 (``--mixed_precision 1``), each with
its own kernel entry; a copy needs no arithmetic, so both are exact.  Each
wrapper counts float32 launches in ``launches`` and bf16 launches in
``launches_bf16``.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch
from ..utils.graphs import counted

__all__ = ["scatter_rows", "scatter_rows_chunked", "scatter_rows_reference",
           "scatter_rows_sorted"]

_SOURCE = "scatter_rows.cu"
# the largest p_tile JAX's chunked kernel takes (its shared-memory slot table
# of p_tile ints), kept as the chunked function's contract
_MAX_CHUNKED_TILE = 57344


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


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _fn(name: str, n_pointers: int):
    """The C entry ``name``: pointers, then (B, K, P, C, g's two strides,
    vec or the access width), then the stream."""
    from . import _build

    fn = getattr(_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_shape(b: int, out_rows: int) -> dict:
    """The grid and block every entry's row-writing kernel launches for
    (B, P), as the C side computes them (builds the library)."""
    from . import _build

    fn = _build.load(_SOURCE).act3d_scatter_rows_launch_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    fn.restype = None
    shape = (ctypes.c_int64 * 4)()
    fn(b, out_rows, shape)
    return dict(x=shape[0], y=shape[1], threads=shape[2], rows_per_block=shape[3])


def access_bytes(g: torch.Tensor) -> int:
    """The widest access (16, 8 or 4 bytes, else one element) that every g
    row and every output row start on and that divides a row: the float32
    entries take 16 (float4) or 4, the bf16 entries any of 16, 8, 4, 2 (a
    C = 60 bf16 row is 120 bytes: 8-byte accesses)."""
    size = g.element_size()
    row = g.shape[2] * size
    for width in (16, 8, 4):
        if width == 8 and g.dtype == torch.float32:
            continue
        if (row % width == 0 and g.data_ptr() % width == 0
                and (g.stride(0) * size) % width == 0 and (g.stride(1) * size) % width == 0):
            return width
    return size


def _launch(g, idx, out_rows, entry):
    """Launch the "sorted" or the "unsorted" entry on CUDA tensors."""
    if g.dtype not in _SUFFIX:
        raise NotImplementedError(f"g is {g.dtype}: the kernels take float32 or bfloat16")
    if g.stride(2) != 1:
        raise ValueError("g must have unit stride along C")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int64 tensor on the card")
    b, k, c = g.shape
    width = access_bytes(g)  # out is fresh, so its rows start where g's can
    # the float32 entries take vec (float4 or not); the bf16 ones the width
    vec = int(width == 16) if g.dtype == torch.float32 else width
    suffix = _SUFFIX[g.dtype]
    out = torch.empty((b, out_rows, c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        shape = (b, k, out_rows, c, g.stride(0), g.stride(1), vec, stream)
        if entry == "sorted":
            rc = _fn(f"act3d_scatter_rows_sorted_{suffix}", 3)(
                g.data_ptr(), idx.data_ptr(), out.data_ptr(), *shape)
        else:
            inv = torch.empty((b, out_rows), dtype=torch.int32, device=g.device)
            rc = _fn(f"act3d_scatter_rows_{suffix}", 4)(
                g.data_ptr(), idx.data_ptr(), inv.data_ptr(), out.data_ptr(), *shape)
    if rc != 0:
        raise RuntimeError(f"scatter_rows launch failed: CUDA error {rc}")
    return out



def scatter_rows_sorted(g: torch.Tensor, idx: torch.Tensor, out_rows: int) -> torch.Tensor:
    """(B, P, C) adjoint of a row gather at unique, ascending idx (B, K)."""
    _check(g, idx, out_rows)
    if g.device.type == "cpu":
        return scatter_rows_reference(g, idx, out_rows)
    out = _launch(g, idx, out_rows, "sorted")
    count_launch(scatter_rows_sorted, g.dtype)
    return out


counted(scatter_rows_sorted, "launches", "launches_bf16")


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, out_rows: int) -> torch.Tensor:
    """(B, P, C) adjoint of a row gather at unique idx (B, K) in any order."""
    _check(g, idx, out_rows)
    if g.device.type == "cpu":
        return scatter_rows_reference(g, idx, out_rows)
    out = _launch(g, idx, out_rows, "unsorted")
    count_launch(scatter_rows, g.dtype)
    return out


counted(scatter_rows, "launches", "launches_bf16")


def scatter_rows_chunked(g: torch.Tensor, idx: torch.Tensor, out_rows: int,
                         p_tile: int = 256, n_chunks: int = 4) -> torch.Tensor:
    """(B, P, C) adjoint of a row gather at unique, ascending idx (B, K): the
    function of :func:`scatter_rows_sorted`, with JAX's signature and
    defaults.  ``p_tile`` (output rows per tile, at most 57344) and
    ``n_chunks`` (TPU grid steps per batch row, each walking its run of
    tiles) set only how the TPU splits the work, never the result: on the
    card they are checked and the sorted entry's kernel launches."""
    _check(g, idx, out_rows)
    if not 1 <= p_tile <= _MAX_CHUNKED_TILE or n_chunks < 1:
        raise ValueError(f"p_tile {p_tile} outside [1, {_MAX_CHUNKED_TILE}] or "
                         f"n_chunks {n_chunks} < 1")
    if g.device.type == "cpu":
        return scatter_rows_reference(g, idx, out_rows)
    out = _launch(g, idx, out_rows, "sorted")
    count_launch(scatter_rows_chunked, g.dtype)
    return out


counted(scatter_rows_chunked, "launches", "launches_bf16")
