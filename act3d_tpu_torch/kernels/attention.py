"""Fused multi-head attention forward: CUDA kernel wrapper and plain version.

Replaces ``act3d_tpu/kernels/attention.py::_mha_fwd_body`` (the plain and
key-padding-masked variants, without dropout) with the hand-written
Hopper kernel in ``csrc/fused_mha_fwd.cu``.  The contract is the TPU
kernel's: q (B, L, E) already scaled and rotated, k/v (B, S, E), heads as
contiguous E/H lane slices, softmax in float32, masked keys at -1e30 (a
fully masked row gets uniform weights), and row stats (B, L, 2H) float32
with m at lane 2h and l at lane 2h+1.

:func:`fused_mha_forward` sends a CPU tensor to the plain version
:func:`fused_mha_forward_reference` and a CUDA tensor to the kernel; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["fused_mha_forward", "fused_mha_forward_reference", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 64
MASKED_SCORE = -1e30
_THREADS = 128  # threads of one block (csrc/fused_mha_fwd.cu kThreads)
# blocks wanted per launch before rows are split across more threads:
# two per SM of a 132-SM H100
_TARGET_BLOCKS = 264
_SOURCE = "fused_mha_fwd.cu"


def fused_mha_forward_reference(q, k, v, num_heads, key_padding_mask=None):
    """Plain PyTorch version of the kernel: returns (out, stats)."""
    b, l, e = q.shape
    s = k.shape[1]
    d = e // num_heads
    qh = q.reshape(b, l, num_heads, d).transpose(1, 2).float()
    kh = k.reshape(b, s, num_heads, d).transpose(1, 2).float()
    vh = v.reshape(b, s, num_heads, d).transpose(1, 2).float()
    scores = qh @ kh.transpose(-1, -2)  # (B, H, L, S)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], MASKED_SCORE)
    m = scores.amax(dim=-1, keepdim=True)
    ex = torch.exp(scores - m)
    lsum = ex.sum(dim=-1, keepdim=True)
    o = (ex @ vh) * (1.0 / lsum)
    out = o.transpose(1, 2).reshape(b, l, e).to(q.dtype)
    stats = torch.stack([m[..., 0], lsum[..., 0]], dim=-1)  # (B, H, L, 2)
    stats = stats.permute(0, 2, 1, 3).reshape(b, l, 2 * num_heads)
    return out, stats


def _threads_per_row(b: int, l: int, h: int) -> int:
    """Threads sharing one query row: split rows until the launch has
    enough blocks to fill the card (small L, e.g. the 50-row sampler
    sites, gets up to a warp per row)."""
    tpr = 1
    while tpr < 32 and b * h * -(-l // (_THREADS // tpr)) < _TARGET_BLOCKS:
        tpr *= 2
    return tpr


def _kernel_fn():
    from . import _build

    lib = _build.load(_SOURCE)
    fn = lib.act3d_fused_mha_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, num_heads, mask):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, L, E), (B, S, E), (B, S, E)")
    b, _, e = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if e % num_heads != 0:
        raise ValueError(f"E={e} does not divide into {num_heads} heads")
    if k.shape[1] < 1:
        raise ValueError("attention over an empty context")
    devices = {q.device, k.device, v.device}
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, k.shape[1]):
            raise ValueError("key_padding_mask must be a (B, S) bool tensor")
        devices.add(mask.device)
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def fused_mha_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Multi-head softmax attention core on (B, L, E) tensors.

    key_padding_mask: optional (B, S) bool, True = masked out.
    Returns out (B, L, E), or (out, stats) with ``return_stats``.
    """
    _check(q, k, v, num_heads, key_padding_mask)
    if q.device.type == "cpu":
        out, stats = fused_mha_forward_reference(q, k, v, num_heads, key_padding_mask)
    elif q.device.type == "cuda":
        out, stats = _launch(q, k, v, num_heads, key_padding_mask)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (out, stats) if return_stats else out


fused_mha_forward.launches = 0  # kernel launches since the last reset


def _launch(q, k, v, num_heads, mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{name} is {t.dtype}: the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask is not None and not mask.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous")
    b, l, e = q.shape
    s = k.shape[1]
    d = e // num_heads
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(f"head dim {d} > {MAX_HEAD_DIM}")
    fn = _kernel_fn()
    out = torch.empty_like(q)
    stats = torch.empty((b, l, 2 * num_heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), stats.data_ptr(),
            b, l, s, num_heads, d, _threads_per_row(b, l, num_heads), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mha_fwd launch failed: CUDA error {rc}")
    fused_mha_forward.launches += 1
    return out, stats
