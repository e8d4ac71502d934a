"""Fused multi-head attention: CUDA kernel wrappers and plain versions.

Replaces ``act3d_tpu/kernels/attention.py::_mha_fwd_body`` (plain, masked
and dropout variants) with ``csrc/fused_mha_fwd.cu`` and
``_mha_bwd_body`` with ``csrc/fused_mha_bwd.cu``, both hand-written for
Hopper.  The contract is the TPU kernels': q (B, L, E) already scaled and
rotated, k/v (B, S, E), heads as contiguous E/H lane slices, softmax in
float32, masked keys at -1e30 (a fully masked row gets uniform weights),
row stats (B, L, 2H) float32 with m at lane 2h and l (summed before
dropout) at lane 2h+1, and attention-weight dropout applied inside the
kernels: keep = hash bits >= rate * 2^32, kept weights scaled by
1/(1-rate).

The keep mask is a pure function of (seed, b0 + b, h, row, col) in
absolute coordinates (``csrc/dropout_hash.cuh``, mirrored by
:func:`dropout_keep`), so the forward, the backward and the plain versions
regenerate the same mask whatever their tiling.  The seed is an int, a
launch argument, or a seed slot: a one-element int32 tensor on the device
(``ops/attention.py::SeedTape``), whose pointer the C entries take beside
the seed argument and whose word their kernels read when they run, so
that a CUDA graph captured over the call drops with the seed the slot
holds at each replay.
``dropout_b0`` is the rows' offset in the global batch: under data
parallelism rank r passes r x (local batch), so its rows drop what a
one-device run drops for them
(0 on one device, the masks of earlier releases).  The TPU kernel's own bits cannot be
reproduced; the contract is semantic.

:func:`fused_mha_forward` and :func:`fused_mha_backward` send a CPU tensor
to their plain versions and a CUDA tensor to the kernels: on a CUDA tensor
they launch the kernel or raise.  :class:`FusedMHA` puts the two behind
autograd.

:func:`attention_core` replaces the single-head-layout TPU kernel
``_attention_core_fwd_impl`` ((B·H, L, D) tensors, an optional (B·H, S)
mask, no stats) with the forward kernel at B = B·H, H = 1, its stats
skipped, launched with the fused sites' plan (:func:`fwd_plan` at one
head, the same blocks as a (B, L, H·D) call); its backward is the TPU kernel's jnp VJP in
torch ops.  As in JAX, no model path calls it.

bf16: every wrapper also takes bfloat16 q, k, v (and dO), the dtype of
``--mixed_precision 1`` training, and launches the bf16 entries of the
same sources.  Products take bf16 operands with float32 sums, the softmax
and the stats stay float32, and values are rounded to bf16 where the TPU
kernels round them (``ex.astype(v.dtype)`` before p v, dO scaled by r
/ (1 - rate), ds and q scaled by r before their products); the outputs are
bf16.  The plain versions round at the same points, so that both compute
JAX's function.  The bf16 entries have two bodies, picked by shape in
:func:`fwd_plan_bf16` / :func:`bwd_plan_bf16`: Hopper's wgmma with
bulk-copy rings (``csrc/mha_wgmma_bf16.cuh``) and an mma.sync body for
short query blocks and d > 32.  Each wrapper counts float32 launches in
``launches`` and bf16 launches in ``launches_bf16``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from . import count_launch
from ..utils.graphs import counted

__all__ = [
    "AttentionCore",
    "BwdPlan",
    "WgBwdPlan",
    "WgFwdPlan",
    "FusedMHA",
    "FwdPlan",
    "MAX_HEAD_DIM",
    "attention_core",
    "attention_core_forward",
    "attention_core_reference",
    "bwd_plan",
    "bwd_plan_bf16",
    "dropout_keep",
    "fused_mha_backward",
    "fused_mha_backward_reference",
    "fused_mha_forward",
    "fused_mha_forward_reference",
    "fwd_plan",
    "fwd_plan_bf16",
    "is_seed_slot",
    "launch_plans",
]

MAX_HEAD_DIM = 64
MASKED_SCORE = -1e30
_FWD_SOURCE = "fused_mha_fwd.cu"
_BWD_SOURCE = "fused_mha_bwd.cu"

# ---------------------------------------------------------------- keep mask
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SEED_SALT = 0x85EBCA6B  # keeps an int31 seed off mix32's fixed point 0


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (an int64 tensor or an int) and a
    constant c: the product is taken on 16-bit halves of x so that nothing
    overflows int64."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    """lowbias32, as act3d_mix32 in csrc/dropout_hash.cuh."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def is_seed_slot(seed) -> bool:
    """Whether ``seed`` is a seed slot: a one-element int32 tensor."""
    return isinstance(seed, torch.Tensor) and seed.dtype == torch.int32 and seed.numel() == 1


def keep_threshold(rate: float) -> int:
    """Drop with probability ``rate``: bits < rate * 2^32."""
    return min(int(rate * 2.0**32), _M32)


def dropout_bits(seed: int, b: int, h: int, l: int, s: int, device="cpu", b0: int = 0):
    """(B, H, L, S) int64 hash bits in [0, 2^32), as the kernels draw them
    for batch rows b0 .. b0 + B - 1."""
    def idx(n, shape, start=0):
        return torch.arange(start, start + n, dtype=torch.int64, device=device).reshape(shape)

    if is_seed_slot(seed):  # hashed on its device: no device-host copy
        key = _mix32((seed.reshape(()).to(torch.int64) & _M32) ^ _SEED_SALT)
    else:
        key = _mix32((seed & _M32) ^ _SEED_SALT)  # a Python int: no host-device copy
    key = _mix32(key ^ idx(b, (b, 1, 1), b0))
    key = _mix32(key ^ idx(h, (1, h, 1)))
    key = _mix32(key ^ idx(l, (1, 1, l)))  # row keys (B, H, L)
    return _mix32(key[..., None] ^ _mul32(idx(s, (s,)), _GOLDEN))


def dropout_keep(seed: int, b: int, h: int, l: int, s: int, rate: float,
                 device="cpu", b0: int = 0) -> torch.Tensor:
    """(B, H, L, S) bool keep mask of the kernels' attention dropout, for
    batch rows b0 .. b0 + B - 1: rows b0.. of the mask of a batch of
    b0 + B."""
    return dropout_bits(seed, b, h, l, s, device, b0) >= keep_threshold(rate)


# ----------------------------------------------------------- plain versions
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _split(x, num_heads):
    b, n, e = x.shape
    return x.reshape(b, n, num_heads, e // num_heads).transpose(1, 2).float()


def _round(x, dtype):
    """float32 x rounded to ``dtype`` where the TPU kernel casts it to the
    input dtype (a no-op at float32), back in float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _merge(x, dtype):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def _keep_or_none(keep, seed, rate, b, h, l, s, device, b0):
    if rate <= 0.0:
        return None
    if keep is None:
        keep = dropout_keep(seed, b, h, l, s, rate, device, b0)
    return keep


def _scores(qh, kh, key_padding_mask):
    scores = qh @ kh.transpose(-1, -2)  # (B, H, L, S)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], MASKED_SCORE)
    return scores


def fused_mha_forward_reference(q, k, v, num_heads, key_padding_mask=None,
                                dropout_rate: float = 0.0, dropout_seed=None,
                                keep=None, dropout_b0: int = 0):
    """Plain PyTorch version of the forward kernel: returns (out, stats).

    ``keep`` (B, H, L, S) bool replaces the hash mask (tests feed another
    implementation's mask through it).  At bf16 the unnormalised weights
    are rounded to bf16 before p v, as ``_mha_fwd_body`` does."""
    b, l, _ = q.shape
    s = k.shape[1]
    qh, kh, vh = (_split(x, num_heads) for x in (q, k, v))
    scores = _scores(qh, kh, key_padding_mask)
    m = scores.amax(dim=-1, keepdim=True)
    ex = torch.exp(scores - m)
    lsum = ex.sum(dim=-1, keepdim=True)  # before dropout
    keep = _keep_or_none(keep, dropout_seed, dropout_rate, b, num_heads, l, s, q.device,
                         dropout_b0)
    scale = 1.0 / lsum
    if keep is not None:
        ex = ex * keep
        scale = scale * (1.0 / (1.0 - dropout_rate))
    out = _merge((_round(ex, v.dtype) @ vh) * scale, q.dtype)
    stats = torch.stack([m[..., 0], lsum[..., 0]], dim=-1)  # (B, H, L, 2)
    stats = stats.permute(0, 2, 1, 3).reshape(b, l, 2 * num_heads)
    return out, stats


def _delta(out, grad_out, num_heads):
    """rowsum(dO * O) per head, (B, L, H) float32."""
    b, l, e = out.shape
    prod = grad_out.float() * out.float()
    return prod.reshape(b, l, num_heads, e // num_heads).sum(dim=-1)


def fused_mha_backward_reference(q, k, v, out, stats, grad_out, num_heads,
                                 key_padding_mask=None, dropout_rate: float = 0.0,
                                 dropout_seed=None, keep=None, dropout_b0: int = 0):
    """Plain PyTorch version of the backward kernel (the formula of the TPU
    kernel's ``_mha_bwd_body``): returns (dq, dk, dv).  bf16 inputs take
    :func:`_backward_reference_low`, which rounds where that body does."""
    if q.dtype != torch.float32:
        return _backward_reference_low(q, k, v, out, stats, grad_out, num_heads,
                                       key_padding_mask, dropout_rate, dropout_seed, keep,
                                       dropout_b0)
    b, l, _ = q.shape
    s = k.shape[1]
    qh, kh, vh, gh = (_split(x, num_heads) for x in (q, k, v, grad_out))
    st = stats.reshape(b, l, num_heads, 2).permute(0, 2, 1, 3)  # (B, H, L, 2)
    m, lsum = st[..., :1], st[..., 1:]
    delta = _delta(out, grad_out, num_heads).transpose(1, 2)[..., None]  # (B, H, L, 1)
    p = torch.exp(_scores(qh, kh, key_padding_mask) - m) / lsum
    dp = gh @ vh.transpose(-1, -2)
    keep = _keep_or_none(keep, dropout_seed, dropout_rate, b, num_heads, l, s, q.device,
                         dropout_b0)
    pk = p
    if keep is not None:
        inv_keep = 1.0 / (1.0 - dropout_rate)
        pk = p * keep * inv_keep
        dp = dp * keep * inv_keep
    ds = p * (dp - delta)
    dv = pk.transpose(-1, -2) @ gh
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _backward_reference_low(q, k, v, out, stats, grad_out, num_heads, key_padding_mask,
                            dropout_rate, dropout_seed, keep, dropout_b0):
    """The backward at a low-precision input dtype, in ``_mha_bwd_body``'s
    order: unnormalised ex = exp(s - m); dv = round(ex_kept)^T dof with
    dof = round(dO r / (1 - rate)); ds = round(ex (dp_kept - delta));
    dq = (ds k) r; dk = ds^T round(q r).  Products in float32 of the
    rounded operands, outputs in the input dtype."""
    b, l, _ = q.shape
    s = k.shape[1]
    dt = q.dtype
    qh, kh, vh, gh = (_split(x, num_heads) for x in (q, k, v, grad_out))
    st = stats.reshape(b, l, num_heads, 2).permute(0, 2, 1, 3)  # (B, H, L, 2)
    m, r = st[..., :1], 1.0 / st[..., 1:]
    delta = _delta(out, grad_out, num_heads).transpose(1, 2)[..., None]  # (B, H, L, 1)
    ex = torch.exp(_scores(qh, kh, key_padding_mask) - m)
    dp = gh @ vh.transpose(-1, -2)
    keep = _keep_or_none(keep, dropout_seed, dropout_rate, b, num_heads, l, s, q.device,
                         dropout_b0)
    inv_keep = 1.0 / (1.0 - dropout_rate) if keep is not None else 1.0
    ex_kept = ex
    if keep is not None:
        ex_kept = ex * keep
        dp = torch.where(keep, dp * inv_keep, 0.0)
    dof = _round(gh * (r * inv_keep), dt)
    dv = _round(ex_kept, dt).transpose(-1, -2) @ dof
    ds = _round(ex * (dp - delta), dt)
    dq = (ds @ kh) * r
    dk = ds.transpose(-1, -2) @ _round(qh * r, dt)
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


# ------------------------------------------------------------------ wrappers
# Launch plans of the two fused-MHA kernels.  The constants below were
# chosen by same-call A/Bs on the card (scripts/ab_fused_mha_plans.py; the
# numbers are in PERF.md): blocks wanted per launch before keys (forward) or rows
# (backward) are split, the forward's largest query tile and smallest key
# chunk, and the backward's key tile.
FWD_TARGET_BLOCKS = 528
FWD_MAX_WARPS = 4
FWD_MIN_CHUNK = 64
BWD_TARGET_BLOCKS = 264
BWD_KEY_WARPS = 4
_SPLIT_ROWS = 16  # granularity of the backward's L split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class FwdPlan(NamedTuple):
    """Launch of ``csrc/fused_mha_fwd.cu``: ``warps`` warps of 16 query rows
    per block, ``q_tiles`` query tiles, the keys cut into ``nsplit`` chunks
    of ``chunk`` keys; with nsplit > 1 a workspace of ``workspace_floats``
    (partial accumulators then partial (m, l)) and a combine kernel."""

    warps: int
    q_tiles: int
    chunk: int
    nsplit: int
    blocks: int
    workspace_floats: int
    kernels: int


class BwdPlan(NamedTuple):
    """Launch of ``csrc/fused_mha_bwd.cu``: ``key_warps`` warps of 16 keys
    per block, ``key_tiles`` key tiles, L cut into ``nsplit`` splits of
    ``rows_per_split`` rows; a workspace of ``dq_floats`` (per-key-tile dq
    slabs, when key_tiles > 1) followed by ``dkv_floats`` (per-split dk and
    dv slabs, when nsplit > 1), each summed by one more kernel."""

    key_warps: int
    key_tiles: int
    rows_per_split: int
    nsplit: int
    blocks: int
    dq_floats: int
    dkv_floats: int
    kernels: int

    @property
    def workspace_floats(self) -> int:
        return self.dq_floats + self.dkv_floats


def fwd_plan(b: int, l: int, s: int, h: int, d: int,
             target_blocks: int = FWD_TARGET_BLOCKS, max_warps: int = FWD_MAX_WARPS,
             min_chunk: int = FWD_MIN_CHUNK) -> FwdPlan:
    """Query tile: the fewest warps (up to ``max_warps``) that cover L.
    When query tiles x H x B give fewer than ``target_blocks`` blocks, the
    keys are split into chunks (a multiple of 8 keys, at least
    ``min_chunk``) so that the launch reaches it (flash-decoding)."""
    warps = 1
    while warps < max_warps and 16 * warps < l:
        warps *= 2
    q_tiles = _cdiv(l, 16 * warps)
    base = q_tiles * h * b
    chunk = s
    if base < target_blocks:
        chunk = min(s, max(min_chunk, 8 * _cdiv(_cdiv(s, _cdiv(target_blocks, base)), 8)))
    nsplit = _cdiv(s, chunk)
    work = nsplit * b * l * (h * d + 2 * h) if nsplit > 1 else 0
    return FwdPlan(warps, q_tiles, chunk, nsplit, base * nsplit, work,
                   1 + (nsplit > 1))


def bwd_plan(b: int, l: int, s: int, h: int, d: int,
             target_blocks: int = BWD_TARGET_BLOCKS,
             key_warps: int = BWD_KEY_WARPS) -> BwdPlan:
    """Key tile: ``key_warps`` warps of 16 keys, fewer for a short context.
    When key tiles x H x B give fewer than ``target_blocks`` blocks, L is
    split (a multiple of 16 rows per split)."""
    kw = key_warps
    while kw > 1 and 16 * (kw // 2) >= s:
        kw //= 2
    key_tiles = _cdiv(s, 16 * kw)
    base = key_tiles * h * b
    rows = l
    if base < target_blocks and l > _SPLIT_ROWS:
        rows = _SPLIT_ROWS * _cdiv(_cdiv(l, _cdiv(target_blocks, base)), _SPLIT_ROWS)
    nsplit = _cdiv(l, rows)
    e = h * d
    dq_floats = key_tiles * b * l * e if key_tiles > 1 else 0
    dkv_floats = 2 * nsplit * b * s * e if nsplit > 1 else 0
    return BwdPlan(kw, key_tiles, rows, nsplit, base * nsplit, dq_floats, dkv_floats,
                   1 + (key_tiles > 1) + (nsplit > 1))


# The bf16 bodies on wgmma (csrc/mha_wgmma_bf16.cuh): 64-row query tiles
# (wgmma's M), key tiles of WG_KEYS through a ring of WG_STAGES stages, 64-key
# blocks in the backward's dk/dv pass, and up to WG_MAX_GROUP heads (one
# warpgroup each) per block.  The plan constants below were chosen by
# same-call A/Bs on the card (scripts/ab_fused_mha_plans.py, PERF.md): the
# forward's head groups per batch row where a block's heads share staged
# K/V slabs over several key tiles (two blocks share each tile's copies),
# its heads per block where they share nothing (key records, or a single
# key tile), the backward's most heads per block, the blocks wanted per
# launch before the keys (forward, dq) or the rows (dk/dv) are split, the
# fewest rows per dk/dv split, the fewest heads per block the dq pass goes
# down to before it splits the keys, and the smallest key chunk.
WG_ROWS = 64
WG_KEYS = 64  # csrc/mha_wgmma_bf16.cuh's ACT3D_WG_KEY_TILE
WG_STAGES = 4  # its ACT3D_WG_STAGES
WG_MAX_GROUP = 4
WG_FWD_HEAD_GROUPS = 2
WG_FWD_SOLO_GROUP = 1
WG_FWD_TARGET_BLOCKS = 132
WG_FWD_MIN_CHUNK = 768
WG_BWD_MAX_GROUP = 2
WG_BWD_TARGET_BLOCKS = 528
WG_BWD_MIN_ROWS = 384
WG_DQ_TARGET_BLOCKS = 132
WG_DQ_MIN_GROUP = 2
# Shapes the mma.sync bf16 body keeps: the forward at L <= 16 (one row of a
# 64-row wgmma tile), the backward at L <= 64 (one row tile per key block:
# the mma.sync body's single pass beat the two wgmma passes there), and its
# plans' blocks wanted before the keys (forward) or rows (backward) split.
FWD_MMA_MAX_ROWS = 16
BWD_MMA_MAX_ROWS = 64
MMA_FWD_TARGET_BLOCKS = 528
MMA_BWD_KEY_WARPS = 4
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


class WgFwdPlan(NamedTuple):
    """Launch of the bf16 forward's wgmma body (``csrc/fused_mha_fwd.cu``,
    ``mha_fwd_bf16_wgmma_kernel``): ``group`` heads per block, ``q_tiles``
    tiles of 64 query rows, the keys cut into ``nsplit`` chunks of ``chunk``
    keys.  With ``prep`` a prep kernel first writes the key records (each
    head's operand tiles, read in place by the main kernel) to the
    workspace; with nsplit > 1 the partial accumulators, partial (m, l) and
    one int counter per tile and head group follow, the chunks combined in
    the same launch by the last block of a tile."""

    group: int
    q_tiles: int
    chunk: int
    nsplit: int
    prep: bool
    blocks: int
    workspace_floats: int
    kernels: int


class WgBwdPlan(NamedTuple):
    """Launch of the bf16 backward's two wgmma passes (``csrc/fused_mha_bwd.cu``):
    dk/dv over ``key_tiles`` tiles of 64 keys with ``group`` heads per block,
    L cut into ``nsplit`` splits of ``rows_per_split`` rows (``dkv_floats``
    of float32 dk/dv slabs and a summing kernel when nsplit > 1); dq over
    ``q_tiles`` tiles of 64 rows with ``dq_group`` heads per block, the keys
    in ``dq_nsplit`` chunks of ``dq_chunk`` keys (``dq_floats`` of partials
    and counters when dq_nsplit > 1, combined in the same launch).  Two prep
    kernels first write the row records (read by the dk/dv pass) and the key
    records (read by the dq pass), ``record_floats`` at the start of the
    workspace."""

    group: int
    key_tiles: int
    rows_per_split: int
    nsplit: int
    dq_group: int
    q_tiles: int
    dq_chunk: int
    dq_nsplit: int
    blocks: int
    dq_blocks: int
    record_floats: int
    dkv_floats: int
    dq_floats: int
    kernels: int

    @property
    def workspace_floats(self) -> int:
        return self.record_floats + self.dkv_floats + self.dq_floats


def _head_pad(d: int) -> int:
    return 16 if d <= 16 else 32 if d <= 32 else 64


def record_bytes(kind: str, dp: int) -> int:
    """Bytes of one head's operand record over a 64-long tile
    (csrc/mha_wgmma_bf16.cuh's act3d_record_bytes): "fwd_keys" V^T and K,
    "dq_keys" K, V and K^T, "rows" q, dO, qf^T and dof^T, then m log2 e,
    m, delta and the row key per row."""
    op = 64 * dp * 2
    return {"fwd_keys": 2 * op, "dq_keys": 3 * op, "rows": 4 * op + 4 * 64 * 4}[kind]


def _align(x: int) -> int:
    return _cdiv(x, 128) * 128


def _run(nbytes: int) -> int:
    """Shared bytes of a staged run: 16 more for where it lands."""
    return _align(nbytes + 16)


def wg_fwd_smem(e: int, dp: int, group: int, prep: bool = False) -> int:
    """Shared bytes of a wgmma forward block (csrc/fused_mha_fwd.cu's
    wg_fwd_smem): barriers, the ring (K, V and mask bytes of a key tile, or
    each head's V^T and K from its record), the query tile, and without
    records each head's operand buffers (K and V^T twice each)."""
    op = 64 * dp * 2
    stage = (group * 2 * op if prep else 2 * _run(WG_KEYS * e * 2)) + _run(WG_KEYS)
    return 128 + WG_STAGES * stage + _run(WG_ROWS * e * 2) + (0 if prep else group * 4 * op)


def wg_dkdv_smem(e: int, dp: int, group: int) -> int:
    """Shared bytes of a dk/dv block (csrc/fused_mha_bwd.cu's wg_dkdv_smem):
    K, V and mask bytes, and a ring of the group's row records."""
    return 128 + 2 * _run(64 * e * 2) + _run(64) + WG_STAGES * group * record_bytes("rows", dp)


def wg_dq_smem(e: int, h: int, dp: int, group: int) -> int:
    """Shared bytes of a dq block (csrc/fused_mha_bwd.cu's wg_dq_smem): a
    ring of the group's key records and mask bytes, and the row tile."""
    stage = group * record_bytes("dq_keys", dp) + _run(WG_KEYS)
    once = 2 * _run(WG_ROWS * e * 2) + _run(WG_ROWS * 2 * h * 4) + _run(WG_ROWS * h * 4)
    return 128 + WG_STAGES * stage + once


def _groups(h: int, d: int, max_group: int, fits) -> list:
    """Heads per block the wgmma bodies can take at this shape, largest
    first: powers of two up to max_group and 64 / DP that divide H and
    whose block fits in shared memory; none for d > 32 (DP = 64 gave wrong
    results on the card with several key tiles in a chunk, PERF.md), which
    takes the mma.sync body."""
    if d > 32:
        return []
    top = min(max_group, 64 // _head_pad(d))
    return [g for g in (4, 2, 1) if g <= top and h % g == 0 and fits(g)]


def _key_chunks(s: int, base: int, target: int, min_chunk: int):
    """(chunk, nsplit): the keys cut so that base x nsplit blocks reach
    ``target``, chunks a multiple of the key tile and at least min_chunk."""
    chunk = s
    if base < target:
        per = _cdiv(s, _cdiv(target, base))
        chunk = min(s, max(min_chunk, WG_KEYS * _cdiv(per, WG_KEYS)))
    return chunk, _cdiv(s, chunk)


def fwd_plan_bf16(b: int, l: int, s: int, h: int, d: int,
                  target_blocks: int = WG_FWD_TARGET_BLOCKS,
                  max_group: int = WG_MAX_GROUP, head_groups: int = WG_FWD_HEAD_GROUPS,
                  solo_group: int = WG_FWD_SOLO_GROUP, min_chunk: int = WG_FWD_MIN_CHUNK,
                  prep: bool = True, mma_target_blocks: int = MMA_FWD_TARGET_BLOCKS):
    """The bf16 forward's plan.  L <= FWD_MMA_MAX_ROWS, d > 32 and shapes
    whose block would not fit in shared memory take the mma.sync body with
    :func:`fwd_plan` (at ``mma_target_blocks``); the rest the wgmma body,
    with key records (``prep``) where several query tiles read each key
    tile.  Heads per block (at most ``max_group``): ``solo_group`` where
    they share nothing (records, or one key tile), H / ``head_groups``
    where they share the staged K/V of several key tiles.  When query tiles
    x head groups x B give fewer than ``target_blocks`` blocks, the keys
    split into chunks so that the launch reaches it."""
    dp = _head_pad(d)
    groups = _groups(h, d, max_group, lambda g: wg_fwd_smem(h * d, dp, g) <= _SMEM_LIMIT)
    if l <= FWD_MMA_MAX_ROWS or not groups:
        return fwd_plan(b, l, s, h, d, target_blocks=mma_target_blocks)
    q_tiles = _cdiv(l, WG_ROWS)
    prep = prep and q_tiles > 1
    want = max(1, h // head_groups) if not prep and s > WG_KEYS else solo_group
    g = next((g for g in groups if g <= want), groups[-1])
    prep = prep and wg_fwd_smem(h * d, dp, g, True) <= _SMEM_LIMIT
    base = q_tiles * (h // g) * b
    chunk, nsplit = _key_chunks(s, base, target_blocks, min_chunk)
    work = b * _cdiv(s, WG_KEYS) * h * record_bytes("fwd_keys", dp) // 4 if prep else 0
    if nsplit > 1:
        work += nsplit * b * l * (h * d + 2 * h) + q_tiles * (h // g) * b
    return WgFwdPlan(g, q_tiles, chunk, nsplit, prep, base * nsplit, work, 1 + prep)


def bwd_plan_bf16(b: int, l: int, s: int, h: int, d: int,
                  target_blocks: int = WG_BWD_TARGET_BLOCKS,
                  max_group: int = WG_BWD_MAX_GROUP,
                  dq_target_blocks: int = WG_DQ_TARGET_BLOCKS,
                  dq_min_group: int = WG_DQ_MIN_GROUP, min_chunk: int = WG_FWD_MIN_CHUNK,
                  min_rows: int = WG_BWD_MIN_ROWS,
                  mma_key_warps: int = MMA_BWD_KEY_WARPS):
    """The bf16 backward's plan.  L <= BWD_MMA_MAX_ROWS, d > 32 and shapes
    that do not fit take the mma.sync body with :func:`bwd_plan` (at
    ``mma_key_warps``).  Otherwise dk/dv: the most heads per block, L split
    (64-row multiples, at least ``min_rows`` rows each: each split writes
    float32 dk/dv slabs) when key tiles x head groups x B give fewer than
    ``target_blocks``; dq: fewer heads per block (down to ``dq_min_group``)
    and then key chunks until the launch has ``dq_target_blocks``; the row
    and key records of every tile."""
    e, dp = h * d, _head_pad(d)
    groups = _groups(h, d, max_group, lambda g: wg_dkdv_smem(e, dp, g) <= _SMEM_LIMIT)
    dq_groups = _groups(h, d, max_group, lambda g: wg_dq_smem(e, h, dp, g) <= _SMEM_LIMIT)
    if l <= BWD_MMA_MAX_ROWS or not groups or not dq_groups:
        return bwd_plan(b, l, s, h, d, key_warps=mma_key_warps)
    g = groups[0]
    key_tiles = _cdiv(s, 64)
    base = key_tiles * (h // g) * b
    rows = l
    if base < target_blocks and l > WG_ROWS:
        rows = WG_ROWS * _cdiv(_cdiv(l, _cdiv(target_blocks, base)), WG_ROWS)
        rows = min(l, max(rows, min_rows))
    nsplit = _cdiv(l, rows)
    q_tiles = _cdiv(l, WG_ROWS)
    dq_g = dq_groups[0]
    for cand in dq_groups[1:]:
        if q_tiles * (h // dq_g) * b >= dq_target_blocks or cand < dq_min_group:
            break
        dq_g = cand
    dq_base = q_tiles * (h // dq_g) * b
    dq_chunk, dq_nsplit = _key_chunks(s, dq_base, dq_target_blocks, min_chunk)
    records = (b * q_tiles * h * record_bytes("rows", dp)
               + b * key_tiles * h * record_bytes("dq_keys", dp)) // 4
    dkv = 2 * nsplit * b * s * e if nsplit > 1 else 0
    dq = dq_nsplit * b * l * e + dq_base if dq_nsplit > 1 else 0
    return WgBwdPlan(g, key_tiles, rows, nsplit, dq_g, q_tiles, dq_chunk, dq_nsplit,
                     base * nsplit, dq_base * dq_nsplit, records, dkv, dq, 4 + (nsplit > 1))


def _entry(source: str, name: str, n_pointers: int, n_ints: int = 9):
    """The C entry ``name`` of ``source``: pointers, ``n_ints`` ints, the
    dropout seed, the seed slot's device pointer (null: the seed argument
    is the seed), threshold, 1/(1-rate) and batch offset b0, then the
    stream."""
    from . import _build

    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_uint32, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _fwd_fn():
    return _entry(_FWD_SOURCE, "act3d_fused_mha_fwd_f32", 7)


def _fwd_bf16_fn():
    return _entry(_FWD_SOURCE, "act3d_fused_mha_fwd_bf16", 7, 11)


def _bwd_fn():
    return _entry(_BWD_SOURCE, "act3d_fused_mha_bwd_f32", 11)


def _bwd_bf16_fn():
    return _entry(_BWD_SOURCE, "act3d_fused_mha_bwd_bf16", 11, 13)


def _check(q, k, v, num_heads, mask, rate, seed, b0=0):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, L, E), (B, S, E), (B, S, E)")
    b, _, e = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if e % num_heads != 0:
        raise ValueError(f"E={e} does not divide into {num_heads} heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of several dtypes: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[1] < 1:
        raise ValueError("attention over an empty context")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    slot = is_seed_slot(seed)
    if rate > 0.0 and not (isinstance(seed, int) or slot):
        raise ValueError("dropout needs an int dropout_seed or a seed slot")
    if not 0 <= b0 <= _M32 - b:
        raise ValueError(f"dropout_b0 {b0} outside [0, 2^32 - B]")
    devices = {q.device, k.device, v.device}
    if rate > 0.0 and slot:
        devices.add(seed.device)
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, k.shape[1]):
            raise ValueError("key_padding_mask must be a (B, S) bool tensor")
        devices.add(mask.device)
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_cuda(mask, d, dtype, stats=None, **tensors):
    """Every tensor in ``tensors`` must be of ``dtype``, float32 or
    bfloat16 (one kernel entry each); ``stats`` is float32 whatever it is."""
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"q is {dtype}: the kernels take float32 or bfloat16")
    if stats is not None:
        if stats.dtype != torch.float32:
            raise ValueError(f"stats is {stats.dtype}: float32 expected")
        tensors = dict(tensors, stats=stats)
    for name, t in tensors.items():
        if name != "stats" and t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} beside q of {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask is not None and not mask.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous")
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(f"head dim {d} > {MAX_HEAD_DIM}")


def _dropout_args(rate, seed, b0=0):
    """(dropout flag, int seed, the seed slot's pointer or None, threshold,
    1/(1-rate), b0)."""
    if rate <= 0.0:
        return 0, 0, None, 0, 1.0, 0
    if is_seed_slot(seed):
        return 1, 0, seed.data_ptr(), keep_threshold(rate), 1.0 / (1.0 - rate), b0
    return 1, seed & _M32, None, keep_threshold(rate), 1.0 / (1.0 - rate), b0


def fused_mha_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_b0: int = 0,
):
    """Multi-head softmax attention core on (B, L, E) tensors, no autograd.

    key_padding_mask: optional (B, S) bool, True = masked out.
    dropout_rate / dropout_seed: attention-weight dropout with the hash
    keep mask of that int seed or seed slot; dropout_b0: the rows' offset
    in the global batch.
    Returns out (B, L, E), or (out, stats) with ``return_stats``.
    """
    _check(q, k, v, num_heads, key_padding_mask, dropout_rate, dropout_seed, dropout_b0)
    if q.device.type == "cpu":
        out, stats = fused_mha_forward_reference(
            q, k, v, num_heads, key_padding_mask, dropout_rate, dropout_seed,
            dropout_b0=dropout_b0)
    else:
        out, stats = _launch_fwd(q, k, v, num_heads, key_padding_mask, dropout_rate,
                                 dropout_seed, b0=dropout_b0)
    return (out, stats) if return_stats else out


counted(fused_mha_forward, "launches", "launches_bf16")



_PLAN_CHOICE: dict = {}  # set by launch_plans()


@contextlib.contextmanager
def launch_plans(fwd: Optional[Callable] = None, bwd: Optional[Callable] = None):
    """Inside the block the fused-MHA wrappers take a call's launch plan
    from ``fwd(b, l, s, h, d, dtype)`` / ``bwd(...)`` where given and where
    it returns a plan (None: the default plan).  Lets a script run one body
    at chosen shapes, e.g. the mma.sync bf16 body through :func:`fwd_plan`."""
    saved = dict(_PLAN_CHOICE)
    _PLAN_CHOICE.update({k: fn for k, fn in (("fwd", fwd), ("bwd", bwd)) if fn is not None})
    try:
        yield
    finally:
        _PLAN_CHOICE.clear()
        _PLAN_CHOICE.update(saved)


def _plan(kind, dtype, b, l, s, h, d):
    chosen = _PLAN_CHOICE.get(kind)
    plan = chosen(b, l, s, h, d, dtype) if chosen else None
    if plan is not None:
        return plan
    bf16 = dtype == torch.bfloat16
    default = {"fwd": (fwd_plan, fwd_plan_bf16), "bwd": (bwd_plan, bwd_plan_bf16)}[kind][bf16]
    return default(b, l, s, h, d)


def _workspace(floats, device):
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def _run_fwd(q, k, v, num_heads, mask, rate, seed, plan: Optional[FwdPlan] = None,
             with_stats: bool = True, b0: int = 0):
    """One call of the forward kernel, counted by its caller: (out, stats),
    stats None (and never written) without ``with_stats``."""
    b, l, e = q.shape
    s = k.shape[1]
    d = e // num_heads
    _check_cuda(mask, d, q.dtype, q=q, k=k, v=v)
    bf16 = q.dtype == torch.bfloat16
    plan = plan or _plan("fwd", q.dtype, b, l, s, num_heads, d)
    dropout, *drop = _dropout_args(rate, seed, b0)
    if isinstance(plan, WgFwdPlan):  # the bf16 entry's wgmma body
        fn = _fwd_bf16_fn()
        ints = (1, plan.chunk, plan.nsplit, dropout, plan.group, int(plan.prep))
    elif bf16:  # its mma.sync body
        fn, ints = _fwd_bf16_fn(), (plan.warps, plan.chunk, plan.nsplit, dropout, 0, 0)
    else:
        fn, ints = _fwd_fn(), (plan.warps, plan.chunk, plan.nsplit, dropout)
    out = torch.empty_like(q)
    stats = (torch.empty((b, l, 2 * num_heads), dtype=torch.float32, device=q.device)
             if with_stats else None)
    work = _workspace(plan.workspace_floats, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            None if work is None else work.data_ptr(),
            b, l, s, num_heads, d, *ints, *drop, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mha_fwd launch failed: CUDA error {rc}")
    return out, stats


def _launch_fwd(q, k, v, num_heads, mask, rate, seed, plan: Optional[FwdPlan] = None, *,
                b0: int = 0):
    """One forward kernel call; ``plan`` overrides :func:`fwd_plan` (the
    plan A/B script uses it)."""
    out, stats = _run_fwd(q, k, v, num_heads, mask, rate, seed, plan, b0=b0)
    count_launch(fused_mha_forward, q.dtype)
    return out, stats


def fused_mha_backward(q, k, v, out, stats, grad_out, num_heads,
                       key_padding_mask=None, dropout_rate: float = 0.0,
                       dropout_seed: Optional[int] = None, dropout_b0: int = 0):
    """Gradients (dq, dk, dv) of the attention core from the forward's out
    and stats; the same dropout_rate / dropout_seed / dropout_b0 as the
    forward."""
    _check(q, k, v, num_heads, key_padding_mask, dropout_rate, dropout_seed, dropout_b0)
    if q.device.type == "cpu":
        return fused_mha_backward_reference(
            q, k, v, out, stats, grad_out, num_heads, key_padding_mask, dropout_rate,
            dropout_seed, dropout_b0=dropout_b0)
    return _launch_bwd(q, k, v, out, stats, grad_out, num_heads, key_padding_mask,
                       dropout_rate, dropout_seed, b0=dropout_b0)


counted(fused_mha_backward, "launches", "launches_bf16")


def _launch_bwd(q, k, v, out, stats, grad_out, num_heads, mask, rate, seed,
                plan: Optional[BwdPlan] = None, *, b0: int = 0):
    """One backward kernel call; ``plan`` overrides :func:`bwd_plan`."""
    b, l, e = q.shape
    s = k.shape[1]
    d = e // num_heads
    delta = _delta(out, grad_out, num_heads).contiguous()
    _check_cuda(mask, d, q.dtype, stats, q=q, k=k, v=v, grad_out=grad_out)
    bf16 = q.dtype == torch.bfloat16
    plan = plan or _plan("bwd", q.dtype, b, l, s, num_heads, d)
    dropout, *drop = _dropout_args(rate, seed, b0)
    if isinstance(plan, WgBwdPlan):  # the bf16 entry's two wgmma passes
        fn = _bwd_bf16_fn()
        ints = (1, plan.rows_per_split, plan.nsplit, dropout, plan.group, plan.dq_group,
                plan.dq_chunk, plan.dq_nsplit)
    elif bf16:  # its mma.sync body
        fn = _bwd_bf16_fn()
        ints = (plan.key_warps, plan.rows_per_split, plan.nsplit, dropout, 0, 0, 1, 1)
    else:
        fn, ints = _bwd_fn(), (plan.key_warps, plan.rows_per_split, plan.nsplit, dropout)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    work = _workspace(plan.workspace_floats, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
            stats.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if work is None else work.data_ptr(),
            b, l, s, num_heads, d, *ints, *drop, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mha_bwd launch failed: CUDA error {rc}")
    count_launch(fused_mha_backward, q.dtype)
    return dq, dk, dv


# --------------------------------------------------- single-head-layout core
def attention_core_reference(q, k, v, mask=None):
    """Plain PyTorch version of :func:`attention_core_forward`'s kernel:
    softmax(q kᵀ) v per leading index of (BH, L, D) tensors, masked keys at
    -1e30; at bf16 the weights are rounded to bf16 before the product, as
    the TPU kernel's ``_attn_kernel`` does."""
    scores = q.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], MASKED_SCORE)
    return (_round(torch.softmax(scores, dim=-1), v.dtype) @ v.float()).to(q.dtype)


def _attention_core_backward(q, k, v, mask, grad_out):
    """JAX's ``_attention_core_bwd`` (the standard softmax-attention VJP
    with the scores recomputed) in torch ops, with its casts (no-ops at
    float32): returns (dq, dk, dv)."""
    scores = q.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], MASKED_SCORE)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    dv = w.transpose(-1, -2) @ grad_out
    dw = (grad_out @ v.transpose(-1, -2)).float() * w.float()
    ds = (dw - dw.sum(dim=-1, keepdim=True) * w.float()).to(q.dtype)
    return ds @ k, ds.transpose(-1, -2) @ q, dv


def _check_core(q, k, v, mask):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (BH, L, D), (BH, S, D), (BH, S, D): q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] or k.shape[1] < 1:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of several dtypes: {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {q.device, k.device, v.device}
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != tuple(k.shape[:2]):
            raise ValueError("mask must be a (BH, S) bool tensor")
        devices.add(mask.device)
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def attention_core_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ) v on (BH, L, D) tensors, no autograd: the plain version
    on a CPU tensor, the forward kernel at H = 1 without stats on a CUDA
    one."""
    _check_core(q, k, v, mask)
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, mask)
    return _launch_core(q, k, v, mask)


def _launch_core(q, k, v, mask):
    """One call of the forward kernel as the core: one head, no stats."""
    bh, l, d = q.shape
    plan = (fwd_plan_bf16 if q.dtype == torch.bfloat16 else fwd_plan)(bh, l, k.shape[1], 1, d)
    out, _ = _run_fwd(q, k, v, 1, mask, 0.0, None, plan, with_stats=False)
    count_launch(attention_core, q.dtype)
    return out


class AttentionCore(torch.autograd.Function):
    """:func:`attention_core_forward` under autograd; the backward is JAX's
    jnp VJP in torch ops (the TPU kernel has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attention_core_forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask = ctx.saved_tensors
        return (*_attention_core_backward(q, k, v, mask, grad_out), None)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable single-head-layout attention core, the port of JAX
    ``attention_core``: q (BH, L, D) pre-scaled and rotated, k/v (BH, S, D),
    optional mask (BH, S) bool with True = masked (-1e30, so a fully masked
    row gets uniform weights).  JAX's ``l_tile`` and ``interpret`` are TPU
    knobs and have no counterpart."""
    return AttentionCore.apply(q, k, v, mask)


counted(attention_core, "launches", "launches_bf16")


class FusedMHA(torch.autograd.Function):
    """The attention core under autograd: :func:`fused_mha_forward` forward,
    :func:`fused_mha_backward` backward (kernels on the card, plain versions
    on the CPU).  apply(q, k, v, num_heads, key_padding_mask, dropout_rate,
    dropout_seed[, dropout_b0]) -> out."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, key_padding_mask, dropout_rate, dropout_seed,
                dropout_b0=0):
        out, stats = fused_mha_forward(q, k, v, num_heads, key_padding_mask,
                                       return_stats=True, dropout_rate=dropout_rate,
                                       dropout_seed=dropout_seed, dropout_b0=dropout_b0)
        ctx.save_for_backward(q, k, v, out, stats, key_padding_mask)
        ctx.num_heads = num_heads
        ctx.dropout_rate = dropout_rate
        ctx.dropout_seed = dropout_seed
        ctx.dropout_b0 = dropout_b0
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, stats, mask = ctx.saved_tensors
        dq, dk, dv = fused_mha_backward(
            q, k, v, out, stats, grad_out.contiguous(), ctx.num_heads, mask,
            ctx.dropout_rate, ctx.dropout_seed, ctx.dropout_b0)
        # one gradient per input; apply() may have been given 7 or 8
        return dq, dk, dv, None, None, None, None, None
