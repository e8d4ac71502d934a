"""Multi-head attention with 3D rotary codes (PyTorch).

Counterpart of ``act3d_tpu/ops/attention.py::multi_head_attention``:
batch-major (B, L, E) tokens, q/k/v projections, 1/sqrt(d) scaling of q,
the rotary code applied to the full embedding before the head split, the
softmax core and the output projection.

Every core without slot competition goes to
:class:`kernels.attention.FusedMHA` (the CUDA kernels on a CUDA tensor,
their plain versions on a CPU tensor, forward and backward).  The TPU
routing floors of the JAX package (minimum rows, minimum and maximum
context) and its head-dim pad fold are not carried over.  Slot competition
stays plain PyTorch with -inf masking, as in JAX.

Attention-weight dropout: with ``dropout_rate > 0`` each call draws one
int31 seed from a host ``torch.Generator`` (as JAX draws one from its
dropout key, ops/attention.py:247-249) and hands it to the kernel as a
launch argument, so no host-device sync happens per call; the keep mask
is the kernels' hash of (seed, dropout_b0 + b, h, row, col), with
``dropout_b0`` the rows' offset in the global batch under data
parallelism (every rank draws the same seed).  While a training step is
captured in a CUDA graph (``train/step_graph.py``), a :class:`SeedTape`
records: each call still draws its seed on the host, in the same order,
and hands the kernel the device slot that will hold it at each replay.

``multi_head_attention.calls`` counts the calls, slot competition or not,
whatever the core ran on (``utils/graphs.py``); the kernels count launches.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.attention import FusedMHA, dropout_keep
from ..utils.graphs import counted
from .rotary import embed_rotary

__all__ = ["AttentionParams", "SeedTape", "multi_head_attention"]

SEED_HIGH = 2**31 - 1  # dropout seeds are int31: randint(0, SEED_HIGH)
SEED_SLOTS = 1024  # the most dropout calls a captured step may make


class SeedTape:
    """The dropout seeds of a step captured in a CUDA graph.

    While :meth:`recording` runs, each dropout call draws its seed from the
    host generator as it does eagerly, and :meth:`take` hands the kernels
    the slot that holds the i-th call's seed, a view of ``slots`` (int32 on
    the device).  Before each replay :meth:`load` fills the ``count`` slots
    on the current stream: first with the seeds the capture drew, then with
    ``count`` fresh draws, which are the draws of ``count`` eager calls.
    Nothing waits on the device: each load stages its seeds in a fresh
    pinned tensor, which the caching host allocator keeps until the copy
    has run."""

    active: Optional["SeedTape"] = None  # the tape recording, if any

    def __init__(self, device, capacity: int = SEED_SLOTS):
        self.slots = torch.zeros(capacity, dtype=torch.int32, device=device)
        self.count = 0
        self._captured: List[int] = []

    @contextlib.contextmanager
    def recording(self):
        SeedTape.active = self
        try:
            yield self
        finally:
            SeedTape.active = None

    def take(self, seed: int) -> torch.Tensor:
        if self.count == len(self.slots):
            raise RuntimeError(f"a step of more than {len(self.slots)} dropout calls")
        self._captured.append(seed)
        self.count += 1
        return self.slots[self.count - 1:self.count]

    @staticmethod
    def draw(generator: Optional[torch.Generator], k: int, pin: bool = False) -> torch.Tensor:
        """k seeds as k calls draw them one by one, int32 on the host (in
        pinned memory with ``pin``)."""
        out = torch.empty(k, dtype=torch.int32, pin_memory=pin)
        return torch.randint(0, SEED_HIGH, (k,), generator=generator, out=out)

    def load(self, generator: Optional[torch.Generator]):
        if not self.count:
            return
        pin = self.slots.is_cuda
        if self._captured:
            staged = torch.tensor(self._captured, dtype=torch.int32)
            staged = staged.pin_memory() if pin else staged
            self._captured = []
        else:
            staged = self.draw(generator, self.count, pin)
        self.slots[:self.count].copy_(staged, non_blocking=True)


class AttentionParams(NamedTuple):
    """Projection weights in PyTorch's (out, in) layout."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    bo: Optional[torch.Tensor] = None


def _slot_competition_core(q, k, v, num_heads, key_padding_mask, dropout_rate, seed, b0):
    """softmax over queries, then renormalised over keys; plain dropout
    of the weights with the kernels' hash mask."""
    b, l, e = q.shape
    d = e // num_heads
    qh = q.reshape(b, l, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, d).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)).float()
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    weights = torch.softmax(scores, dim=-2) + 1e-8
    weights = weights / weights.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, b, num_heads, l, kh.shape[2], dropout_rate, q.device, b0)
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    out = weights.to(vh.dtype) @ vh
    return out.transpose(1, 2).reshape(b, l, e)


def multi_head_attention(
    params: AttentionParams,
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    *,
    q_pe: Optional[torch.Tensor] = None,
    k_pe: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    slot_competition: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_b0: int = 0,
) -> torch.Tensor:
    """query (B, L, E), key/value (B, S, E); q_pe/k_pe rotary codes
    (B, L, E, 2)/(B, S, E, 2); key_padding_mask (B, S) bool, True = masked.
    dropout_rate > 0 drops attention weights, seeded from the host
    ``generator``, the rows keyed from ``dropout_b0`` in the global batch.
    Returns (B, L, E) after the output projection."""
    multi_head_attention.calls += 1
    seed = None
    if dropout_rate > 0.0:  # one int31 seed per call, drawn on the host
        seed = int(torch.randint(0, SEED_HIGH, (1,), generator=generator))
        if SeedTape.active is not None:
            seed = SeedTape.active.take(seed)
    e = query.shape[-1]
    scaling = (e // num_heads) ** -0.5
    q = F.linear(query, params.wq, params.bq) * scaling
    k = F.linear(key, params.wk, params.bk)
    v = F.linear(value, params.wv, params.bv)
    if q_pe is not None:
        q = embed_rotary(q, q_pe)
    if k_pe is not None:
        k = embed_rotary(k, k_pe)
    if slot_competition:
        out = _slot_competition_core(q, k, v, num_heads, key_padding_mask, dropout_rate,
                                     seed, dropout_b0)
    else:
        out = FusedMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
                             key_padding_mask, float(dropout_rate), seed, dropout_b0)
    return F.linear(out, params.wo, params.bo)


counted(multi_head_attention, "calls")
