"""Multi-head attention with 3D rotary codes (PyTorch).

Counterpart of ``act3d_tpu/ops/attention.py::multi_head_attention``:
batch-major (B, L, E) tokens, q/k/v projections, 1/sqrt(d) scaling of q,
the rotary code applied to the full embedding before the head split, the
softmax core and the output projection.

Every core without slot competition goes to
:func:`kernels.attention.fused_mha_forward` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor).  The TPU routing floors of the
JAX package (minimum rows, minimum and maximum context) and its head-dim
pad fold are not carried over.  Slot competition stays plain PyTorch with
-inf masking, as in JAX.  Attention-weight dropout belongs to training and
is not implemented.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.attention import fused_mha_forward
from .rotary import embed_rotary

__all__ = ["AttentionParams", "multi_head_attention"]


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


def _slot_competition_core(q, k, v, num_heads, key_padding_mask):
    """softmax over queries, then renormalised over keys."""
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
) -> torch.Tensor:
    """query (B, L, E), key/value (B, S, E); q_pe/k_pe rotary codes
    (B, L, E, 2)/(B, S, E, 2); key_padding_mask (B, S) bool, True = masked.
    Returns (B, L, E) after the output projection."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-weight dropout is part of the training path"
        )
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
        out = _slot_competition_core(q, k, v, num_heads, key_padding_mask)
    else:
        out = fused_mha_forward(
            q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
            key_padding_mask=key_padding_mask,
        )
    return F.linear(out, params.wo, params.bo)
