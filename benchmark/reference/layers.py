"""Plain PyTorch building blocks of the reference: rotary codes, attention,
the post-norm layers of Act3D and ChainedDiffuser, dropout.

Written for the benchmark after ``act3d_tpu/nn/layers.py`` and
``act3d_tpu/ops/{attention,rotary}.py`` (the published Act3D /
ChainedDiffuser layers): batch-major (B, L, E) tokens, q scaled by
1/sqrt(d) and rotated by the 3D rotary code over the whole embedding
before the head split, softmax over keys with masked keys at -1e30 (a row
with every key masked gets uniform weights), post-norm LayerNorm at eps
1e-5.  Module and parameter names follow the published flax tree, so one
state dict made from a seed loads into the reference and into the system
under test alike.

Randomness: attention-weight dropout draws one int31 seed per call from a
host generator, and the keep mask is a hash of (seed, b, h, row, col)
(:func:`dropout_keep`); elementwise dropout draws uniforms from a device
generator.  Both generators are seeded from the run's seed, so the
reference draws the masks of the training step it is held against.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-5
MASKED_SCORE = -1e30


class Generators(NamedTuple):
    """``host``: a CPU generator giving one int31 seed per attention call;
    ``device``: the generator of elementwise dropout, diffusion noise and
    timesteps, and ghost-point uniforms.  Seeded as the training step's
    own: ``seed`` and ``seed + 1``."""

    host: torch.Generator
    device: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "Generators":
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=torch.device(device)).manual_seed(seed + 1))


# ------------------------------------------------------------ dropout hash
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SEED_SALT = 0x85EBCA6B


def _mul32(x, c: int):
    """x * c mod 2^32 on 16-bit halves of x, so int64 never overflows."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    """lowbias32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep(seed: int, b: int, h: int, l: int, s: int, rate: float, device) -> torch.Tensor:
    """(B, H, L, S) keep mask: hash bits >= rate * 2^32, the bits a pure
    function of (seed, b, h, row, col)."""
    def idx(n, shape):
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    key = _mix32((seed & _M32) ^ _SEED_SALT)
    key = _mix32(key ^ idx(b, (b, 1, 1)))
    key = _mix32(key ^ idx(h, (1, h, 1)))
    key = _mix32(key ^ idx(l, (1, 1, l)))
    bits = _mix32(key[..., None] ^ _mul32(idx(s, (s,)), _GOLDEN))
    return bits >= min(int(rate * 2.0 ** 32), _M32)


def dropout(x: torch.Tensor, rate: float, gens: Optional[Generators]) -> torch.Tensor:
    """Keep with probability 1 - rate, scale kept values by 1/(1 - rate);
    the identity without generators."""
    if gens is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gens.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ----------------------------------------------------------------- rotary
def _duplicate_interleave(x):
    return torch.stack([x, x], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def rotary_pe_3d(xyz: torch.Tensor, feature_dim: int) -> torch.Tensor:
    """(..., N, 3) -> (..., N, F, 2) (cos, sin); F in three thirds, one per
    axis."""
    d_axis = feature_dim // 3
    div_term = torch.exp(torch.arange(0, d_axis, 2, dtype=torch.float32, device=xyz.device)
                         * (-math.log(10000.0) / d_axis))
    angles = xyz[..., None].float() * div_term
    sin = _duplicate_interleave(torch.sin(angles))
    cos = _duplicate_interleave(torch.cos(angles))
    return torch.stack([cos.reshape(cos.shape[:-2] + (3 * d_axis,)),
                        sin.reshape(sin.shape[:-2] + (3 * d_axis,))], dim=-1)


def embed_rotary(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    cos, sin = code[..., 0], code[..., 1]
    x2 = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    return x * cos + x2 * sin


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * -(math.log(10000.0) / (half - 1)))
    angles = x.float()[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# -------------------------------------------------------------- attention
def attention_core(q, k, v, num_heads: int, key_padding_mask=None, rate: float = 0.0,
                   seed: Optional[int] = None):
    """softmax(q k^T) v per head over (B, L, E) / (B, S, E) tokens, heads
    as contiguous E/H slices; attention-weight dropout by the hash mask."""
    b, l, e = q.shape
    s = k.shape[1]
    d = e // num_heads

    def split(x):
        return x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2)

    scores = split(q) @ split(k).transpose(-1, -2)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], MASKED_SCORE)
    weights = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = dropout_keep(seed, b, num_heads, l, s, rate, q.device)
        weights = torch.where(keep, weights / (1.0 - rate), 0.0)
    return (weights @ split(v)).transpose(1, 2).reshape(b, l, e)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, q_pe=None, k_pe=None, key_padding_mask=None,
                gens: Optional[Generators] = None):
        rate = self.dropout if (self.training and gens is not None) else 0.0
        seed = None
        if rate > 0.0:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gens.host))
        e = query.shape[-1]
        q = self.q_proj(query) * (e // self.num_heads) ** -0.5
        k = self.k_proj(key)
        v = self.v_proj(value)
        if q_pe is not None:
            q = embed_rotary(q, q_pe)
        if k_pe is not None:
            k = embed_rotary(k, k_pe)
        out = attention_core(q, k, v, self.num_heads, key_padding_mask, rate, seed)
        return self.out_proj(out)


# ------------------------------------------------------------------ Act3D
class RelativeCrossAttentionLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(embed_dim, num_heads)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, query, value, query_pos=None, value_pos=None):
        attn = self.multihead_attn(query, value, value, q_pe=query_pos, k_pe=value_pos)
        return self.norm(query + attn)


class FeedforwardLayer(nn.Module):
    def __init__(self, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(embed_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class RelativeCrossAttentionModule(nn.Module):
    """(cross-attention, FFW) pairs; every layer's output is returned."""

    def __init__(self, embed_dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"attn_{i}", RelativeCrossAttentionLayer(embed_dim, num_heads))
            setattr(self, f"ffw_{i}", FeedforwardLayer(embed_dim, embed_dim))

    def forward(self, query, value, query_pos=None, value_pos=None) -> List[torch.Tensor]:
        outputs = []
        for i in range(self.num_layers):
            query = getattr(self, f"attn_{i}")(query, value, query_pos, value_pos)
            query = getattr(self, f"ffw_{i}")(query)
            outputs.append(query)
        return outputs


# -------------------------------------------------------- ChainedDiffuser
class AdaLN(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.modulation = nn.Linear(embed_dim, 2 * embed_dim)

    def forward(self, x, t):
        scale, shift = self.modulation(F.silu(t)).chunk(2, dim=-1)
        return x * (1.0 + scale[:, None]) + shift[:, None]


def _maybe_add(x, pos):
    return x if pos is None else x + pos


class ParallelAttentionLayer(nn.Module):
    """Order: cross 1<-2, cross 2<-1, self 1, self 2, FFN 1, FFN 2; rotary
    positions inside attention (``rotary_pe``) or added to q/k; semantic
    positions always added to q/k; AdaLN on the attention and FFN inputs;
    dropout on each residual branch and inside attention."""

    def __init__(self, d_model: int, n_heads: int, self_attention1: bool = True,
                 self_attention2: bool = True, cross_attention1: bool = True,
                 cross_attention2: bool = True, apply_ffn: bool = True,
                 rotary_pe: bool = False, use_adaln: bool = False, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.rotary_pe = rotary_pe
        self.self_attention1, self.self_attention2 = self_attention1, self_attention2
        self.cross_attention1, self.cross_attention2 = cross_attention1, cross_attention2
        self.ffn1 = (self_attention1 or cross_attention1) and apply_ffn
        self.ffn2 = (self_attention2 or cross_attention2) and apply_ffn

        def block(enabled, adaln, attn, norm):
            if enabled:
                if use_adaln:
                    setattr(self, adaln, AdaLN(d_model))
                setattr(self, attn, MultiheadAttention(d_model, n_heads, dropout=dropout))
                setattr(self, norm, nn.LayerNorm(d_model, eps=LN_EPS))

        block(cross_attention1, "adaln_12", "cross_12", "norm_12")
        block(cross_attention2, "adaln_21", "cross_21", "norm_21")
        block(self_attention1, "adaln_1", "sa1", "norm_1")
        block(self_attention2, "adaln_2", "sa2", "norm_2")
        for enabled, tag, norm in ((self.ffn1, "1", "norm_122"), (self.ffn2, "2", "norm_212")):
            if enabled:
                other = "2" if tag == "1" else "1"
                if use_adaln:
                    setattr(self, f"adaln_ff{tag}", AdaLN(d_model))
                setattr(self, f"ffn_{tag}{other}_fc1", nn.Linear(d_model, 4 * d_model))
                setattr(self, f"ffn_{tag}{other}_fc2", nn.Linear(4 * d_model, d_model))
                setattr(self, norm, nn.LayerNorm(d_model, eps=LN_EPS))

    def _adaln(self, name, x, ada):
        layer = getattr(self, name, None)
        return layer(x, ada) if layer is not None and ada is not None else x

    def _qk(self, seq, pos, sem_pos):
        q = seq if self.rotary_pe else _maybe_add(seq, pos)
        return _maybe_add(q, sem_pos), _maybe_add(q, sem_pos)

    def _ffn(self, tag, other, norm, seq, ada, gens):
        seq = self._adaln(f"adaln_ff{tag}", seq, ada)
        h = dropout(F.relu(getattr(self, f"ffn_{tag}{other}_fc1")(seq)), self.dropout, gens)
        h = dropout(getattr(self, f"ffn_{tag}{other}_fc2")(h), self.dropout, gens)
        return getattr(self, norm)(seq + h)

    def forward(self, seq1, seq2, *, seq1_key_padding_mask=None, seq2_key_padding_mask=None,
                seq1_pos=None, seq2_pos=None, seq1_sem_pos=None, seq2_sem_pos=None,
                ada_sgnl=None, gens: Optional[Generators] = None):
        rot = self.rotary_pe
        gens = gens if self.training else None

        def drop(x):
            return dropout(x, self.dropout, gens)

        q1, k1 = self._qk(seq1, seq1_pos, seq1_sem_pos)
        q2, k2 = self._qk(seq2, seq2_pos, seq2_sem_pos)
        v1, v2 = seq1, seq2
        if self.cross_attention1:
            out = self.cross_12(self._adaln("adaln_12", q1, ada_sgnl), k2, v2,
                                q_pe=seq1_pos if rot else None, k_pe=seq2_pos if rot else None,
                                key_padding_mask=seq2_key_padding_mask, gens=gens)
            seq1 = self.norm_12(seq1 + drop(out))
        if self.cross_attention2:
            out = self.cross_21(self._adaln("adaln_21", q2, ada_sgnl), k1, v1,
                                q_pe=seq2_pos if rot else None, k_pe=seq1_pos if rot else None,
                                key_padding_mask=seq1_key_padding_mask, gens=gens)
            seq2 = self.norm_21(seq2 + drop(out))
        if self.self_attention1:
            q1, k1 = self._qk(seq1, seq1_pos, seq1_sem_pos)
            out = self.sa1(self._adaln("adaln_1", q1, ada_sgnl),
                           self._adaln("adaln_1", k1, ada_sgnl),
                           self._adaln("adaln_1", seq1, ada_sgnl),
                           q_pe=seq1_pos if rot else None, k_pe=seq1_pos if rot else None,
                           key_padding_mask=seq1_key_padding_mask, gens=gens)
            seq1 = self.norm_1(seq1 + drop(out))
        if self.self_attention2:
            q2, k2 = self._qk(seq2, seq2_pos, seq2_sem_pos)
            out = self.sa2(self._adaln("adaln_2", q2, ada_sgnl),
                           self._adaln("adaln_2", k2, ada_sgnl),
                           self._adaln("adaln_2", seq2, ada_sgnl),
                           q_pe=seq2_pos if rot else None, k_pe=seq2_pos if rot else None,
                           key_padding_mask=seq2_key_padding_mask, gens=gens)
            seq2 = self.norm_2(seq2 + drop(out))
        if self.ffn1:
            seq1 = self._ffn("1", "2", "norm_122", seq1, ada_sgnl, gens)
        if self.ffn2:
            seq2 = self._ffn("2", "1", "norm_212", seq2, ada_sgnl, gens)
        return seq1, seq2


class ParallelAttention(nn.Module):
    def __init__(self, num_layers: int = 1, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.update_seq1 = layer_kwargs.get("self_attention1", True) or layer_kwargs.get(
            "cross_attention1", True)
        self.update_seq2 = layer_kwargs.get("self_attention2", True) or layer_kwargs.get(
            "cross_attention2", True)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", ParallelAttentionLayer(**layer_kwargs))

    def forward(self, seq1, seq2, **kwargs):
        for i in range(self.num_layers):
            s1, s2 = getattr(self, f"layer_{i}")(seq1, seq2, **kwargs)
            if self.update_seq1:
                seq1 = s1
            if self.update_seq2:
                seq2 = s2
        return seq1, seq2
