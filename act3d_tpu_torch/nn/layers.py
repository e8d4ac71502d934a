"""Transformer building blocks (PyTorch).

Counterpart of ``act3d_tpu/nn/layers.py``: MultiheadAttention,
RelativeCrossAttentionLayer/Module, FeedforwardLayer, AdaLN and
ParallelAttentionLayer/ParallelAttention.  Post-norm, LayerNorm eps 1e-5.
Submodules carry the flax names so ``convert.py`` maps weights
mechanically.

Dropout follows JAX's ``deterministic=False`` path when the module is in
training mode: attention-weight dropout inside MultiheadAttention (in the
kernel), ``drop(out)`` before each residual of ParallelAttentionLayer and
both FFN dropouts, drawn from the :class:`nn.dropout.Generators` passed to
``forward``.  The Act3D layers (RelativeCrossAttention*, FeedforwardLayer)
have no dropout: JAX's ``RelativeCrossAttentionModule`` builds them at
rate 0 (``act3d_tpu/nn/layers.py:91,124,160-165``), so the port has none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import AttentionParams, multi_head_attention
from .dropout import Generators, dropout

LN_EPS = 1e-5


def active_generators(module: nn.Module, rate: float,
                      generators: Optional[Generators]) -> Optional[Generators]:
    """The generators when ``module`` drops out (training mode, rate > 0),
    else None.  Training with dropout and no generators raises."""
    if not module.training or rate <= 0.0:
        return None
    if generators is None:
        raise ValueError(f"{type(module).__name__} is in training mode with dropout "
                         f"{rate}: pass generators=Generators(...)")
    return generators


def _xavier_linear(d_in: int, d_out: int) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, slot_competition: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.slot_competition = slot_competition
        self.dropout = dropout
        self.q_proj = _xavier_linear(embed_dim, embed_dim)
        self.k_proj = _xavier_linear(embed_dim, embed_dim)
        self.v_proj = _xavier_linear(embed_dim, embed_dim)
        self.out_proj = _xavier_linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, q_pe=None, k_pe=None,
                key_padding_mask=None, generators: Optional[Generators] = None):
        gens = active_generators(self, self.dropout, generators)
        params = AttentionParams(
            self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
            self.out_proj.weight, self.q_proj.bias, self.k_proj.bias,
            self.v_proj.bias, self.out_proj.bias,
        )
        return multi_head_attention(
            params, query, key, value, self.num_heads, q_pe=q_pe, k_pe=k_pe,
            key_padding_mask=key_padding_mask,
            slot_competition=self.slot_competition,
            dropout_rate=self.dropout if gens is not None else 0.0,
            generator=None if gens is None else gens.host,
        )


class RelativeCrossAttentionLayer(nn.Module):
    """Post-norm cross-attention with rotary relative positions."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(embed_dim, num_heads)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, query, value, query_pos=None, value_pos=None, pad_mask=None):
        attn = self.multihead_attn(
            query, value, value, q_pe=query_pos, k_pe=value_pos,
            key_padding_mask=pad_mask,
        )
        return self.norm(query + attn)


class FeedforwardLayer(nn.Module):
    """Residual MLP with post-norm."""

    def __init__(self, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = _xavier_linear(embed_dim, hidden_dim)
        self.linear2 = _xavier_linear(hidden_dim, embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class RelativeCrossAttentionModule(nn.Module):
    """Stack of (cross-attention, FFW) pairs returning every layer's output."""

    def __init__(self, embed_dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"attn_{i}", RelativeCrossAttentionLayer(embed_dim, num_heads))
            setattr(self, f"ffw_{i}", FeedforwardLayer(embed_dim, embed_dim))

    def forward(self, query, value, query_pos=None, value_pos=None,
                pad_mask=None) -> List[torch.Tensor]:
        outputs = []
        for i in range(self.num_layers):
            query = getattr(self, f"attn_{i}")(query, value, query_pos, value_pos, pad_mask)
            query = getattr(self, f"ffw_{i}")(query)
            outputs.append(query)
        return outputs


class AdaLN(nn.Module):
    """Adaptive scale/shift modulation, zero-initialised."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.modulation = nn.Linear(embed_dim, 2 * embed_dim)
        nn.init.zeros_(self.modulation.weight)
        nn.init.zeros_(self.modulation.bias)

    def forward(self, x, t):
        """x (B, N, C), t (B, C)."""
        scale, shift = self.modulation(F.silu(t.to(x.dtype))).chunk(2, dim=-1)
        return x * (1.0 + scale[:, None]) + shift[:, None]


def _maybe_add(x, pos):
    return x if pos is None else x + pos.to(x.dtype)


class ParallelAttentionLayer(nn.Module):
    """Self-/cross-attention between two sequences.

    Order: cross 1<-2, cross 2<-1, self 1, self 2, FFN 1, FFN 2.  With
    ``rotary_pe`` the positions enter as rotary codes inside attention,
    otherwise they are added to q/k; ``seq*_sem_pos`` is always added to
    q/k.  AdaLN modulates the attention and FFN inputs when ``use_adaln``.
    """

    def __init__(
        self,
        d_model: int = 256,
        n_heads: int = 8,
        self_attention1: bool = True,
        self_attention2: bool = True,
        cross_attention1: bool = True,
        cross_attention2: bool = True,
        apply_ffn: bool = True,
        rotary_pe: bool = False,
        use_adaln: bool = False,
        dropout: float = 0.1,
    ):
        super().__init__()
        self.dropout = dropout
        self.rotary_pe = rotary_pe
        self.self_attention1 = self_attention1
        self.self_attention2 = self_attention2
        self.cross_attention1 = cross_attention1
        self.cross_attention2 = cross_attention2
        self.ffn1 = (self_attention1 or cross_attention1) and apply_ffn
        self.ffn2 = (self_attention2 or cross_attention2) and apply_ffn

        def block(enabled, adaln, attn, norm):
            if not enabled:
                return
            if use_adaln:
                setattr(self, adaln, AdaLN(d_model))
            setattr(self, attn, MultiheadAttention(d_model, n_heads, dropout=dropout))
            setattr(self, norm, nn.LayerNorm(d_model, eps=LN_EPS))

        block(cross_attention1, "adaln_12", "cross_12", "norm_12")
        block(cross_attention2, "adaln_21", "cross_21", "norm_21")
        block(self_attention1, "adaln_1", "sa1", "norm_1")
        block(self_attention2, "adaln_2", "sa2", "norm_2")
        for enabled, tag, norm in ((self.ffn1, "1", "norm_122"), (self.ffn2, "2", "norm_212")):
            if not enabled:
                continue
            other = "2" if tag == "1" else "1"
            if use_adaln:
                setattr(self, f"adaln_ff{tag}", AdaLN(d_model))
            setattr(self, f"ffn_{tag}{other}_fc1", _xavier_linear(d_model, 4 * d_model))
            setattr(self, f"ffn_{tag}{other}_fc2", _xavier_linear(4 * d_model, d_model))
            setattr(self, norm, nn.LayerNorm(d_model, eps=LN_EPS))

    def _adaln(self, name, x, ada_sgnl):
        layer = getattr(self, name, None)
        if layer is not None and ada_sgnl is not None:
            return layer(x, ada_sgnl)
        return x

    def _qk(self, seq, pos, sem_pos):
        q = k = seq
        if not self.rotary_pe:
            q = k = _maybe_add(seq, pos)
        return _maybe_add(q, sem_pos), _maybe_add(k, sem_pos)

    def _ffn(self, tag, other, norm, seq, ada_sgnl, gens):
        seq = self._adaln(f"adaln_ff{tag}", seq, ada_sgnl)
        h = dropout(F.relu(getattr(self, f"ffn_{tag}{other}_fc1")(seq)), self.dropout, gens)
        h = dropout(getattr(self, f"ffn_{tag}{other}_fc2")(h), self.dropout, gens)
        return getattr(self, norm)(seq + h)

    def forward(
        self,
        seq1,
        seq2,
        *,
        seq1_key_padding_mask=None,
        seq2_key_padding_mask=None,
        seq1_pos=None,
        seq2_pos=None,
        seq1_sem_pos=None,
        seq2_sem_pos=None,
        ada_sgnl=None,
        generators: Optional[Generators] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        rot = self.rotary_pe
        gens = active_generators(self, self.dropout, generators)

        def drop(x):
            return dropout(x, self.dropout, gens)

        q1, k1 = self._qk(seq1, seq1_pos, seq1_sem_pos)
        q2, k2 = self._qk(seq2, seq2_pos, seq2_sem_pos)
        v1, v2 = seq1, seq2

        if self.cross_attention1:
            out = self.cross_12(
                self._adaln("adaln_12", q1, ada_sgnl), k2, v2,
                q_pe=seq1_pos if rot else None, k_pe=seq2_pos if rot else None,
                key_padding_mask=seq2_key_padding_mask, generators=generators,
            )
            seq1 = self.norm_12(seq1 + drop(out))
        if self.cross_attention2:
            out = self.cross_21(
                self._adaln("adaln_21", q2, ada_sgnl), k1, v1,
                q_pe=seq2_pos if rot else None, k_pe=seq1_pos if rot else None,
                key_padding_mask=seq1_key_padding_mask, generators=generators,
            )
            seq2 = self.norm_21(seq2 + drop(out))
        if self.self_attention1:
            q1, k1 = self._qk(seq1, seq1_pos, seq1_sem_pos)
            out = self.sa1(
                self._adaln("adaln_1", q1, ada_sgnl),
                self._adaln("adaln_1", k1, ada_sgnl),
                self._adaln("adaln_1", seq1, ada_sgnl),
                q_pe=seq1_pos if rot else None, k_pe=seq1_pos if rot else None,
                key_padding_mask=seq1_key_padding_mask, generators=generators,
            )
            seq1 = self.norm_1(seq1 + drop(out))
        if self.self_attention2:
            q2, k2 = self._qk(seq2, seq2_pos, seq2_sem_pos)
            out = self.sa2(
                self._adaln("adaln_2", q2, ada_sgnl),
                self._adaln("adaln_2", k2, ada_sgnl),
                self._adaln("adaln_2", seq2, ada_sgnl),
                q_pe=seq2_pos if rot else None, k_pe=seq2_pos if rot else None,
                key_padding_mask=seq2_key_padding_mask, generators=generators,
            )
            seq2 = self.norm_2(seq2 + drop(out))
        if self.ffn1:
            seq1 = self._ffn("1", "2", "norm_122", seq1, ada_sgnl, gens)
        if self.ffn2:
            seq2 = self._ffn("2", "1", "norm_212", seq2, ada_sgnl, gens)
        return seq1, seq2


class ParallelAttention(nn.Module):
    """Stack of :class:`ParallelAttentionLayer` named ``layer_{i}``."""

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
