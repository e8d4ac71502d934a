"""nn building blocks of the port against the JAX package on the CPU.

Weights are drawn once (tests/torch_parity.py) and moved into the port by
``act3d_tpu_torch.convert``.  Attention stacks are held at 1e-5 (LN and
residual chains in float32); the CLIP trunk + FPN + encoder at atol 2e-4
/ rtol 1e-3 (a 50-layer conv stack, sums in another order), the bound of
tests/test_backbone_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.nn import layers as jl
from act3d_tpu.nn.encoder import VisualEncoder as JVisualEncoder
from act3d_tpu.ops.rotary import rotary_pe_3d
from act3d_tpu_torch.convert import act3d_from_flax
from act3d_tpu_torch.nn import layers
from act3d_tpu_torch.nn.encoder import VisualEncoder

from tests.torch_parity import close, random_params, t

TOL = 1e-5


def _port(module, params):
    module.load_state_dict(act3d_from_flax(params), strict=True)
    return module.eval()


def _seq(rng, b, n, e):
    return rng.normal(size=(b, n, e)).astype(np.float32)


def _code(rng, b, n, e):
    return np.asarray(rotary_pe_3d(jnp.asarray(rng.uniform(-1, 1, (b, n, 3))), e))


@pytest.mark.parametrize("slot_competition", [False, True])
def test_multihead_attention_matches_jax_eager_path(slot_competition):
    """Rotary codes on q and k and a partial key-padding mask (the JAX
    eager path's -inf mask and the port's -1e30 agree while a row keeps
    one key)."""
    rng = np.random.default_rng(0)
    e, heads = 24, 4
    q, kv = _seq(rng, 2, 7, e), _seq(rng, 2, 9, e)
    q_pe, k_pe = _code(rng, 2, 7, e), _code(rng, 2, 9, e)
    mask = np.zeros((2, 9), bool)
    mask[1, 5:] = True
    jm = jl.MultiheadAttention(e, heads, slot_competition=slot_competition)
    kw = dict(q_pe=q_pe, k_pe=k_pe, key_padding_mask=mask)
    params = random_params(jm, 1, q, kv, kv, **kw)
    want = jm.apply({"params": params}, q, kv, kv, **kw)
    port = _port(layers.MultiheadAttention(e, heads, slot_competition), params)
    got = port(t(q), t(kv), t(kv), q_pe=t(q_pe), k_pe=t(k_pe), key_padding_mask=t(mask))
    close(got, want, TOL, TOL)


def test_relative_cross_attention_module_matches_jax():
    rng = np.random.default_rng(2)
    e, heads = 12, 4  # head dim 3
    q, v = _seq(rng, 2, 11, e), _seq(rng, 2, 13, e)
    q_pe, v_pe = _code(rng, 2, 11, e), _code(rng, 2, 13, e)
    jm = jl.RelativeCrossAttentionModule(e, heads, 2)
    params = random_params(jm, 3, q, v, q_pe, v_pe)
    want = jm.apply({"params": params}, q, v, q_pe, v_pe)
    got = _port(layers.RelativeCrossAttentionModule(e, heads, 2), params)(
        t(q), t(v), t(q_pe), t(v_pe))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        close(g, w, TOL, TOL)


@pytest.mark.parametrize("rotary_pe,use_adaln,cross2,self2", [
    (True, True, False, False),  # the denoiser's traj/pos/rot stacks
    (False, False, True, True),  # both sequences updated, positions added
])
def test_parallel_attention_matches_jax(rotary_pe, use_adaln, cross2, self2):
    rng = np.random.default_rng(4)
    e, heads, b = 24, 8, 2  # head dim 3
    seq1, seq2 = _seq(rng, b, 6, e), _seq(rng, b, 10, e)
    mask1 = np.zeros((b, 6), bool)
    mask1[0, 4:] = True
    cfg = dict(self_attention1=True, self_attention2=self2, cross_attention1=True,
               cross_attention2=cross2, rotary_pe=rotary_pe, use_adaln=use_adaln)
    kw = dict(
        seq1_key_padding_mask=mask1,
        seq1_pos=_code(rng, b, 6, e) if rotary_pe else _seq(rng, b, 6, e),
        seq2_pos=_code(rng, b, 10, e) if rotary_pe else _seq(rng, b, 10, e),
        seq1_sem_pos=_seq(rng, b, 6, e),
        ada_sgnl=rng.normal(size=(b, e)).astype(np.float32) if use_adaln else None,
    )
    jm = jl.ParallelAttention(num_layers=2, d_model=e, n_heads=heads, **cfg)
    params = random_params(jm, 5, seq1, seq2, **kw)
    want = jm.apply({"params": params}, seq1, seq2, **kw)
    port = _port(layers.ParallelAttention(2, d_model=e, n_heads=heads, **cfg), params)
    got = port(t(seq1), t(seq2), **{k: None if v is None else t(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        close(g, w, TOL, TOL)


def test_visual_encoder_matches_jax_at_64():
    """CLIP ModifiedResNet-50 + FPN + token/point-cloud pyramids, 2 cameras."""
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    pcd = rng.uniform(-1, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    jm = JVisualEncoder(image_size=(64, 64), embedding_dim=12, num_sampling_level=3)
    params = random_params(jm, 7, rgb, pcd)
    want_feats, want_pcd = jax.jit(lambda p: jm.apply({"params": p}, rgb, pcd))(params)
    port = _port(VisualEncoder((64, 64), 12, 3), params)
    with torch.no_grad():
        got_feats, got_pcd = port(t(rgb), t(pcd))
    assert [g.shape[1] for g in got_feats] == [2 * 16 * 16, 2 * 32 * 32, 2 * 32 * 32]
    for g, w in zip(got_feats, want_feats):
        close(g, w, 2e-4, 1e-3)
    for g, w in zip(got_pcd, want_pcd):
        close(g, w, 1e-6)
