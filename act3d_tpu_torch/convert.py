"""Weight bridges into the port's state dicts.

**flax -> port** (``act3d_from_flax``, ``diffusion_planner_from_flax``):
the port's submodules carry the flax names (``visual.backbone.layer1_0.conv1``,
``ghost_point_cross_attn.attn_0.multihead_attn``,
``prediction_head.traj_attention_0.layer_0.cross_12``, ...), so the bridge
is mechanical, leaf by leaf:

  * Dense ``kernel`` (in, out) -> ``weight`` (out, in);
  * Conv ``kernel`` HWIO -> ``weight`` OIHW;
  * LayerNorm / FrozenBN ``scale`` -> ``weight``; FrozenBN ``mean`` /
    ``var`` -> ``running_mean`` / ``running_var`` buffers;
  * attention ``{q,k,v,out}_kernel`` / ``_bias`` ->
    ``{q,k,v,out}_proj.weight`` / ``.bias``;
  * every other leaf (biases, learned embeddings) keeps its name.

The tree is nested dicts of numpy arrays (``jax.device_get`` of the
params, or the ``params`` of a ``.msgpack`` checkpoint read by
``core/msgpack.py``, whose bfloat16 leaves are torch tensors).

**reference -> port** (``act3d_from_reference``,
``diffusion_planner_from_reference``): the counterpart of
``act3d_tpu/convert/torch_to_jax.py`` for the upstream ``.pth`` state
dicts (model/keypose_optimization/act3d.py,
model/trajectory_optimization/*.py, model/utils/*.py).  Both sides are
torch, so tensors keep their layout; only names change, and
``nn.MultiheadAttention``'s packed ``in_proj_weight`` / ``in_proj_bias``
(3E rows: q, k, v) split into ``{q,k,v}_proj``.  The keys taken are the
ones the port module of the given configuration has, so a key the state
dict lacks or a key left over raises, with both lists.  DDP's ``module.``
prefixes are stripped (reference online_evaluation/eval1.py:137-153); the
diffusers scheduler entries and BatchNorm's ``num_batches_tracked`` are
ignored, as in JAX.

Tied modules (``weight_tying`` / ``gp_emb_tying``) appear once in the
port: the reference stores a copy per level, which must equal level 0.
Untied levels map level ``i`` to the port's ``{name}_{i}``, and the
planner's ``attn_rounds * feat_scales`` blocks map block ``i`` of every
reference ``ModuleList`` to the port's ``{name}_{i}``, as JAX's
``convert/torch_to_jax.py`` maps them.  The visual trunk mapped is CLIP's
ModifiedResNet-50 (``clip_backbone``), as in JAX: a state dict with a
torchvision ResNet trunk lacks its keys and raises, in both packages.
Every result loads into the port module with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["act3d_from_flax", "act3d_from_reference", "diffusion_planner_from_flax",
           "diffusion_planner_from_reference", "strip_ddp_prefix"]

_ATTN = {f"{p}_{kind}": f"{p}_proj.{'weight' if kind == 'kernel' else 'bias'}"
         for p in ("q", "k", "v", "out") for kind in ("kernel", "bias")}
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value):
    if isinstance(value, torch.Tensor):
        value = value.float().numpy()
    value = np.asarray(value, np.float32)
    if name in _ATTN:
        return _ATTN[name], value.T if value.ndim == 2 else value
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    return _RENAME.get(name, name), value


def _flatten(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{name}.", out)
        else:
            key, array = _leaf(name, value)
            out[prefix + key] = torch.tensor(array)
    return out


def act3d_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`models.Act3D` from ``Act3D`` flax params."""
    return _flatten(params, "", {})


def diffusion_planner_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`models.DiffusionPlanner` from
    ``DiffusionPlanner`` flax params."""
    return _flatten(params, "", {})


# ----------------------------------------------------------------------------
# reference (.pth) -> port
# ----------------------------------------------------------------------------

_IGNORED = ("position_noise_scheduler", "rotation_noise_scheduler")


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop DDP's ``module.`` key prefix."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


class _Mapper:
    """Copies reference tensors under port names and keeps account: every
    reference key must be taken once (``finish``)."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = {k: torch.as_tensor(v).detach().to(torch.float32)
                   for k, v in strip_ddp_prefix(state_dict).items()}
        self.out: Dict[str, torch.Tensor] = {}
        self.used = set()
        self.missing = []

    def take(self, key: str):
        self.used.add(key)
        if key not in self.sd:
            self.missing.append(key)
        return self.sd.get(key)

    def copy(self, tkey: str, pkey: str):
        value = self.take(tkey)
        if value is not None:
            self.out[pkey] = value

    def linear(self, tkey: str, pkey: str):
        self.copy(f"{tkey}.weight", f"{pkey}.weight")
        self.copy(f"{tkey}.bias", f"{pkey}.bias")

    layernorm = linear

    def conv(self, tkey: str, pkey: str, bias: bool = False):
        self.copy(f"{tkey}.weight", f"{pkey}.weight")
        if bias:
            self.copy(f"{tkey}.bias", f"{pkey}.bias")

    def bn(self, tkey: str, pkey: str):
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.copy(f"{tkey}.{name}", f"{pkey}.{name}")

    def embed(self, tkey: str, pkey: str):
        """nn.Embedding(1, F).weight -> a (1, F) parameter."""
        self.copy(f"{tkey}.weight", pkey)

    def mha(self, tkey: str, pkey: str):
        """nn.MultiheadAttention -> the port's four projections."""
        for kind in ("weight", "bias"):
            packed = self.take(f"{tkey}.in_proj_{kind}")
            if packed is not None:
                for name, part in zip("qkv", packed.chunk(3)):
                    self.out[f"{pkey}.{name}_proj.{kind}"] = part
        self.linear(f"{tkey}.out_proj", f"{pkey}.out_proj")

    def tied(self, tkey: str, levels: int):
        """Levels 1.. of a tied ModuleList repeat level 0: check and consume."""
        for i in range(1, levels):
            for key in [k for k in self.sd if k.startswith(f"{tkey}.{i}.")]:
                twin = f"{tkey}.0.{key[len(f'{tkey}.{i}.'):]}"
                if twin not in self.sd or not torch.equal(self.sd[key], self.sd[twin]):
                    raise ValueError(f"{key} differs from {twin}: the levels are not tied")
                self.used.add(key)

    def relative_cross_attn_module(self, tkey: str, pkey: str, num_layers: int):
        """RelativeCrossAttentionModule (reference layers.py:335-351)."""
        for j in range(num_layers):
            self.mha(f"{tkey}.attn_layers.{j}.multihead_attn",
                     f"{pkey}.attn_{j}.multihead_attn")
            self.layernorm(f"{tkey}.attn_layers.{j}.norm", f"{pkey}.attn_{j}.norm")
            for name in ("linear1", "linear2", "norm"):
                self.linear(f"{tkey}.ffw_layers.{j}.{name}", f"{pkey}.ffw_{j}.{name}")

    def parallel_attention(self, tkey: str, pkey: str, num_layers: int, *,
                           self1: bool, ffn: bool, adaln: bool):
        """ParallelAttention (reference layers.py:7-218) with the first
        sequence's blocks that the port's DiffusionHead builds: cross 1<-2,
        optionally self 1, the FFN and AdaLN."""
        for j in range(num_layers):
            t, p = f"{tkey}.layers.{j}", f"{pkey}.layer_{j}"
            blocks = [("cross_12", "norm_12", "adaln_12")]
            if self1:
                blocks.append(("sa1", "norm_1", "adaln_1"))
            for attn, norm, ada in blocks:
                self.mha(f"{t}.{attn}", f"{p}.{attn}")
                self.layernorm(f"{t}.{norm}", f"{p}.{norm}")
                if adaln:  # AdaLN.modulation = Sequential(SiLU, Linear)
                    self.linear(f"{t}.{ada}.modulation.1", f"{p}.{ada}.modulation")
            if ffn:
                self.linear(f"{t}.ffn_12.0", f"{p}.ffn_12_fc1")
                self.linear(f"{t}.ffn_12.3", f"{p}.ffn_12_fc2")
                self.layernorm(f"{t}.norm_122", f"{p}.norm_122")
                if adaln:
                    self.linear(f"{t}.adaln_ff1.modulation.1", f"{p}.adaln_ff1.modulation")

    def clip_backbone(self, tkey: str, pkey: str):
        """CLIP ModifiedResNet-50 (reference clip.py:22-43), blocks (3, 4, 6,
        3) as the port builds it; the first block of each layer has the
        downsample branch."""
        for i in (1, 2, 3):
            self.conv(f"{tkey}.conv{i}", f"{pkey}.conv{i}")
            self.bn(f"{tkey}.bn{i}", f"{pkey}.bn{i}")
        for li, n_blocks in enumerate((3, 4, 6, 3), start=1):
            for b in range(n_blocks):
                t, p = f"{tkey}.layer{li}.{b}", f"{pkey}.layer{li}_{b}"
                for c in (1, 2, 3):
                    self.conv(f"{t}.conv{c}", f"{p}.conv{c}")
                    self.bn(f"{t}.bn{c}", f"{p}.bn{c}")
                if b == 0:
                    self.conv(f"{t}.downsample.0", f"{p}.downsample_conv")
                    self.bn(f"{t}.downsample.1", f"{p}.downsample_bn")

    def fpn(self, tkey: str, pkey: str):
        """torchvision FeaturePyramidNetwork, in its plain-conv
        (``inner_blocks.N.weight``) or Conv2dNormActivation
        (``inner_blocks.N.0.weight``) layout."""
        for i, name in enumerate(("res1", "res2", "res3", "res4", "res5")):
            for t_block, p_block in ((f"inner_blocks.{i}", f"inner_{name}"),
                                     (f"layer_blocks.{i}", f"layer_{name}")):
                t = f"{tkey}.{t_block}"
                if f"{t}.weight" not in self.sd:
                    t += ".0"
                self.conv(t, f"{pkey}.{p_block}", bias=True)

    def finish(self) -> Dict[str, torch.Tensor]:
        unused = [k for k in self.sd if k not in self.used
                  and not k.startswith(_IGNORED) and "num_batches_tracked" not in k]
        if self.missing or unused:
            raise KeyError(f"reference state dict does not match the port: missing "
                           f"{self.missing[:20]}, unused {unused[:20]}")
        return self.out


def act3d_from_reference(
    state_dict: Mapping[str, Any],
    *,
    num_sampling_level: int = 3,
    weight_tying: bool = True,
    gp_emb_tying: bool = True,
    use_instruction: bool = True,
    regress_position_offset: bool = False,
    num_ghost_point_cross_attn_layers: int = 2,
    num_query_cross_attn_layers: int = 2,
    num_vis_ins_attn_layers: int = 2,
) -> Dict[str, torch.Tensor]:
    """State dict of :class:`models.Act3D` from a reference Act3D ``.pth``
    state dict, levels tied or untied."""
    m = _Mapper(state_dict)
    m.clip_backbone("backbone", "visual.backbone")
    m.fpn("feature_pyramid", "visual.feature_pyramid")
    if gp_emb_tying:
        m.embed("ghost_points_embed_pyramid.0", "ghost_points_embed")
        m.tied("ghost_points_embed_pyramid", num_sampling_level)
    else:
        for i in range(num_sampling_level):
            m.embed(f"ghost_points_embed_pyramid.{i}", f"ghost_points_embed_{i}")
    m.embed("curr_gripper_embed", "curr_gripper_embed")
    m.embed("query_embed", "query_embed")
    stacks = [("ghost_point_cross_attn", num_ghost_point_cross_attn_layers),
              ("query_cross_attn", num_query_cross_attn_layers)]
    if use_instruction:
        stacks.append(("vis_ins_attn", num_vis_ins_attn_layers))
        m.linear("instruction_encoder", "instruction_encoder")
    for name, n_layers in stacks:
        if weight_tying:
            m.relative_cross_attn_module(f"{name}_pyramid.0", name, n_layers)
            m.tied(f"{name}_pyramid", num_sampling_level)
        else:
            for i in range(num_sampling_level):
                m.relative_cross_attn_module(f"{name}_pyramid.{i}", f"{name}_{i}", n_layers)
    if regress_position_offset:
        m.linear("ghost_point_offset_predictor.0", "ghost_point_offset_fc1")
        m.linear("ghost_point_offset_predictor.2", "ghost_point_offset_fc2")
    m.linear("gripper_state_predictor.0", "gripper_state_fc1")
    m.linear("gripper_state_predictor.2", "gripper_state_fc2")
    return m.finish()


def diffusion_planner_from_reference(
    state_dict: Mapping[str, Any],
    *,
    use_instruction: bool = True,
    use_goal: bool = True,
    attn_rounds: int = 1,
    feat_scales: int = 1,
    num_query_cross_attn_layers: int = 6,
    num_vis_ins_attn_layers: int = 2,
) -> Dict[str, torch.Tensor]:
    """State dict of :class:`models.DiffusionPlanner` from a reference
    DiffusionPlanner ``.pth`` state dict with ``attn_rounds * feat_scales``
    blocks."""
    m = _Mapper(state_dict)
    t, p = "prediction_head", "prediction_head"
    m.clip_backbone(f"{t}.backbone", f"{p}.visual.backbone")
    m.fpn(f"{t}.feature_pyramid", f"{p}.visual.feature_pyramid")
    m.linear(f"{t}.traj_encoder.0", f"{p}.traj_enc_fc1")
    m.linear(f"{t}.traj_encoder.3", f"{p}.traj_enc_fc2")
    m.linear(f"{t}.curr_gripper_encoder", f"{p}.curr_gripper_encoder")
    if use_goal:
        m.linear(f"{t}.goal_gripper_encoder", f"{p}.goal_gripper_encoder")
    # the reference builds instruction_encoder whatever use_instruction is;
    # the port only when it is used
    if use_instruction:
        m.linear(f"{t}.instruction_encoder", f"{p}.instruction_encoder")
    else:
        m.used.update(k for k in m.sd if k.startswith(f"{t}.instruction_encoder."))
    m.embed(f"{t}.curr_gripper_embed", f"{p}.curr_gripper_embed")
    m.embed(f"{t}.goal_gripper_embed", f"{p}.goal_gripper_embed")
    for i in range(attn_rounds * feat_scales):
        if use_instruction:
            m.parallel_attention(f"{t}.vl_attention.{i}", f"{p}.vl_attention_{i}",
                                 num_vis_ins_attn_layers, self1=False, ffn=True, adaln=False)
            m.parallel_attention(f"{t}.traj_lang_attention.{i}", f"{p}.traj_lang_attention_{i}",
                                 1, self1=False, ffn=False, adaln=False)
        for name, n_layers in (("traj_attention", num_query_cross_attn_layers - 2),
                               ("pos_attention", 2), ("rot_attention", 2)):
            m.parallel_attention(f"{t}.{name}.{i}", f"{p}.{name}_{i}", n_layers,
                                 self1=True, ffn=True, adaln=True)
        for name in ("pos_regressor", "rot_regressor"):
            m.linear(f"{t}.{name}.{i}.0", f"{p}.{name}_{i}_fc1")
            m.linear(f"{t}.{name}.{i}.3", f"{p}.{name}_{i}_fc2")
    return m.finish()
