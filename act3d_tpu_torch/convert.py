"""Weight bridge: a flax ``params`` tree -> a state_dict of the port.

The port's submodules carry the flax names (``visual.backbone.layer1_0.conv1``,
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

Tied modules (``weight_tying`` / ``gp_emb_tying``) appear once in the flax
tree and once in the port, so they map once.  The tree is nested dicts of
numpy arrays (``jax.device_get`` of the params); the result loads into the
port module with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["act3d_from_flax", "diffusion_planner_from_flax"]

_ATTN = {f"{p}_{kind}": f"{p}_proj.{'weight' if kind == 'kernel' else 'bias'}"
         for p in ("q", "k", "v", "out") for kind in ("kernel", "bias")}
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value: np.ndarray):
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
