"""Seeded weights, made on the device in one draw.

The layout (names, shapes, kinds) is read from the reference's module
tree, never from the system under test; the same state dict is loaded
into both.  Scales follow PyTorch's default initialisation: matrices and
convolutions uniform in +-1/sqrt(fan_in) and their biases alike, learned
embeddings (``*_embed``) of unit variance, LayerNorm and frozen batch
norm at their identity values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

_IDENTITY = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0}


def _entries(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, scale or a constant fill as ("const", value)) for every
    entry of ``model.state_dict()``, in its order."""
    fan_in = {}
    for prefix, module in model.named_modules():
        w = getattr(module, "weight", None)
        if isinstance(module, (nn.Linear, nn.Conv2d)) and w is not None:
            fan_in[prefix] = math.prod(w.shape[1:])
    out = []
    for name, t in model.state_dict().items():
        prefix, _, leaf = name.rpartition(".")
        if prefix in fan_in:
            out.append((name, tuple(t.shape), 1.0 / math.sqrt(fan_in[prefix])))
        elif leaf.endswith("_embed"):
            out.append((name, tuple(t.shape), math.sqrt(3.0)))
        elif leaf in _IDENTITY:  # LayerNorm and frozen batch norm
            out.append((name, tuple(t.shape), ("const", _IDENTITY[leaf])))
        else:
            raise ValueError(f"no initialisation rule for {name}")
    return out


def seeded_state(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``model``'s state dict, the
    random entries cut from one uniform draw of a generator seeded with
    ``seed``."""
    entries = _entries(model)
    total = sum(math.prod(s) for _, s, kind in entries if not isinstance(kind, tuple))
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    state, offset = {}, 0
    for name, shape, kind in entries:
        if isinstance(kind, tuple):
            state[name] = torch.full(shape, kind[1], device=device)
            continue
        n = math.prod(shape)
        state[name] = flat[offset:offset + n].view(shape).mul_(kind)
        offset += n
    return state


def meta_model(cls, **kwargs) -> nn.Module:
    """The reference module built without memory, for its layout."""
    with torch.device("meta"):
        return cls(**kwargs)


def materialise(cls, state: Dict[str, torch.Tensor], device, **kwargs) -> nn.Module:
    """The reference module on ``device`` holding ``state``; its
    non-persistent buffers (workspace bounds, normalisation constants) are
    built anew from ``kwargs``."""
    with torch.device(device):
        model = cls(**kwargs)
    model.load_state_dict(state)
    return model
