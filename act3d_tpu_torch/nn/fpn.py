"""Feature Pyramid Network (PyTorch, NCHW).

Counterpart of ``act3d_tpu/nn/fpn.py``: 1x1 lateral convs, nearest
top-down upsampling and 3x3 output convs, biases on; submodules are
``inner_{level}`` and ``layer_{level}`` as in flax.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def _upsample_nearest_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    in_h, in_w = x.shape[-2:]
    if h % in_h or w % in_w:
        raise ValueError(f"non-integer upsampling {in_h}x{in_w} -> {h}x{w}")
    return x.repeat_interleave(h // in_h, dim=-2).repeat_interleave(w // in_w, dim=-1)


class FeaturePyramidNetwork(nn.Module):
    """Top-down FPN over {level: (N, C_level, H, W)}, bottom (highest
    resolution) level first in ``in_channels``."""

    def __init__(self, in_channels: Dict[str, int], out_channels: int):
        super().__init__()
        self.names = list(in_channels)
        for n, c in in_channels.items():
            setattr(self, f"inner_{n}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"layer_{n}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = self.names
        last = getattr(self, f"inner_{names[-1]}")(feats[names[-1]])
        results = {names[-1]: getattr(self, f"layer_{names[-1]}")(last)}
        for n in reversed(names[:-1]):
            lateral = getattr(self, f"inner_{n}")(feats[n])
            last = lateral + _upsample_nearest_to(last, *lateral.shape[-2:])
            results[n] = getattr(self, f"layer_{n}")(last)
        return results
