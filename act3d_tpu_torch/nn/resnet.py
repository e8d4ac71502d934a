"""Frozen visual trunks (PyTorch, NCHW): CLIP ModifiedResNet-50 and the
torchvision-style ResNet-50.

Counterparts of ``act3d_tpu/nn/resnet.py::ClipModifiedResNet`` and
``TorchResNet50``.  Both return {res1..res5} at strides {2, 4, 8, 16, 32}.
CLIP's res1 is the stem output before the stem avg-pool, and its
bottlenecks stride through an avg-pool (CLIP's anti-aliased form); the
ResNet's res1 is the post-stem ReLU output before the max-pool, and its
bottlenecks stride on conv2.  BatchNorm is frozen: the running statistics
are buffers that are never updated.  Weights come through the flax bridge
(``convert.py``) or a checkpoint; nothing is downloaded.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """BatchNorm in permanent eval mode over NCHW."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=kernel // 2,
                     bias=False)


class ClipBottleneck(nn.Module):
    """CLIP's Bottleneck: expansion 4, stride via AvgPool."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.has_downsample = stride > 1 or inplanes != out_ch
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, out_ch, 1)
            self.downsample_bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(h + identity)


class ClipModifiedResNet(nn.Module):
    """CLIP RN50 trunk: 3-conv stem, then layer1..layer4 as ``layer{i}_{j}``."""

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.layers = layers
        self.conv1 = _conv(3, width // 2, 3, stride=2)
        self.bn1 = FrozenBatchNorm(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3)
        self.bn2 = FrozenBatchNorm(width // 2)
        self.conv3 = _conv(width // 2, width, 3)
        self.bn3 = FrozenBatchNorm(width)
        inplanes = width
        planes = [width, width * 2, width * 4, width * 8]
        strides = [1, 2, 2, 2]
        for li, (n_blocks, p, s) in enumerate(zip(layers, planes, strides), start=1):
            for bi in range(n_blocks):
                setattr(self, f"layer{li}_{bi}",
                        ClipBottleneck(inplanes, p, s if bi == 0 else 1))
                inplanes = p * 4
        self.out_channels = {"res1": width, **{f"res{i + 2}": p * 4
                                               for i, p in enumerate(planes)}}

    def forward(self, x) -> Dict[str, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        res1 = F.relu(self.bn3(self.conv3(h)))
        h = F.avg_pool2d(res1, 2)
        feats = {"res1": res1}
        for li, n_blocks in enumerate(self.layers, start=1):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{li}_{bi}")(h)
            feats[f"res{li + 1}"] = h
        return feats


class TorchBottleneck(nn.Module):
    """torchvision's Bottleneck: expansion 4, stride on conv2."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.has_downsample = stride > 1 or inplanes != out_ch
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, out_ch, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(h + identity)


class TorchResNet50(nn.Module):
    """torchvision ResNet-50 trunk: 7x7 stem, max-pool, then layer1..layer4
    as ``layer{i}_{j}``."""

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = layers
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        planes = [64, 128, 256, 512]
        for li, (n_blocks, p, s) in enumerate(zip(layers, planes, [1, 2, 2, 2]), start=1):
            for bi in range(n_blocks):
                setattr(self, f"layer{li}_{bi}",
                        TorchBottleneck(inplanes, p, s if bi == 0 else 1))
                inplanes = p * 4
        self.out_channels = {"res1": 64, **{f"res{i + 2}": p * 4 for i, p in enumerate(planes)}}

    def forward(self, x) -> Dict[str, torch.Tensor]:
        res1 = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(res1, 3, stride=2, padding=1)  # pads with -inf
        feats = {"res1": res1}
        for li, n_blocks in enumerate(self.layers, start=1):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{li}_{bi}")(h)
            feats[f"res{li + 1}"] = h
        return feats
