"""Plain PyTorch visual encoder of the reference: CLIP's ModifiedResNet-50
trunk with frozen batch norm, the feature pyramid, and the token and
point-cloud pyramids.

Written for the benchmark after CLIP's ModifiedResNet (Radford et al.,
2021; ``act3d_tpu/nn/resnet.py``), torchvision's FPN
(``act3d_tpu/nn/fpn.py``) and ``act3d_tpu/nn/encoder.py``: a 3-conv stem
whose last output is res1, bottlenecks that stride through an avg-pool,
{res1..res5} at strides {2, 4, 8, 16, 32}; 1x1 laterals, nearest top-down
upsampling, 3x3 output convolutions; tokens (B, ncam * h * w, F) in
camera-major, row-major order, point clouds resized bilinearly
(align_corners=False) to each level.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
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


def _conv(c_in, c_out, kernel, stride=1):
    return nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=kernel // 2, bias=False)


class ClipBottleneck(nn.Module):
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
    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), width: int = 64):
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
        for li, (n, p, s) in enumerate(zip(layers, planes, [1, 2, 2, 2]), start=1):
            for bi in range(n):
                setattr(self, f"layer{li}_{bi}", ClipBottleneck(inplanes, p, s if bi == 0 else 1))
                inplanes = p * 4
        self.out_channels = {"res1": width, **{f"res{i + 2}": p * 4 for i, p in enumerate(planes)}}

    def forward(self, x) -> Dict[str, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        res1 = F.relu(self.bn3(self.conv3(h)))
        h = F.avg_pool2d(res1, 2)
        feats = {"res1": res1}
        for li, n in enumerate(self.layers, start=1):
            for bi in range(n):
                h = getattr(self, f"layer{li}_{bi}")(h)
            feats[f"res{li + 1}"] = h
        return feats


class FeaturePyramidNetwork(nn.Module):
    def __init__(self, in_channels: Dict[str, int], out_channels: int):
        super().__init__()
        self.names = list(in_channels)
        for n, c in in_channels.items():
            setattr(self, f"inner_{n}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"layer_{n}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats):
        names = self.names
        last = getattr(self, f"inner_{names[-1]}")(feats[names[-1]])
        results = {names[-1]: getattr(self, f"layer_{names[-1]}")(last)}
        for n in reversed(names[:-1]):
            lateral = getattr(self, f"inner_{n}")(feats[n])
            fh, fw = lateral.shape[-2] // last.shape[-2], lateral.shape[-1] // last.shape[-1]
            last = lateral + last.repeat_interleave(fh, dim=-2).repeat_interleave(fw, dim=-1)
            results[n] = getattr(self, f"layer_{n}")(last)
        return results


def pyramid_layout(image_size):
    """(feature map per level, downscaling per level) by image size."""
    if tuple(image_size) in ((64, 64), (128, 128)):
        return ["res2", "res1", "res1", "res1"], [4, 2, 2, 2]
    if tuple(image_size) == (256, 256):
        return ["res3", "res1", "res1", "res1"], [8, 2, 2, 2]
    raise ValueError(f"unsupported image size {image_size}")


class VisualEncoder(nn.Module):
    """rgb (B, ncam, 3, H, W) in [0, 1], pcd (B, ncam, 3, H, W) -> per-level
    tokens (B, ncam * h * w, F) and point clouds (B, ncam * h * w, 3)."""

    def __init__(self, image_size, embedding_dim: int, num_levels: int):
        super().__init__()
        self.image_size = tuple(image_size)
        self.embedding_dim = embedding_dim
        self.num_levels = num_levels
        self.backbone = ClipModifiedResNet()
        self.feature_pyramid = FeaturePyramidNetwork(self.backbone.out_channels, embedding_dim)
        self.register_buffer("rgb_mean", torch.tensor(CLIP_MEAN)[:, None, None], persistent=False)
        self.register_buffer("rgb_std", torch.tensor(CLIP_STD)[:, None, None], persistent=False)

    def forward(self, rgb, pcd) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        b, ncam, _, h, w = rgb.shape
        maps, down = pyramid_layout(self.image_size)
        feats = self.feature_pyramid(self.backbone(
            (rgb.reshape(b * ncam, 3, h, w) - self.rgb_mean) / self.rgb_std))
        clouds = pcd.reshape(b * ncam, 3, h, w)
        tokens, points = [], []
        for i in range(self.num_levels):
            hi, wi = h // down[i], w // down[i]
            tokens.append(feats[maps[i]].permute(0, 2, 3, 1).reshape(b, ncam * hi * wi, -1))
            p = F.interpolate(clouds, size=(hi, wi), mode="bilinear", align_corners=False)
            points.append(p.permute(0, 2, 3, 1).reshape(b, ncam * hi * wi, 3))
        return tokens, points
