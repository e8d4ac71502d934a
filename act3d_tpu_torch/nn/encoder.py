"""Shared visual encoding: frozen CLIP trunk + FPN + token pyramids (PyTorch).

Counterpart of ``act3d_tpu/nn/encoder.py``.  Convolutions run in NCHW
with cameras folded into the batch; the outputs are in the JAX package's
layout: (B, ncam * H_i * W_i, F) tokens in camera-major, row-major order,
and the matching (B, ncam * H_i * W_i, 3) point-cloud levels, resized
bilinearly with align_corners=False and no antialias (what
``jax.image.resize(..., "linear", antialias=False)`` computes).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fpn import FeaturePyramidNetwork
from .resnet import CLIP_MEAN, CLIP_STD, ClipModifiedResNet


def pyramid_layout(image_size: Tuple[int, int]):
    """(feature_map_pyramid, downscaling_factor_pyramid) per image size."""
    image_size = tuple(image_size)
    if image_size in ((64, 64), (128, 128)):
        return ["res2", "res1", "res1", "res1"], [4, 2, 2, 2]
    if image_size == (256, 256):
        return ["res3", "res1", "res1", "res1"], [8, 2, 2, 2]
    raise ValueError(f"unsupported image size {image_size}")


class VisualEncoder(nn.Module):
    """rgb (B, ncam, 3, H, W) in [0, 1] and pcd (B, ncam, 3, H, W) ->
    (per-level tokens, per-level point clouds)."""

    def __init__(self, image_size=(256, 256), embedding_dim: int = 60,
                 num_sampling_level: int = 3):
        super().__init__()
        self.image_size = tuple(image_size)
        self.embedding_dim = embedding_dim
        self.num_sampling_level = num_sampling_level
        self.backbone = ClipModifiedResNet()
        self.feature_pyramid = FeaturePyramidNetwork(
            self.backbone.out_channels, embedding_dim
        )
        self.register_buffer("rgb_mean", torch.tensor(CLIP_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(CLIP_STD)[:, None, None],
                             persistent=False)

    def forward(self, rgb, pcd) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        b, ncam, _, h, w = rgb.shape
        feature_maps, downscale = pyramid_layout(self.image_size)
        # the constants in the image's dtype, as JAX's normalize_rgb: a bf16
        # image stays bf16 into the bf16 trunk
        mean, std = self.rgb_mean.to(rgb.dtype), self.rgb_std.to(rgb.dtype)
        images = (rgb.reshape(b * ncam, 3, h, w) - mean) / std
        feats = self.feature_pyramid(self.backbone(images))
        clouds = pcd.reshape(b * ncam, 3, h, w)
        rgb_feats_pyramid, pcd_pyramid = [], []
        for i in range(self.num_sampling_level):
            hi, wi = h // downscale[i], w // downscale[i]
            f_i = feats[feature_maps[i]].permute(0, 2, 3, 1)
            pcd_i = F.interpolate(clouds, size=(hi, wi), mode="bilinear",
                                  align_corners=False, antialias=False)
            rgb_feats_pyramid.append(f_i.reshape(b, ncam * hi * wi, self.embedding_dim))
            pcd_pyramid.append(pcd_i.permute(0, 2, 3, 1).reshape(b, ncam * hi * wi, 3))
        return rgb_feats_pyramid, pcd_pyramid
