"""Depth-based host -> device wire for point clouds, a copy of
``act3d_tpu/data/depthwire.py`` for the port.

The episode schema ships per-pixel WORLD coordinates (3 channels).  The
XYZ image is a function of the 1-channel depth map and the camera model,
so the depth wire ships depth + (intrinsics, extrinsics) and rebuilds the
XYZ image on the card.  It is exact up to the u16 depth step:
  * RLBench clouds are the depth buffer reprojected through the camera
    model; ``pinhole_residual`` checks this per episode at load and the
    dataset falls back to the XYZ wire for data that fails it;
  * the Resize augmentation is NEAREST, an index remap, so shipping the
    original depth plus the per-axis source-index maps and gathering on
    the card gives the host's augmented XYZ image (same source pixel,
    same ray);
  * the yaw Rotate is a rigid world transform, folded into the
    camera-to-world extrinsic on the host.

Batch keys (``RLBenchDataset(wire="depth")``, decoded by
``compact.expand_batch``):
  depth     (B, ncam, H, W)   f32 metres (u16 on the wire)
  cam_intr  (B, ncam, 3, 3)   f32 pinhole K (zero skew)
  cam_c2w   (B, ncam, 4, 4)   f32 camera -> world
  aug_rows  (B, H) int32      source row of each output row   (optional)
  aug_cols  (B, W) int32      source column of each output column (optional)
``rgbs`` ride the wire unresized; ``expand_batch`` gathers them with the
same maps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["derive_depth", "pinhole_residual", "reconstruct_pcds", "gather_hw"]


# ------------------------------------------------------------------ host side
def derive_depth(pcd: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Per-pixel camera-frame z from a world-XYZ image.

    pcd: (..., 3, H, W) world coordinates; c2w: (..., 4, 4) camera -> world.
    Returns (..., H, W) float32 camera z (metric depth).
    """
    pcd = np.asarray(pcd, np.float64)
    c2w = np.asarray(c2w, np.float64)
    w2c = np.linalg.inv(c2w)
    r2 = w2c[..., 2, :3]  # z_cam = R_w2c[2] . p + t_w2c[2]
    t2 = w2c[..., 2, 3]
    depth = np.einsum("...k,...khw->...hw", r2, pcd) + t2[..., None, None]
    return depth.astype(np.float32)


def pinhole_residual(pcd: np.ndarray, depth: np.ndarray, intr: np.ndarray,
                     c2w: np.ndarray, stride: int = 7) -> float:
    """Max |reconstructed - stored| (metres) on a pixel subsample: the
    dataset falls back to the XYZ wire above a tolerance."""
    pcd = np.asarray(pcd, np.float64)
    h, w = pcd.shape[-2:]
    vs = np.arange(0, h, stride)
    us = np.arange(0, w, stride)
    sub = pcd[..., vs[:, None], us[None, :]]
    dsub = np.asarray(depth, np.float64)[..., vs[:, None], us[None, :]]
    intr = np.asarray(intr, np.float64)
    fx = intr[..., 0, 0][..., None, None]
    fy = intr[..., 1, 1][..., None, None]
    cx = intr[..., 0, 2][..., None, None]
    cy = intr[..., 1, 2][..., None, None]
    x = (us[None, :] - cx) / fx * dsub
    y = (vs[:, None] - cy) / fy * dsub
    cam = np.stack([x, y, dsub], axis=-3)  # (..., 3, hs, ws)
    c2w = np.asarray(c2w, np.float64)
    rec = (np.einsum("...ik,...khw->...ihw", c2w[..., :3, :3], cam)
           + c2w[..., :3, 3][..., None, None])
    return float(np.max(np.abs(rec - sub)))


# ---------------------------------------------------------------- device side
def gather_hw(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Outer-index gather ``a[b, ..., rows[b], :][..., cols[b]]`` per sample.

    a: (B, ..., H, W); rows: (B, H'); cols: (B, W').  Two ``torch.gather``
    calls on per-sample index maps; no arithmetic touches the values."""
    b, h, w = a.shape[0], a.shape[-2], a.shape[-1]
    lead = a.shape[1:-2]
    ones = (1,) * len(lead)
    rows = rows.to(device=a.device, dtype=torch.int64)
    cols = cols.to(device=a.device, dtype=torch.int64)
    r = rows.view(b, *ones, -1, 1).expand(b, *lead, rows.shape[1], w)
    x = torch.gather(a, -2, r)
    c = cols.view(b, *ones, 1, -1).expand(b, *lead, rows.shape[1], cols.shape[1])
    return torch.gather(x, -1, c)


def reconstruct_pcds(depth: torch.Tensor, intr: torch.Tensor, c2w: torch.Tensor,
                     rows: Optional[torch.Tensor] = None,
                     cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World-XYZ image from depth + camera model, on the depth's device.

    depth: (B, ncam, H, W) f32 metres, the ORIGINAL (unaugmented) map;
    intr: (B, ncam, 3, 3); c2w: (B, ncam, 4, 4); rows / cols: optional
    (B, H) / (B, W) source-index maps of the host's NEAREST Resize draw
    (``augment.Resize.sample_index_maps``).  Returns (B, ncam, 3, H, W)
    world coordinates.  Each output pixel takes the ray of its SOURCE pixel
    (``u = cols``, ``v = rows``), not of its output position."""
    b, ncam, h, w = depth.shape
    if rows is not None:
        depth = gather_hw(depth, rows, cols)
        u = cols[:, None, None, :].to(device=depth.device, dtype=depth.dtype)  # (B, 1, 1, W)
        v = rows[:, None, :, None].to(device=depth.device, dtype=depth.dtype)  # (B, 1, H, 1)
    else:
        u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, None, None, :]
        v = torch.arange(h, dtype=depth.dtype, device=depth.device)[None, None, :, None]
    fx = intr[..., 0, 0][..., None, None]
    fy = intr[..., 1, 1][..., None, None]
    cx = intr[..., 0, 2][..., None, None]
    cy = intr[..., 1, 2][..., None, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    cam = torch.stack([x, y, depth], dim=2)  # (B, ncam, 3, H, W)
    rot = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    return torch.einsum("bnik,bnkhw->bnihw", rot, cam) + t[..., None, None]
