"""Compact host -> device batch encodings, a copy of
``act3d_tpu/data/compact.py`` for the port.

The host encodes, the card decodes:
  * rgbs (f32 in [0, 1]) -> uint8: lossless for episode RGB, which comes
    from uint8 sensor images (neither the NEAREST Resize nor the yaw
    rotation leaves that palette); 4x smaller;
  * pcds (f32 metres) -> uint16 over ``PCD_U16_BOUNDS`` (+-3.2 m, a
    0.098 mm step; points outside clip), or float16 with
    ``pcd_mode="f16"``; 2x smaller;
  * depth (f32 metres, the depth wire of ``depthwire.py``) -> uint16 over
    ``DEPTH_U16_RANGE`` (0-6.4 m; depths beyond it clamp to 6.4 m).

``expand_batch`` dispatches on dtype, so no metadata rides the batch and it
is the identity on float batches: the loss functions call it
unconditionally.  PyTorch's ``uint16`` has few ops, so every decode
converts with ``.to(torch.float32)`` before the affine map.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["compact_batch", "expand_batch", "PCD_U16_BOUNDS", "DEPTH_U16_RANGE"]

_RGB_KEYS = ("rgbs",)
_PCD_KEYS = ("pcds",)
_DEPTH_KEYS = ("depth",)

# fixed workspace bounds of the uint16 pcd encoding (metres), shared by
# compact_batch and expand_batch
PCD_U16_BOUNDS = (-3.2, 3.2)

# camera-z range of the uint16 depth encoding (metres): a ~0.098 mm step,
# a world-space error below 0.2 mm
DEPTH_U16_RANGE = (0.0, 6.4)


def _u16(v: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.rint((np.clip(v, lo, hi) - lo) * (65535.0 / (hi - lo))).astype(np.uint16)


def compact_batch(batch: Dict, pcd_mode: str = "u16") -> Dict:
    """Host-side (numpy) encode: uint8 rgbs, u16 (default) or f16 pcds,
    u16 depth.  Other keys pass through."""
    out = dict(batch)
    for k in _RGB_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == np.float32:
            out[k] = np.rint(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)
    for k in _PCD_KEYS:
        v = out.get(k)
        if v is None or v.dtype != np.float32:
            continue
        if pcd_mode == "u16":
            out[k] = _u16(v, *PCD_U16_BOUNDS)
        elif pcd_mode == "f16":
            out[k] = v.astype(np.float16)
        else:
            raise ValueError(f"unknown pcd_mode {pcd_mode!r}")
    for k in _DEPTH_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == np.float32:
            out[k] = _u16(v, *DEPTH_U16_RANGE)
    return out


def _from_u16(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return v.to(torch.float32) * ((hi - lo) / 65535.0) + lo


def expand_batch(batch: Dict) -> Dict:
    """Decode on the batch's device; the identity on float batches.

    Depth-wire batches (``RLBenchDataset(wire="depth")``: ``depth``,
    ``cam_intr``, ``cam_c2w`` and optional ``aug_rows`` / ``aug_cols``
    index maps) come out with the canonical ``pcds`` / ``rgbs`` keys: the
    XYZ image is rebuilt from the depth and the NEAREST Resize is a gather
    (``depthwire.py``)."""
    out = dict(batch)
    for k in _RGB_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == torch.uint8:
            # a true division on every device: CUDA divides by a CPU scalar
            # through its reciprocal, 1 ulp off the CPU's quotient
            out[k] = v.to(torch.float32) / torch.full((), 255.0, device=v.device)
    for k in _PCD_KEYS:
        v = out.get(k)
        if v is None:
            continue
        if v.dtype == torch.uint16:
            out[k] = _from_u16(v, *PCD_U16_BOUNDS)
        elif v.dtype == torch.float16:
            out[k] = v.to(torch.float32)
    for k in _DEPTH_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == torch.uint16:
            out[k] = _from_u16(v, *DEPTH_U16_RANGE)
    if "depth" in out and "cam_intr" in out:
        from .depthwire import gather_hw, reconstruct_pcds

        rows = out.pop("aug_rows", None)
        cols = out.pop("aug_cols", None)
        out["pcds"] = reconstruct_pcds(out.pop("depth"), out.pop("cam_intr"),
                                       out.pop("cam_c2w"), rows=rows, cols=cols)
        if rows is not None and "rgbs" in out:
            out["rgbs"] = gather_hw(out["rgbs"], rows, cols)
    return out
