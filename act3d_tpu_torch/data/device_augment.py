"""Training augmentations on the card, the port of
``act3d_tpu/data/device_augment.py``.

The counterpart of the host transforms of ``augment.py`` (reference
datasets/utils.py:40-181), applied inside the training step so the host
only decodes and stacks (``RLBenchDataset(augment_host=False)``).  For the
same draws the result equals the host's:
  * :func:`resize_with_params` = ``augment.Resize``: NEAREST scale resize
    (src = floor(dst * in / out)), bottom/right reflect pad, crop; one
    source-index map per axis and sample from integer arithmetic, so the
    output is the host's bit for bit, then a gather
    (``depthwire.gather_hw``);
  * :func:`yaw_rotate_batch` = ``augment.Rotate``: up to ``num_tries``
    yaw draws with workspace-bound rejection, the first acceptable draw
    applied to the clouds and the xyzw poses; a sample whose every try
    lands out of bounds keeps its input.

Draws come from a ``torch.Generator`` on the batch's device, or from the
Trainer's ``Generators`` (their device generator, drawn at the global
batch and sliced to this rank's rows, ``nn.dropout.draw``), in a fixed
order: yaws (B, num_tries) when the yaw
range is not 0, then scales (B,) and crop uniforms (B, 2) when the rescale
range is not (1, 1).  JAX's ``jax.random`` keys cannot be matched, so
parity is held with injected draws (``resize_with_params``, ``yaws=``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..nn.dropout import draw
from .depthwire import gather_hw

__all__ = ["resize_with_params", "resize_sample", "yaw_rotate_batch", "make_device_augment"]


# --------------------------------------------------------------------- resize
def _axis_src_index(out_len: int, new: torch.Tensor, crop: torch.Tensor) -> torch.Tensor:
    """(B, out_len) source index of each output pixel for a scale resize to
    ``new`` (B,) pixels, a reflect pad back to ``out_len`` and a crop at
    ``crop`` (B,): position p = r + crop, mirrored to 2 new - 2 - p past the
    resized edge (numpy's 'reflect'), then src = floor(p * out_len / new),
    clipped.  Integers throughout: the host's float64 floor exactly."""
    r = torch.arange(out_len, device=new.device)[None, :]
    p = r + crop[:, None]
    new = new[:, None]
    p = torch.where(p < new, p, 2 * new - 2 - p)
    return torch.clamp(torch.div(p * out_len, new, rounding_mode="floor"), 0, out_len - 1)


def _new_len(length: int, scale: torch.Tensor) -> torch.Tensor:
    """floor(length * scale) in float64, as the host's ``int(raw * sc)``."""
    return torch.floor(length * scale.to(torch.float64)).to(torch.int64)


def resize_with_params(arrays: Dict[str, torch.Tensor], scale, crop_i, crop_j
                       ) -> Dict[str, torch.Tensor]:
    """The deterministic core of :func:`resize_sample`.

    arrays: {name: (B, ..., H, W)} with one (H, W); scale, crop_i, crop_j:
    (B,) tensors or numbers, one per sample.  Returns the arrays resized,
    padded and cropped back to (H, W)."""
    first = next(iter(arrays.values()))
    b, (h, w), dev = first.shape[0], first.shape[-2:], first.device

    def per_sample(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(b)

    scale = per_sample(scale, torch.float64)
    rows = _axis_src_index(h, _new_len(h, scale), per_sample(crop_i, torch.int64))
    cols = _axis_src_index(w, _new_len(w, scale), per_sample(crop_j, torch.int64))
    return {n: gather_hw(a, rows, cols) for n, a in arrays.items()}


def resize_sample(arrays: Dict[str, torch.Tensor], scale: torch.Tensor,
                  crop_u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One random-scale resize + crop per sample.

    scale: (B,) in the rescale range; crop_u: (B, 2) uniforms in [0, 1)
    that pick each sample's crop offsets uniformly in [0, new - size] (0
    when the scaled image is not larger than the frame, as the host)."""
    first = next(iter(arrays.values()))
    h, w = first.shape[-2:]

    def offset(length, u):
        span = torch.clamp(_new_len(length, scale) - length, min=0) + 1
        return torch.minimum((u.to(torch.float64) * span).to(torch.int64), span - 1)

    return resize_with_params(arrays, scale, offset(h, crop_u[:, 0]), offset(w, crop_u[:, 1]))


# --------------------------------------------------------------------- rotate
def _quat_xyzw_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3), augment.py's formula."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = torch.sum(q * q, dim=-1)
    s = 2.0 / torch.clamp(n, min=1e-12)
    rows = [
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _matrix_to_quat_xyzw(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) xyzw, the stable component method."""
    def half_sqrt(a, b, c):
        return 0.5 * torch.sqrt(torch.clamp(1 + a * m[..., 0, 0] + b * m[..., 1, 1]
                                            + c * m[..., 2, 2], min=0.0))

    w = half_sqrt(1, 1, 1)
    x = torch.copysign(half_sqrt(1, -1, -1), m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(half_sqrt(-1, 1, -1), m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(half_sqrt(-1, -1, 1), m[..., 1, 0] - m[..., 0, 1])
    q = torch.stack([x, y, z, w], dim=-1)
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-10)


def _rot_pose(pose: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate (B, N, 7+) xyzw poses by one (3, 3) matrix per sample (B, 3, 3)."""
    pos = pose[..., :3] @ rot.transpose(-1, -2)
    quat = _matrix_to_quat_xyzw(rot[:, None] @ _quat_xyzw_to_matrix(pose[..., 3:7]))
    return torch.cat([pos, quat, pose[..., 7:]], dim=-1)


def yaw_rotate_batch(
    generator: Optional[torch.Generator],
    pcds: torch.Tensor,  # (B, ncam, 3, H, W)
    poses: Dict[str, torch.Tensor],  # name -> (B, ..., 7+) xyzw poses
    *,
    yaw_range_rad: float,
    bounds: torch.Tensor,  # (2, 3) workspace bounds
    bound_keys: Tuple[str, ...] = ("curr_gripper", "action"),
    num_tries: int = 10,
    yaws: Optional[torch.Tensor] = None,  # (B, num_tries) injected draws
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-sample yaw augmentation with bound rejection (``augment.Rotate``):
    yaws (B, num_tries) uniform in [-range, range) unless injected."""
    b, dev = pcds.shape[0], pcds.device
    if yaws is None:
        yaws = (draw(generator, torch.rand, (b, num_tries), dev) * 2 - 1) * yaw_range_rad
    yaws = yaws.to(device=dev, dtype=pcds.dtype)
    c, s = torch.cos(yaws), torch.sin(yaws)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rots = torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], dim=-2)  # (B, T, 3, 3)
    bounds = bounds.to(device=dev, dtype=pcds.dtype)

    ok = torch.ones((b, num_tries), dtype=torch.bool, device=dev)
    for key in bound_keys:  # the gating poses, under every try
        p = poses[key].reshape(b, -1, poses[key].shape[-1])[..., :3]
        rp = torch.einsum("btij,bnj->btni", rots, p)
        ok &= torch.all((rp >= bounds[0]) & (rp <= bounds[1]), dim=-1).all(dim=-1)

    any_ok = ok.any(dim=1)  # (B,)
    first = torch.argmax(ok.to(torch.int8), dim=1)  # the first acceptable try
    rot = rots[torch.arange(b, device=dev), first]  # (B, 3, 3)

    rotated = torch.einsum("bij,bcjhw->bcihw", rot, pcds)
    pcds_out = torch.where(any_ok[:, None, None, None, None], rotated, pcds)
    poses_out = {}
    for key, pose in poses.items():
        rp = _rot_pose(pose.reshape(b, -1, pose.shape[-1]), rot).reshape(pose.shape)
        poses_out[key] = torch.where(any_ok.reshape((b,) + (1,) * (pose.dim() - 1)), rp, pose)
    return pcds_out, poses_out


# ------------------------------------------------------------------- pipeline
def make_device_augment(
    image_rescale: Tuple[float, float] = (0.75, 1.25),
    yaw_range_deg: float = 0.0,
    gripper_loc_bounds=None,
    pose_keys: Tuple[str, ...] = ("curr_gripper", "action", "trajectory"),
):
    """A ``(batch, generator) -> batch`` augmentation for the loss functions'
    ``augment=``; pair it with ``RLBenchDataset(augment_host=False)``.
    ``generator`` (a torch.Generator or ``Generators``) lives on the
    batch's device (module docstring: the order of its draws)."""
    lo, hi = image_rescale
    yaw_rad = math.radians(yaw_range_deg)
    bounds = torch.as_tensor(gripper_loc_bounds if gripper_loc_bounds is not None
                             else [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]], dtype=torch.float32)

    def augment(batch: Dict[str, torch.Tensor], generator):
        batch = dict(batch)
        if yaw_rad > 0.0:
            poses = {k: batch[k] for k in pose_keys if k in batch}
            batch["pcds"], rotated = yaw_rotate_batch(
                generator, batch["pcds"], poses, yaw_range_rad=yaw_rad, bounds=bounds)
            batch.update(rotated)
        if (lo, hi) != (1.0, 1.0):
            b, dev = batch["rgbs"].shape[0], batch["rgbs"].device
            scales = lo + (hi - lo) * draw(generator, torch.rand, (b,), dev)
            crop_u = draw(generator, torch.rand, (b, 2), dev)
            resized = resize_sample({"rgbs": batch["rgbs"], "pcds": batch["pcds"]},
                                    scales, crop_u)
            batch["rgbs"], batch["pcds"] = resized["rgbs"], resized["pcds"]
        return batch

    return augment
