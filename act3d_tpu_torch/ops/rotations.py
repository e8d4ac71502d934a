"""Rotation math (PyTorch).

Counterpart of ``act3d_tpu/ops/rotations.py``, function for function:
quaternion algebra, axis-angle, Euler angles, the continuous-6D helpers,
the SVD (Kabsch) fit and Gram-Schmidt.  Conventions are the JAX package's:
quaternions are real-first (w, x, y, z) unless a function name says
otherwise (RLBench stores x, y, z, w), rotation matrices act on column
vectors, and the 6D representation is the first two columns of R,
flattened column-major.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import torch

__all__ = [
    "normalise_quat",
    "standardize_quaternion",
    "quat_xyzw_to_wxyz",
    "quat_wxyz_to_xyzw",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "quaternion_raw_multiply",
    "quaternion_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "rotation_matrix_from_ortho6d",
    "ortho6d_from_rotation_matrix",
    "rotation_from_svd",
    "orthonormalize_by_gram_schmidt",
]


def normalise_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalise, clamping the norm away from zero (min 1e-10)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=1e-10)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Force a non-negative real part (q and -q encode the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    """RLBench / action layout (x, y, z, w) -> math layout (w, x, y, z)."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) wxyz quaternions.

    Four candidate quaternions, one per diagonal combination; the
    best-conditioned one (largest |component|) is selected.
    """
    batch_dim = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(batch_dim + (9,)), -1
    )
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp(q_abs[..., None], min=0.1)
    )
    best = torch.argmax(q_abs, dim=-1)
    return torch.gather(
        quat_candidates, -2, best[..., None, None].expand(batch_dim + (1, 4))
    )[..., 0, :]


def _normalize_vector(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mag = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(mag, min=eps)


def rotation_matrix_from_ortho6d(ortho6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): Gram-Schmidt frame with columns (x, y, z)."""
    x = _normalize_vector(ortho6d[..., 0:3])
    z = _normalize_vector(torch.linalg.cross(x, ortho6d[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def ortho6d_from_rotation_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two columns, column-major."""
    return torch.cat([matrix[..., :, 0], matrix[..., :, 1]], dim=-1)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions, sign as it comes."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose rotations (a applied after b), standardized sign."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) wxyz unit quaternions."""
    point_q = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(quaternion, point_q),
                                  quaternion_invert(quaternion))
    return out[..., 1:]


_SMALL_ANGLE = 1e-6


def _sin_half_over_angle(angles: torch.Tensor, half_angles: torch.Tensor) -> torch.Tensor:
    """sin(x / 2) / x, by its Taylor series 1/2 - x^2/48 below 1e-6."""
    small = torch.abs(angles) < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - angles * angles / 48.0, torch.sin(half_angles) / safe)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half_angles = angles * 0.5
    return torch.cat([torch.cos(half_angles),
                      axis_angle * _sin_half_over_angle(angles, half_angles)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(2.0 * half_angles, half_angles)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    flat = {"X": (one, zero, zero, zero, cos, -sin, zero, sin, cos),
            "Y": (cos, zero, sin, zero, one, zero, -sin, zero, cos),
            "Z": (cos, -sin, zero, sin, cos, zero, zero, zero, one)}.get(axis)
    if flat is None:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3) Euler angles -> (..., 3, 3), e.g. convention='XYZ'."""
    _check_convention(convention)
    return reduce(torch.matmul, [_axis_angle_rotation(c, euler_angles[..., i])
                                 for i, c in enumerate(convention)])


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) Euler angles in the given convention."""
    _check_convention(convention)
    i0, i2 = "XYZ".index(convention[0]), "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    return torch.stack([
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    ], dim=-1)


def rotation_from_svd(points1: torch.Tensor, points2: torch.Tensor,
                      center1: Optional[torch.Tensor] = None,
                      center2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Least-squares rotation aligning points2 to points1 (Kabsch): (..., n, 3)
    point sets, optional explicit (..., 3) centres -> (..., 3, 3) proper
    rotations (det +1)."""
    points1 = points1 - (points1.mean(dim=-2, keepdim=True) if center1 is None
                         else center1[..., None, :])
    points2 = points2 - (points2.mean(dim=-2, keepdim=True) if center2 is None
                         else center2[..., None, :])
    u, _, vh = torch.linalg.svd(points2.transpose(-2, -1) @ points1)
    v = vh.transpose(-2, -1)
    neg = torch.linalg.det(v @ u.transpose(-2, -1))[..., None, None] < 0
    v = torch.cat([v[..., :2], torch.where(neg, -v[..., 2:], v[..., 2:])], dim=-1)
    return v @ u.transpose(-2, -1)


def orthonormalize_by_gram_schmidt(matrix: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt over the columns of (..., 3, 3)."""
    a1, a2, a3 = matrix[..., :, 0], matrix[..., :, 1], matrix[..., :, 2]
    b1 = _normalize_vector(a1)
    b2 = _normalize_vector(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = _normalize_vector(a3 - torch.sum(b1 * a3, dim=-1, keepdim=True) * b1
                           - torch.sum(b2 * a3, dim=-1, keepdim=True) * b2)
    return torch.stack([b1, b2, b3], dim=-1)
