"""Rotation math used by the serving path (PyTorch).

Counterpart of ``act3d_tpu/ops/rotations.py`` (normalise_quat,
quaternion_to_matrix, matrix_to_quaternion and the continuous-6D helpers).
Conventions are the JAX package's: quaternions are real-first (w, x, y, z)
in these functions, rotation matrices act on column vectors, and the 6D
representation is the first two columns of R, flattened column-major.
"""

from __future__ import annotations

import torch

__all__ = [
    "normalise_quat",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "rotation_matrix_from_ortho6d",
    "ortho6d_from_rotation_matrix",
]


def normalise_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalise, clamping the norm away from zero (min 1e-10)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=1e-10)


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
