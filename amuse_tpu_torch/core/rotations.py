"""Rotation conversions (axis-angle <-> matrix <-> 6D <-> quaternion) in torch.

Port of ``amuse_tpu/core/rotations.py``. All functions are shape-polymorphic
over leading batch dims and free of data-dependent control flow. The 6D
vector is the first two *rows* of the rotation matrix (pytorch3d /
Zhou et al. 2019 convention).
"""

from __future__ import annotations

import torch

__all__ = [
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "matrix_to_rotation_6d",
    "rotation_6d_to_matrix",
    "axis_angle_to_quaternion",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_rotation_6d",
    "rotation_6d_to_axis_angle",
    "rotation_6d_to_matrix_slabs",
]

_EPS = 1e-8


def _sin_half_over_angle(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    # sin(angle/2)/angle with the Taylor form 0.5 - angle^2/48 near zero
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - angles * angles / 48.0, torch.sin(half) / safe)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) unit quaternion (w, x, y, z)."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angles
    return torch.cat(
        [torch.cos(half), axis_angle * _sin_half_over_angle(angles, half)], dim=-1
    )


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = torch.unbind(quat, dim=-1)
    two_s = 2.0 / (quat * quat).sum(dim=-1)
    m = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (Rodrigues)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) quaternion (w, x, y, z), w >= 0.

    Evaluates all four candidate decompositions and keeps the one with the
    largest denominator. Near ties (and near angle pi) two frameworks may
    round to different but equivalent candidates; compare the matrices.
    """
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    quat_by_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    quat_by_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    quat_by_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    quat_by_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    candidates = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], dim=-2)
    candidates = candidates / (2.0 * torch.clamp(q_abs, min=0.1))[..., None]
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(candidates, -2, index)[..., 0, :]
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3) axis-angle."""
    norms = torch.linalg.vector_norm(quat[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quat[..., :1])
    angles = 2.0 * half_angles
    return quat[..., 1:] / _sin_half_over_angle(angles, half_angles)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle, angle in [0, pi]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two rows of the matrix, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt (Zhou et al. 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=_EPS)
    a2_proj = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.clamp(
        torch.linalg.vector_norm(a2_proj, dim=-1, keepdim=True), min=_EPS
    )
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def rotation_6d_to_matrix_slabs(cols: tuple) -> tuple:
    """Componentwise Gram-Schmidt: 6 same-shape tensors (the 6D components)
    -> 9 tensors, row-major (r00, r01, r02, r10, ..., r22)."""
    x0, x1, x2, x3, x4, x5 = cols
    d1 = torch.clamp(torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2), min=_EPS)
    b10, b11, b12 = x0 / d1, x1 / d1, x2 / d1
    dot = b10 * x3 + b11 * x4 + b12 * x5
    u0, u1, u2 = x3 - dot * b10, x4 - dot * b11, x5 - dot * b12
    d2 = torch.clamp(torch.sqrt(u0 * u0 + u1 * u1 + u2 * u2), min=_EPS)
    b20, b21, b22 = u0 / d2, u1 / d2, u2 / d2
    b30 = b11 * b22 - b12 * b21
    b31 = b12 * b20 - b10 * b22
    b32 = b10 * b21 - b11 * b20
    return (b10, b11, b12, b20, b21, b22, b30, b31, b32)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 6)."""
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3)."""
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))
