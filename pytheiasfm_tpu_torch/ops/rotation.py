"""SO(3) operations on angle-axis vectors, rotation matrices and quaternions.

Counterpart of the JAX package's `ops/rotation.py` (itself a re-design of
`theia/math/rotation.h:49-82` and the Ceres `AngleAxisRotatePoint` /
`RotationMatrixToAngleAxis` routines). Every function takes tensors with
arbitrary leading batch dimensions and is branchless (`torch.where`), so
the same formulas run on any device and dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "hat",
    "vee",
    "angle_axis_to_rotation_matrix",
    "rotation_matrix_to_angle_axis",
    "angle_axis_rotate_point",
    "angle_axis_to_quaternion",
    "quaternion_to_angle_axis",
    "quaternion_to_rotation_matrix",
    "rotation_matrix_to_quaternion",
    "quaternion_multiply",
    "multiply_rotations",
    "relative_rotation_from_two_rotations",
    "apply_relative_rotation",
    "project_to_so3",
    "align_rotations",
    "align_orientations",
    "so3_log",
    "so3_exp",
]

_SMALL = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x such that hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_theta(aa: torch.Tensor):
    """Return (theta, theta_sq, is_small) with a grad-safe sqrt at 0."""
    theta_sq = torch.sum(aa * aa, dim=-1)
    is_small = theta_sq < _SMALL
    theta = torch.sqrt(torch.where(is_small, torch.ones_like(theta_sq), theta_sq))
    theta = torch.where(is_small, torch.zeros_like(theta), theta)
    return theta, theta_sq, is_small


def _where1(cond, x):
    """x with 1.0 where cond holds (the divide-by-zero guard)."""
    return torch.where(cond, torch.ones_like(x), x)


def angle_axis_to_rotation_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, angle-axis [..,3] -> rotation matrix [..,3,3],
    with 2nd-order Taylor coefficients near theta = 0."""
    theta, theta_sq, is_small = _safe_theta(aa)
    sinc = torch.where(
        is_small, 1.0 - theta_sq / 6.0, torch.sin(theta) / _where1(is_small, theta)
    )
    cosc = torch.where(
        is_small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta)) / _where1(is_small, theta_sq),
    )
    W = hat(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(W.shape)
    return eye + sinc[..., None, None] * W + cosc[..., None, None] * (W @ W)


so3_exp = angle_axis_to_rotation_matrix


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..,3,3] -> unit quaternion [..,4] (w, x, y, z).

    Branchless Shepperd method: all four candidate quaternions, the one with
    the largest pivot selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    one = torch.ones_like(tr)

    qw2 = torch.clamp(one + tr, min=0.0)
    qx2 = torch.clamp(one + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(one - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(one - m00 - m11 + m22, min=0.0)

    sw = torch.sqrt(qw2 + 1e-30)
    sx = torch.sqrt(qx2 + 1e-30)
    sy = torch.sqrt(qy2 + 1e-30)
    sz = torch.sqrt(qz2 + 1e-30)

    cand_w = torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], dim=-1)

    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(pivots, dim=-1)

    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..,4,4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..,4] (w,x,y,z) -> rotation matrix [..,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..,4] -> angle-axis [..,3] (angle in [0, pi])."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1)
    cos_half = q[..., 0]
    angle = 2.0 * torch.atan2(sin_half, cos_half)
    small = sin_half < _SMALL
    scale = torch.where(
        small, torch.full_like(angle, 2.0), angle / _where1(small, sin_half)
    )
    return scale[..., None] * q[..., 1:]


def angle_axis_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis [..,3] -> unit quaternion [..,4] (w,x,y,z)."""
    theta, theta_sq, is_small = _safe_theta(aa)
    half = 0.5 * theta
    k = torch.where(
        is_small, 0.5 - theta_sq / 48.0, torch.sin(half) / _where1(is_small, theta)
    )
    w = torch.cos(half)
    return torch.cat([w[..., None], k[..., None] * aa], dim=-1)


def rotation_matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..,3,3] -> angle-axis [..,3]; robust near 0 and pi."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


so3_log = rotation_matrix_to_angle_axis


def angle_axis_rotate_point(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) p [..,3] by angle-axis aa [..,3] without forming R
    (Ceres `AngleAxisRotatePoint`), first-order near theta = 0."""
    theta, theta_sq, is_small = _safe_theta(aa)
    safe_theta = _where1(is_small, theta)
    axis = aa / safe_theta[..., None]
    cos_t = torch.cos(theta)[..., None]
    sin_t = torch.sin(theta)[..., None]
    axis, p_b = torch.broadcast_tensors(axis, p)
    w_cross_p = torch.linalg.cross(axis, p_b, dim=-1)
    w_dot_p = torch.sum(axis * p_b, dim=-1, keepdim=True)
    rotated = p_b * cos_t + w_cross_p * sin_t + axis * w_dot_p * (1.0 - cos_t)
    aa_b, _ = torch.broadcast_tensors(aa, p_b)
    approx = p_b + torch.linalg.cross(aa_b, p_b, dim=-1)
    return torch.where(is_small[..., None], approx, rotated)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..,4] (w,x,y,z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def multiply_rotations(aa1: torch.Tensor, aa2: torch.Tensor) -> torch.Tensor:
    """Angle-axis of R(aa1) @ R(aa2). Parity: `theia::MultiplyRotations`
    (`math/rotation.h:75`), composed in quaternion space."""
    q = quaternion_multiply(
        angle_axis_to_quaternion(aa1), angle_axis_to_quaternion(aa2)
    )
    return quaternion_to_angle_axis(q)


def relative_rotation_from_two_rotations(
    aa1: torch.Tensor, aa2: torch.Tensor, noise_quat: torch.Tensor | None = None
) -> torch.Tensor:
    """Angle-axis of R2 @ R1^T. Parity:
    `theia::RelativeRotationFromTwoRotations` (`math/rotation.h:59`)."""
    q1 = angle_axis_to_quaternion(aa1)
    q2 = angle_axis_to_quaternion(aa2)
    conj = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q1.dtype, device=q1.device)
    q = quaternion_multiply(q2, q1 * conj)
    if noise_quat is not None:
        q = quaternion_multiply(noise_quat, q)
    return quaternion_to_angle_axis(q)


def apply_relative_rotation(aa1: torch.Tensor, aa_rel: torch.Tensor) -> torch.Tensor:
    """Angle-axis of R_rel @ R1. Parity: `theia::ApplyRelativeRotation`."""
    return multiply_rotations(aa_rel, aa1)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Closest rotation to [..,3,3] in Frobenius norm, via SVD with a
    determinant sign correction. Parity: `theia::ProjectToSOd`
    (`math/rotation.h:49`)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def align_rotations(gt_aa: torch.Tensor, est_aa: torch.Tensor) -> torch.Tensor:
    """Estimated rotations R_est_i @ R_align, with R_align the chordal
    least-squares alignment to the ground truth over the leading axis.
    Parity: `theia::AlignRotations` (`math/rotation.h:66`)."""
    R_gt = angle_axis_to_rotation_matrix(gt_aa)
    R_est = angle_axis_to_rotation_matrix(est_aa)
    C = torch.sum(R_est.mT @ R_gt, dim=0)
    R_align = project_to_so3(C)
    return rotation_matrix_to_angle_axis(R_est @ R_align)


def align_orientations(gt_aa: torch.Tensor, est_aa: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`align_rotations`. Parity: `theia::AlignOrientations`
    (`math/rotation.h:72`)."""
    return align_rotations(gt_aa, est_aa)
