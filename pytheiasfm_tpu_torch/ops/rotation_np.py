"""Host-side (numpy) SO(3) conversions for per-item host loops.

Counterpart of the JAX package's `ops/rotation_np.py`: numpy versions of the
rotation conversions for host-side graph walks (the maximum-spanning-tree
orientation chain) and container plumbing, where a tensor call per item
would cost a dispatch each. They accept a single [3]/[3,3] item or a
leading batch axis. Parity: `ceres::AngleAxisToRotationMatrix` /
`RotationMatrixToAngleAxis`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "angle_axis_to_rotation_matrix_np",
    "rotation_matrix_to_angle_axis_np",
    "angle_axis_rotate_point_np",
]


def angle_axis_to_rotation_matrix_np(aa) -> np.ndarray:
    """Rodrigues: angle-axis [..., 3] -> rotation matrix [..., 3, 3]."""
    aa = np.asarray(aa, np.float64)
    batched = aa.ndim > 1
    a = aa.reshape(-1, 3)
    theta = np.linalg.norm(a, axis=-1)
    out = np.zeros((len(a), 3, 3))
    small = theta < 1e-12
    # Small-angle: I + [w]_x.
    for idx in np.nonzero(small)[0]:
        wx, wy, wz = a[idx]
        out[idx] = np.eye(3) + np.array(
            [[0, -wz, wy], [wz, 0, -wx], [-wy, wx, 0]]
        )
    big = ~small
    if big.any():
        t = theta[big][:, None]
        k = a[big] / t
        K = np.zeros((big.sum(), 3, 3))
        K[:, 0, 1] = -k[:, 2]
        K[:, 0, 2] = k[:, 1]
        K[:, 1, 0] = k[:, 2]
        K[:, 1, 2] = -k[:, 0]
        K[:, 2, 0] = -k[:, 1]
        K[:, 2, 1] = k[:, 0]
        c = np.cos(theta[big])[:, None, None]
        s = np.sin(theta[big])[:, None, None]
        out[big] = np.eye(3) + s * K + (1 - c) * (K @ K)
    return out if batched else out[0]


def rotation_matrix_to_angle_axis_np(R) -> np.ndarray:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3] (log map)."""
    R = np.asarray(R, np.float64)
    batched = R.ndim > 2
    Rb = R.reshape(-1, 3, 3)
    w = np.stack(
        [
            Rb[:, 2, 1] - Rb[:, 1, 2],
            Rb[:, 0, 2] - Rb[:, 2, 0],
            Rb[:, 1, 0] - Rb[:, 0, 1],
        ],
        -1,
    )
    cos_t = np.clip((np.trace(Rb, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    sin_t = np.clip(np.linalg.norm(w, axis=-1) / 2.0, 0.0, 1.0)
    theta = np.arctan2(sin_t, cos_t)
    out = np.zeros((len(Rb), 3))
    regular = sin_t > 1e-7
    out[regular] = (
        w[regular] / (2.0 * sin_t[regular][:, None]) * theta[regular][:, None]
    )
    near_pi = (~regular) & (cos_t < 0)
    for idx in np.nonzero(near_pi)[0]:
        # theta ~ pi: axis from the largest diagonal of (R + I) / 2.
        A = (Rb[idx] + np.eye(3)) / 2.0
        k = int(np.argmax(np.diag(A)))
        axis = A[:, k] / max(np.sqrt(max(A[k, k], 1e-12)), 1e-12)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        # Disambiguate sign with the skew part.
        if np.dot(axis, w[idx]) < 0:
            axis = -axis
        out[idx] = axis * theta[idx]
    # Remaining: theta ~ 0 -> w/2 first-order.
    rest = (~regular) & (cos_t >= 0)
    out[rest] = w[rest] / 2.0
    return out if batched else out[0]


def angle_axis_rotate_point_np(aa, pts) -> np.ndarray:
    """Rotate pts [..., 3] by angle-axis aa [..., 3] (host Rodrigues)."""
    aa = np.asarray(aa, np.float64)
    pts = np.asarray(pts, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = aa / safe
    c = np.cos(theta)
    s = np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=-1, keepdims=True)
    out = pts * c + kxp * s + k * kdp * (1.0 - c)
    return np.where(theta < 1e-12, pts, out)
