"""Host-side (numpy) SO(3) conversion used by the host containers.

Copy of `angle_axis_to_rotation_matrix_np` from the JAX package's
`ops/rotation_np.py` (the only function of that module the port needs so
far: `TwoViewInfo.swap_cameras`). Parity: `ceres::AngleAxisToRotationMatrix`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["angle_axis_to_rotation_matrix_np"]


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
