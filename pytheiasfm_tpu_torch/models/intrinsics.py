"""Camera intrinsics model types.

Copy of `CameraIntrinsicsModelType` from the JAX package's
`models/intrinsics.py`: the only part of that module `CameraIntrinsicsPrior`
needs. The camera models themselves wait for the intrinsics port.
"""

from __future__ import annotations

import enum

__all__ = ["CameraIntrinsicsModelType"]


class CameraIntrinsicsModelType(enum.IntEnum):
    """Parity: `theia::CameraIntrinsicsModelType`
    (`camera_intrinsics_model_type.h:38-48`)."""

    PINHOLE = 0
    PINHOLE_RADIAL_TANGENTIAL = 1
    FISHEYE = 2
    FOV = 3
    DIVISION_UNDISTORTION = 4
    DOUBLE_SPHERE = 5
    EXTENDED_UNIFIED = 6
    ORTHOGRAPHIC = 7
