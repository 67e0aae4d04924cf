"""Scene metadata: the per-image `CameraIntrinsicsPrior`.

Copy of `CameraIntrinsicsPrior` from the JAX package's `sfm/reconstruction.py`
without `to_intrinsics`, which waits for the camera-intrinsics port. The
`Reconstruction` container itself belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models.intrinsics import CameraIntrinsicsModelType

__all__ = ["CameraIntrinsicsPrior"]


@dataclasses.dataclass
class CameraIntrinsicsPrior:
    """Parity: `theia::CameraIntrinsicsPrior`
    (`sfm/camera_intrinsics_prior.h`) — per-image metadata, each field an
    (is_set, value) prior."""

    image_width: int = 0
    image_height: int = 0
    camera_intrinsics_model_type: CameraIntrinsicsModelType = (
        CameraIntrinsicsModelType.PINHOLE
    )
    focal_length: Optional[float] = None
    principal_point: Optional[tuple[float, float]] = None
    aspect_ratio: Optional[float] = None
    skew: Optional[float] = None
    radial_distortion: tuple[float, ...] = ()
    tangential_distortion: tuple[float, ...] = ()
    position: Optional[np.ndarray] = None
    position_sqrt_information: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    orientation_sqrt_information: Optional[np.ndarray] = None
    gravity: Optional[np.ndarray] = None
    gravity_sqrt_information: Optional[np.ndarray] = None
    latitude: Optional[float] = None
    longitude: Optional[float] = None
    altitude: Optional[float] = None
