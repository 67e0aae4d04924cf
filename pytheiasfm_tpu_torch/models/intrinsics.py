"""Camera intrinsics models as batched pure functions on tensors.

Counterpart of the JAX package's `models/intrinsics.py` (the reference's
`camera_intrinsics_model.h:83` hierarchy). A model is a pair of functions

    camera_to_pixel(params, point3)  -> pixel2       (project + distort)
    pixel_to_camera(params, pixel2)  -> ray3          (undistort + unproject)

over arbitrary leading batch dimensions. The parameter vectors use the
reference's per-model layouts, padded to ``MAX_INTRINSICS``, so a scene's
intrinsics live in one `[G, MAX_INTRINSICS]` array.

Only PINHOLE (`pinhole_camera_model.h:86-260`) is ported: it is the model of
the synthetic global-SfM scene. The other seven models raise
`NotImplementedError` (ROADMAP item A1b).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "CameraIntrinsicsModelType",
    "OptimizeIntrinsicsType",
    "MAX_INTRINSICS",
    "NUM_INTRINSICS",
    "camera_to_pixel",
    "pixel_to_camera",
    "make_intrinsics_np",
    "intrinsics_subset_mask",
    "focal_length",
    "principal_point",
]

MAX_INTRINSICS = 10
_UNDISTORT_ITERS = 50


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


class OptimizeIntrinsicsType(enum.IntFlag):
    """Parity: `theia::OptimizeIntrinsicsType` bitmask
    (`bundle_adjustment.h:71-84`)."""

    NONE = 0x00
    FOCAL_LENGTH = 0x01
    ASPECT_RATIO = 0x02
    SKEW = 0x04
    PRINCIPAL_POINTS = 0x08
    RADIAL_DISTORTION = 0x10
    TANGENTIAL_DISTORTION = 0x20
    DISTORTION = RADIAL_DISTORTION | TANGENTIAL_DISTORTION
    FOCAL_LENGTH_RADIAL_DISTORTION = FOCAL_LENGTH | RADIAL_DISTORTION
    ALL = (
        FOCAL_LENGTH
        | ASPECT_RATIO
        | SKEW
        | PRINCIPAL_POINTS
        | RADIAL_DISTORTION
        | TANGENTIAL_DISTORTION
    )


# Number of meaningful parameters of each ported model (reference
# kIntrinsicsSize).
NUM_INTRINSICS = {CameraIntrinsicsModelType.PINHOLE: 7}

# PINHOLE: [f, aspect, skew, ppx, ppy, k1, k2].
_PP_INDEX = 3


def _pinhole_only(model) -> None:
    model = CameraIntrinsicsModelType(model)
    if model != CameraIntrinsicsModelType.PINHOLE:
        raise NotImplementedError(
            f"camera model {model.name} is not ported yet (ROADMAP item A1b); "
            "only PINHOLE is"
        )


# Parameter slots each `OptimizeIntrinsicsType` bit frees, per model
# (the JAX package's `_SUBSET_SLOTS`).
_SUBSET_SLOTS = {
    CameraIntrinsicsModelType.PINHOLE: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6),
    },
}


def intrinsics_subset_mask(model: CameraIntrinsicsModelType, flags) -> np.ndarray:
    """Boolean [MAX_INTRINSICS] mask of the parameters freed by `flags` for
    this model (parity: GetSubsetFromOptimizeIntrinsicsType, inverted: the
    reference returns the constant set)."""
    _pinhole_only(model)
    mask = np.zeros((MAX_INTRINSICS,), bool)
    for bit, slots in _SUBSET_SLOTS[CameraIntrinsicsModelType(model)].items():
        if flags & bit:
            mask[list(slots)] = True
    return mask


def make_intrinsics_np(
    model: CameraIntrinsicsModelType,
    focal_length: float = 1.0,
    aspect_ratio: float = 1.0,
    skew: float = 0.0,
    principal_point=(0.0, 0.0),
    distortion=(),
    dtype=None,
) -> np.ndarray:
    """The padded parameter vector in the model's layout, in numpy (host
    containers build intrinsics rows without touching a device)."""
    _pinhole_only(model)
    p = np.zeros((MAX_INTRINSICS,), dtype or np.float64)
    p[0], p[1], p[2] = focal_length, aspect_ratio, skew
    p[_PP_INDEX], p[_PP_INDEX + 1] = principal_point[0], principal_point[1]
    for i, d in enumerate(distortion):
        if _PP_INDEX + 2 + i < MAX_INTRINSICS:
            p[_PP_INDEX + 2 + i] = d
    return p


def focal_length(params: torch.Tensor) -> torch.Tensor:
    return params[..., 0]


def principal_point(params: torch.Tensor, model: CameraIntrinsicsModelType) -> torch.Tensor:
    _pinhole_only(model)
    return params[..., _PP_INDEX : _PP_INDEX + 2]


def _apply_calibration(params, pt2):
    f = params[..., 0]
    fy = f * params[..., 1]
    px = f * pt2[..., 0] + params[..., 2] * pt2[..., 1] + params[..., _PP_INDEX]
    py = fy * pt2[..., 1] + params[..., _PP_INDEX + 1]
    return torch.stack([px, py], dim=-1)


def _remove_calibration(params, pixel):
    f = params[..., 0]
    fy = f * params[..., 1]
    y = (pixel[..., 1] - params[..., _PP_INDEX + 1]) / fy
    x = (pixel[..., 0] - params[..., _PP_INDEX] - y * params[..., 2]) / f
    return torch.stack([x, y], dim=-1)


def _radial_divisor(params, pt2):
    k1, k2 = params[..., 5], params[..., 6]
    r_sq = torch.sum(pt2 * pt2, dim=-1)
    return 1.0 + r_sq * (k1 + k2 * r_sq)


def pinhole_distort(params, pt2):
    return pt2 * _radial_divisor(params, pt2)[..., None]


def pinhole_undistort(params, pt2):
    """Fixed-point undistortion u <- d / divisor(u), a fixed 50 steps with a
    per-point freeze once a step moves it by at most 1e-12 (the reference's
    `UndistortPoint` loop with its convergence test)."""
    u = pt2
    for _ in range(_UNDISTORT_ITERS):
        new = pt2 / _radial_divisor(params, u)[..., None]
        delta = torch.amax(torch.abs(new - u), dim=-1, keepdim=True)
        u = torch.where(delta > 1e-12, new, u)
    return u


def pinhole_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, pinhole_distort(params, norm))


def pinhole_pixel_to_camera(params, pixel):
    pt2 = pinhole_undistort(params, _remove_calibration(params, pixel))
    return torch.cat([pt2, torch.ones_like(pt2[..., :1])], dim=-1)


def camera_to_pixel(params: torch.Tensor, point3: torch.Tensor, model) -> torch.Tensor:
    """Project a camera-frame 3D point to a pixel. Parity:
    `CameraIntrinsicsModel::CameraToPixelCoordinates`
    (`camera_intrinsics_model.h:124`)."""
    _pinhole_only(model)
    return pinhole_camera_to_pixel(params, point3)


def pixel_to_camera(params: torch.Tensor, pixel: torch.Tensor, model) -> torch.Tensor:
    """Unproject a pixel to a camera-frame ray on the z = 1 plane. Parity:
    `CameraIntrinsicsModel::PixelToCameraCoordinates`
    (`camera_intrinsics_model.h:133`)."""
    _pinhole_only(model)
    return pinhole_pixel_to_camera(params, pixel)
