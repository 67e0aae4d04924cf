"""The eight camera intrinsics models as batched pure functions on tensors.

Counterpart of the JAX package's `models/intrinsics.py` (the reference's
`camera_intrinsics_model.h:83` hierarchy and its eight `*_camera_model.h`
subclasses). A model is a pair of functions

    camera_to_pixel(params, point3)  -> pixel2       (project + distort)
    pixel_to_camera(params, pixel2)  -> ray3          (undistort + unproject)

over arbitrary leading batch dimensions, differentiable by autograd and
`torch.autograd.forward_ad`. The parameter vectors use the reference's
per-model layouts, padded to ``MAX_INTRINSICS``, so a scene's intrinsics
live in one `[G, MAX_INTRINSICS]` array.

Distortion formulas (the JAX module's, term for term):
  PINHOLE                    pinhole_camera_model.h:86-260
  PINHOLE_RADIAL_TANGENTIAL  pinhole_radial_tangential_camera_model.h:84-
  FISHEYE                    fisheye_camera_model.h:67- (Kannala-Brandt)
  FOV                        fov_camera_model.h:69- (Devernay-Faugeras)
  DIVISION_UNDISTORTION      division_undistortion_camera_model.h:76-
  DOUBLE_SPHERE              double_sphere_camera_model.h:66-
  EXTENDED_UNIFIED           extended_unified_camera_model.h:66-
  ORTHOGRAPHIC               orthographic_camera_model.h:66-

The fixed-point undistortions run the JAX module's fixed 50 steps with its
per-point freeze (a step that moves a point by at most 1e-12 is not taken),
not a loop until converged, so both packages take the same steps.
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np
import torch

__all__ = [
    "CameraIntrinsicsModelType",
    "OptimizeIntrinsicsType",
    "MAX_INTRINSICS",
    "NUM_INTRINSICS",
    "camera_to_pixel",
    "pixel_to_camera",
    "default_intrinsics",
    "make_intrinsics",
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


M = CameraIntrinsicsModelType

# Number of meaningful parameters per model (reference kIntrinsicsSize).
NUM_INTRINSICS = {
    M.PINHOLE: 7,
    M.PINHOLE_RADIAL_TANGENTIAL: 10,
    M.FISHEYE: 9,
    M.FOV: 5,
    M.DIVISION_UNDISTORTION: 5,
    M.DOUBLE_SPHERE: 7,
    M.EXTENDED_UNIFIED: 7,
    M.ORTHOGRAPHIC: 7,
}

# The slot of the principal point's x for each model. Every model puts the
# focal length at 0 and the aspect ratio at 1; FOV and
# DIVISION_UNDISTORTION have no skew, so their principal point starts at 2.
_PP_INDEX = {m: 2 if m in (M.FOV, M.DIVISION_UNDISTORTION) else 3 for m in M}
_HAS_SKEW = {m: m not in (M.FOV, M.DIVISION_UNDISTORTION) for m in M}


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


OI = OptimizeIntrinsicsType

# Parameter slots each `OptimizeIntrinsicsType` bit frees, per model (the
# reference's per-model GetSubsetFromOptimizeIntrinsicsType, e.g.
# `pinhole_camera_model.cc:132-162`; the double-sphere and unified models'
# xi / alpha / beta count as RADIAL_DISTORTION there).
_SKEWED_BASE = {OI.FOCAL_LENGTH: (0,), OI.ASPECT_RATIO: (1,), OI.SKEW: (2,),
                OI.PRINCIPAL_POINTS: (3, 4)}
_UNSKEWED = {OI.FOCAL_LENGTH: (0,), OI.ASPECT_RATIO: (1,), OI.PRINCIPAL_POINTS: (2, 3),
             OI.RADIAL_DISTORTION: (4,)}
_SUBSET_SLOTS = {
    M.PINHOLE: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6)},
    M.PINHOLE_RADIAL_TANGENTIAL: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6, 7),
                                  OI.TANGENTIAL_DISTORTION: (8, 9)},
    M.FISHEYE: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6, 7, 8)},
    M.FOV: _UNSKEWED,
    M.DIVISION_UNDISTORTION: _UNSKEWED,
    M.DOUBLE_SPHERE: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6)},
    M.EXTENDED_UNIFIED: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6)},
    M.ORTHOGRAPHIC: {**_SKEWED_BASE, OI.RADIAL_DISTORTION: (5, 6)},
}


def intrinsics_subset_mask(model: CameraIntrinsicsModelType, flags) -> np.ndarray:
    """Boolean [MAX_INTRINSICS] mask of the parameters freed by `flags` for
    this model (parity: GetSubsetFromOptimizeIntrinsicsType, inverted: the
    reference returns the constant set)."""
    mask = np.zeros((MAX_INTRINSICS,), bool)
    for bit, slots in _SUBSET_SLOTS[M(model)].items():
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
    containers build intrinsics rows without touching a device). Focal
    length 1, aspect 1 and every other slot 0 unless given; EXTENDED_UNIFIED
    defaults beta to 1 (alpha 0, so it projects as a pinhole). Distortion
    past the last slot is dropped."""
    model = M(model)
    p = np.zeros((MAX_INTRINSICS,), dtype or np.float64)
    p[0], p[1] = focal_length, aspect_ratio
    if model == M.EXTENDED_UNIFIED:
        p[6] = 1.0
    pp = _PP_INDEX[model]
    if _HAS_SKEW[model]:
        p[2] = skew
    p[pp], p[pp + 1] = principal_point[0], principal_point[1]
    for i, d in enumerate(distortion):
        if pp + 2 + i < MAX_INTRINSICS:
            p[pp + 2 + i] = d
    return p


def default_intrinsics(model: CameraIntrinsicsModelType, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """The padded default parameter vector (focal 1, aspect 1, everything
    else 0; EXTENDED_UNIFIED's beta 1)."""
    return torch.as_tensor(make_intrinsics_np(model), dtype=dtype, device=device)


def make_intrinsics(
    model: CameraIntrinsicsModelType,
    focal_length: float = 1.0,
    aspect_ratio: float = 1.0,
    skew: float = 0.0,
    principal_point=(0.0, 0.0),
    distortion=(),
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """The padded parameter vector in the reference's per-model layout, as a
    tensor."""
    p = make_intrinsics_np(model, focal_length, aspect_ratio, skew, principal_point,
                           distortion)
    return torch.as_tensor(p, dtype=dtype, device=device)


def focal_length(params: torch.Tensor) -> torch.Tensor:
    return params[..., 0]


def principal_point(params: torch.Tensor, model: CameraIntrinsicsModelType) -> torch.Tensor:
    pp = _PP_INDEX[M(model)]
    return params[..., pp : pp + 2]


# ---------------------------------------------------------------------------
# Shared K / K^-1 application.
# ---------------------------------------------------------------------------


def _apply_calibration(params, pt2, pp_idx, has_skew):
    f = params[..., 0]
    fy = f * params[..., 1]
    skew = params[..., 2] if has_skew else torch.zeros_like(f)
    px = f * pt2[..., 0] + skew * pt2[..., 1] + params[..., pp_idx]
    py = fy * pt2[..., 1] + params[..., pp_idx + 1]
    return torch.stack([px, py], dim=-1)


def _remove_calibration(params, pixel, pp_idx, has_skew):
    f = params[..., 0]
    fy = f * params[..., 1]
    skew = params[..., 2] if has_skew else torch.zeros_like(f)
    y = (pixel[..., 1] - params[..., pp_idx + 1]) / fy
    x = (pixel[..., 0] - params[..., pp_idx] - y * skew) / f
    return torch.stack([x, y], dim=-1)


def _unit_plane(pt2):
    return torch.cat([pt2, torch.ones_like(pt2[..., :1])], dim=-1)


def _freeze(new, u):
    """The fixed-point step's freeze: keep `u` where the step moves it by at
    most 1e-12 in every coordinate."""
    delta = torch.amax(torch.abs(new - u), dim=-1, keepdim=True)
    return torch.where(delta > 1e-12, new, u)


def _fixed_point_undistort(distorted, divisor_fn):
    """u <- distorted / divisor(u), a fixed `_UNDISTORT_ITERS` steps with the
    freeze (the reference's `UndistortPoint` loops with their convergence
    test)."""
    u = distorted
    for _ in range(_UNDISTORT_ITERS):
        u = _freeze(distorted / divisor_fn(u)[..., None], u)
    return u


# ---------------------------------------------------------------------------
# PINHOLE: [f, aspect, skew, ppx, ppy, k1, k2].
# ---------------------------------------------------------------------------


def _radial_divisor(params, u):
    k1, k2 = params[..., 5], params[..., 6]
    r_sq = torch.sum(u * u, dim=-1)
    return 1.0 + r_sq * (k1 + k2 * r_sq)


def pinhole_distort(params, pt2):
    return pt2 * _radial_divisor(params, pt2)[..., None]


def pinhole_undistort(params, pt2):
    return _fixed_point_undistort(pt2, lambda u: _radial_divisor(params, u))


def pinhole_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, pinhole_distort(params, norm), 3, True)


def pinhole_pixel_to_camera(params, pixel):
    return _unit_plane(pinhole_undistort(params, _remove_calibration(params, pixel, 3, True)))


# ---------------------------------------------------------------------------
# PINHOLE_RADIAL_TANGENTIAL: [f, aspect, skew, ppx, ppy, k1, k2, k3, t1, t2].
# ---------------------------------------------------------------------------


def _radial_tangential_terms(params, u):
    """(radial factor, tangential x, tangential y) at undistorted `u`."""
    k1, k2, k3 = params[..., 5], params[..., 6], params[..., 7]
    t1, t2 = params[..., 8], params[..., 9]
    x, y = u[..., 0], u[..., 1]
    r_sq = x * x + y * y
    rd = 1.0 + k1 * r_sq + k2 * r_sq * r_sq + k3 * r_sq * r_sq * r_sq
    tx = t2 * (r_sq + 2.0 * x * x) + 2.0 * t1 * x * y
    ty = t1 * (r_sq + 2.0 * y * y) + 2.0 * t2 * x * y
    return rd, tx, ty


def pinhole_radial_tangential_distort(params, pt2):
    rd, tx, ty = _radial_tangential_terms(params, pt2)
    return torch.stack([pt2[..., 0] * rd + tx, pt2[..., 1] * rd + ty], dim=-1)


def pinhole_radial_tangential_undistort(params, pt2):
    """Fixed point on the whole map: subtract the tangential term, divide by
    the radial one."""
    u = pt2
    for _ in range(_UNDISTORT_ITERS):
        rd, tx, ty = _radial_tangential_terms(params, u)
        new = torch.stack([(pt2[..., 0] - tx) / rd, (pt2[..., 1] - ty) / rd], dim=-1)
        u = _freeze(new, u)
    return u


def pinhole_radial_tangential_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, pinhole_radial_tangential_distort(params, norm), 3, True)


def pinhole_radial_tangential_pixel_to_camera(params, pixel):
    return _unit_plane(pinhole_radial_tangential_undistort(
        params, _remove_calibration(params, pixel, 3, True)))


# ---------------------------------------------------------------------------
# FISHEYE (Kannala-Brandt): [f, aspect, skew, ppx, ppy, k1, k2, k3, k4].
# The distortion acts on the 3-D point: theta = atan2(r, |z|).
# ---------------------------------------------------------------------------


def _fisheye_theta_d(params, theta):
    k1, k2, k3, k4 = params[..., 5], params[..., 6], params[..., 7], params[..., 8]
    th2 = theta * theta
    return theta * (
        1.0 + k1 * th2 + k2 * th2 * th2 + k3 * th2 * th2 * th2 + k4 * th2 * th2 * th2 * th2
    )


def fisheye_distort3(params, point3):
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r_sq = x * x + y * y
    near_center = r_sq < 1e-8
    r = torch.sqrt(torch.where(near_center, torch.ones_like(r_sq), r_sq))
    theta = torch.atan2(r, torch.abs(z))
    scale = torch.where(near_center, torch.ones_like(r), _fisheye_theta_d(params, theta) / r)
    sign = torch.where(z < 0.0, -torch.ones_like(z), torch.ones_like(z))
    out = torch.stack([scale * x, scale * y], dim=-1) * sign[..., None]
    # Near the centre: no distortion, the input x, y (z positive assumed).
    return torch.where(near_center[..., None], point3[..., :2], out)


def fisheye_undistort(params, pt2):
    """A distorted normalized point to the unit plane: fixed point on
    theta_d / r (no freeze; points within 1e-8 of the centre stay)."""
    u = pt2
    for _ in range(_UNDISTORT_ITERS):
        r_sq = torch.sum(u * u, dim=-1)
        near = r_sq < 1e-16
        r = torch.sqrt(torch.where(near, torch.ones_like(r_sq), r_sq))
        theta = torch.atan2(r, torch.ones_like(r))
        new = pt2 * (r / _fisheye_theta_d(params, theta))[..., None]
        u = torch.where(near[..., None], u, new)
    return u


def fisheye_camera_to_pixel(params, point3):
    return _apply_calibration(params, fisheye_distort3(params, point3), 3, True)


def fisheye_pixel_to_camera(params, pixel):
    return _unit_plane(fisheye_undistort(params, _remove_calibration(params, pixel, 3, True)))


# ---------------------------------------------------------------------------
# FOV (Devernay-Faugeras): [f, aspect, ppx, ppy, omega]. No skew.
# ---------------------------------------------------------------------------


def fov_distort(params, pt2):
    omega = params[..., 4]
    r_u_sq = torch.sum(pt2 * pt2, dim=-1)
    small_omega = omega < 1e-3
    small_r = r_u_sq < 1e-3
    # Taylor in omega (the reference cites COLMAP's derivation).
    rd_small_omega = (omega * omega * r_u_sq) / 3.0 - omega * omega / 12.0 + 1.0
    safe_omega = torch.where(small_omega, torch.ones_like(omega), omega)
    tan_half = torch.tan(safe_omega / 2.0)
    rd_small_r = (-2.0 * tan_half * (4.0 * r_u_sq * tan_half * tan_half - 3.0)) / (
        3.0 * safe_omega)
    r_u = torch.sqrt(torch.where(small_r, torch.ones_like(r_u_sq), r_u_sq))
    rd_general = torch.atan(2.0 * r_u * tan_half) / (r_u * safe_omega)
    r_d = torch.where(small_omega, rd_small_omega,
                      torch.where(small_r, rd_small_r, rd_general))
    return pt2 * r_d[..., None]


def fov_undistort(params, pt2):
    omega = params[..., 4]
    r_d_sq = torch.sum(pt2 * pt2, dim=-1)
    small_omega = omega < 1e-3
    small_r = r_d_sq < 1e-3
    ru_small_omega = (omega * omega * r_d_sq) / 3.0 - omega * omega / 12.0 + 1.0
    safe_omega = torch.where(small_omega, torch.ones_like(omega), omega)
    tan_half = torch.tan(safe_omega / 2.0)
    ru_small_r = (safe_omega * (safe_omega * safe_omega * r_d_sq + 3.0)) / (6.0 * tan_half)
    r_d = torch.sqrt(torch.where(small_r, torch.ones_like(r_d_sq), r_d_sq))
    ru_general = torch.tan(r_d * safe_omega) / (2.0 * r_d * tan_half)
    r_u = torch.where(small_omega, ru_small_omega,
                      torch.where(small_r, ru_small_r, ru_general))
    return pt2 * r_u[..., None]


def fov_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, fov_distort(params, norm), 2, False)


def fov_pixel_to_camera(params, pixel):
    return _unit_plane(fov_undistort(params, _remove_calibration(params, pixel, 2, False)))


# ---------------------------------------------------------------------------
# DIVISION_UNDISTORTION: [f, aspect, ppx, ppy, k]. The distortion is in
# pixel units about the principal point.
# ---------------------------------------------------------------------------


def division_distort(params, pt2):
    """`pt2`: an undistorted pixel-scale point centred at the principal
    point."""
    k = params[..., 4]
    r_u_sq = torch.sum(pt2 * pt2, dim=-1)
    denom = 2.0 * k * r_u_sq
    inner = 1.0 - 4.0 * k * r_u_sq
    degenerate = (torch.abs(denom) < 1e-15) | (inner < 0.0)
    scale = (1.0 - torch.sqrt(torch.clamp(inner, min=0.0))) / torch.where(
        degenerate, torch.ones_like(denom), denom)
    return torch.where(degenerate[..., None], pt2, pt2 * scale[..., None])


def division_undistort(params, pt2):
    k = params[..., 4]
    r_d_sq = torch.sum(pt2 * pt2, dim=-1)
    return pt2 / (1.0 + k * r_d_sq)[..., None]


def division_camera_to_pixel(params, point3):
    f = params[..., 0]
    fy = f * params[..., 1]
    norm = point3[..., :2] / point3[..., 2:3]
    undist_px = torch.stack([f * norm[..., 0], fy * norm[..., 1]], dim=-1)
    return division_distort(params, undist_px) + params[..., 2:4]


def division_pixel_to_camera(params, pixel):
    f = params[..., 0]
    fy = f * params[..., 1]
    undist = division_undistort(params, pixel - params[..., 2:4])
    return _unit_plane(torch.stack([undist[..., 0] / f, undist[..., 1] / fy], dim=-1))


# ---------------------------------------------------------------------------
# DOUBLE_SPHERE: [f, aspect, skew, ppx, ppy, xi, alpha].
# ---------------------------------------------------------------------------


def double_sphere_distort3(params, point3):
    xi, alpha = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r2 = x * x + y * y
    d1 = torch.sqrt(r2 + z * z)
    k = xi * d1 + z
    d2 = torch.sqrt(r2 + k * k)
    norm = alpha * d2 + (1.0 - alpha) * k
    safe = torch.abs(norm) > 1e-12
    inv = torch.where(safe, 1.0 / torch.where(safe, norm, torch.ones_like(norm)),
                      torch.zeros_like(norm))
    return torch.stack([x * inv, y * inv], dim=-1)


def double_sphere_valid3(params, point3):
    """Projection validity: the point lies inside the model's field of view
    (the projection functions do not apply it)."""
    xi, alpha = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    d1 = torch.sqrt(x * x + y * y + z * z)
    w1 = torch.where(alpha > 0.5, (1.0 - alpha) / torch.clamp(alpha, min=1e-12),
                     alpha / torch.clamp(1.0 - alpha, min=1e-12))
    w2 = (w1 + xi) / torch.sqrt(torch.clamp(2.0 * w1 * xi + xi * xi + 1.0, min=1e-12))
    return z > -w2 * d1


def double_sphere_undistort(params, pt2):
    xi, alpha = params[..., 5], params[..., 6]
    r2 = torch.sum(pt2 * pt2, dim=-1)
    sqrt2 = torch.sqrt(torch.clamp(1.0 - (2.0 * alpha - 1.0) * r2, min=0.0))
    norm2 = alpha * sqrt2 + 1.0 - alpha
    mz = (1.0 - alpha * alpha * r2) / norm2
    mz2 = mz * mz
    norm1 = mz2 + r2
    sqrt1 = torch.sqrt(torch.clamp(mz2 + (1.0 - xi * xi) * r2, min=0.0))
    k = (mz * xi + sqrt1) / torch.clamp(norm1, min=1e-12)
    return torch.stack([k * pt2[..., 0], k * pt2[..., 1], k * mz - xi], dim=-1)


def double_sphere_camera_to_pixel(params, point3):
    return _apply_calibration(params, double_sphere_distort3(params, point3), 3, True)


def double_sphere_pixel_to_camera(params, pixel):
    return double_sphere_undistort(params, _remove_calibration(params, pixel, 3, True))


# ---------------------------------------------------------------------------
# EXTENDED_UNIFIED: [f, aspect, skew, ppx, ppy, alpha, beta].
# ---------------------------------------------------------------------------


def extended_unified_distort3(params, point3):
    alpha, beta = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r2 = x * x + y * y
    rho = torch.sqrt(torch.clamp(beta * r2 + z * z, min=0.0))
    norm = alpha * rho + (1.0 - alpha) * z
    invalid = norm < 1e-3
    inv = torch.where(invalid, torch.zeros_like(norm),
                      1.0 / torch.where(invalid, torch.ones_like(norm), norm))
    return torch.stack([x * inv, y * inv], dim=-1)


def extended_unified_undistort(params, pt2):
    alpha, beta = params[..., 5], params[..., 6]
    r2 = torch.sum(pt2 * pt2, dim=-1)
    gamma = 1.0 - alpha
    tmp1 = 1.0 - alpha * alpha * beta * r2
    tmp_sqrt = torch.sqrt(torch.clamp(1.0 - (alpha - gamma) * beta * r2, min=0.0))
    tmp2 = alpha * tmp_sqrt + gamma
    k = tmp1 / tmp2
    norm = torch.clamp(torch.sqrt(r2 + k * k), min=1e-12)
    return torch.stack([pt2[..., 0] / norm, pt2[..., 1] / norm, k / norm], dim=-1)


def extended_unified_camera_to_pixel(params, point3):
    return _apply_calibration(params, extended_unified_distort3(params, point3), 3, True)


def extended_unified_pixel_to_camera(params, pixel):
    return extended_unified_undistort(params, _remove_calibration(params, pixel, 3, True))


# ---------------------------------------------------------------------------
# ORTHOGRAPHIC: [f, aspect, skew, ppx, ppy, k1, k2]. Projects (x, y) with no
# division by depth (a telecentric lens).
# ---------------------------------------------------------------------------


def orthographic_camera_to_pixel(params, point3):
    return _apply_calibration(params, pinhole_distort(params, point3[..., :2]), 3, True)


def orthographic_pixel_to_camera(params, pixel):
    return _unit_plane(pinhole_undistort(params, _remove_calibration(params, pixel, 3, True)))


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------

_CAMERA_TO_PIXEL: dict[CameraIntrinsicsModelType, Callable] = {
    M.PINHOLE: pinhole_camera_to_pixel,
    M.PINHOLE_RADIAL_TANGENTIAL: pinhole_radial_tangential_camera_to_pixel,
    M.FISHEYE: fisheye_camera_to_pixel,
    M.FOV: fov_camera_to_pixel,
    M.DIVISION_UNDISTORTION: division_camera_to_pixel,
    M.DOUBLE_SPHERE: double_sphere_camera_to_pixel,
    M.EXTENDED_UNIFIED: extended_unified_camera_to_pixel,
    M.ORTHOGRAPHIC: orthographic_camera_to_pixel,
}

_PIXEL_TO_CAMERA: dict[CameraIntrinsicsModelType, Callable] = {
    M.PINHOLE: pinhole_pixel_to_camera,
    M.PINHOLE_RADIAL_TANGENTIAL: pinhole_radial_tangential_pixel_to_camera,
    M.FISHEYE: fisheye_pixel_to_camera,
    M.FOV: fov_pixel_to_camera,
    M.DIVISION_UNDISTORTION: division_pixel_to_camera,
    M.DOUBLE_SPHERE: double_sphere_pixel_to_camera,
    M.EXTENDED_UNIFIED: extended_unified_pixel_to_camera,
    M.ORTHOGRAPHIC: orthographic_pixel_to_camera,
}


def camera_to_pixel(params: torch.Tensor, point3: torch.Tensor, model) -> torch.Tensor:
    """Project a camera-frame 3D point to a pixel; `model` is static (one
    model a call). Parity: `CameraIntrinsicsModel::CameraToPixelCoordinates`
    (`camera_intrinsics_model.h:124`)."""
    return _CAMERA_TO_PIXEL[M(model)](params, point3)


def pixel_to_camera(params: torch.Tensor, pixel: torch.Tensor, model) -> torch.Tensor:
    """Unproject a pixel to a camera-frame ray: on the z = 1 plane for the
    pinhole-like models, a unit-ish 3-D bearing for DOUBLE_SPHERE and
    EXTENDED_UNIFIED. Parity:
    `CameraIntrinsicsModel::PixelToCameraCoordinates`
    (`camera_intrinsics_model.h:133`)."""
    return _PIXEL_TO_CAMERA[M(model)](params, pixel)
