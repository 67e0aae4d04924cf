"""Camera extrinsics and projection on tensors: the SoA form of `theia::Camera`.

Counterpart of the JAX package's `models/camera.py`
(`theia/sfm/camera/camera.h:62`). A scene's cameras are flat arrays:

    extrinsics  [V, 6]    (position, angle_axis) as the reference stores them
    intrinsics  [G, MAX_INTRINSICS] with a view->group index

and each method of `theia::Camera` is a batched function. World to camera:
``p_cam = R @ (X - c)`` with R = exp(angle_axis) and c the camera position.
"""

from __future__ import annotations

import torch

from ..ops import rotation as rot
from . import intrinsics as intr

__all__ = [
    "POSITION",
    "ORIENTATION",
    "EXTRINSICS_SIZE",
    "make_extrinsics",
    "position",
    "orientation",
    "rotation_matrix",
    "project_point",
    "project_point_homogeneous",
    "pixel_to_unit_depth_ray",
    "pixel_to_normalized",
    "pixel_to_normalized_batch",
    "compose_projection_matrix",
    "decompose_projection_matrix",
    "camera_from_projection_matrix",
]

POSITION = 0
ORIENTATION = 3
EXTRINSICS_SIZE = 6


def make_extrinsics(position: torch.Tensor, angle_axis: torch.Tensor) -> torch.Tensor:
    """Pack [.., 3] position + [.., 3] angle-axis into [.., 6] extrinsics."""
    return torch.cat([position, angle_axis], dim=-1)


def position(extrinsics: torch.Tensor) -> torch.Tensor:
    return extrinsics[..., POSITION : POSITION + 3]


def orientation(extrinsics: torch.Tensor) -> torch.Tensor:
    return extrinsics[..., ORIENTATION : ORIENTATION + 3]


def rotation_matrix(extrinsics: torch.Tensor) -> torch.Tensor:
    """World->camera rotation matrix [.., 3, 3]."""
    return rot.angle_axis_to_rotation_matrix(orientation(extrinsics))


def project_point_homogeneous(extrinsics, intrinsics, point4, model):
    """Project a homogeneous world point [.., 4] -> (depth [..], pixel [.., 2]).

    Parity: `theia::Camera::ProjectPoint` (`camera.h:122`): depth is the
    camera-frame z divided by the homogeneous w; negative means behind the
    camera.
    """
    adjusted = point4[..., :3] - point4[..., 3:4] * position(extrinsics)
    p_cam = rot.angle_axis_rotate_point(orientation(extrinsics), adjusted)
    pixel = intr.camera_to_pixel(intrinsics, p_cam, model)
    w = point4[..., 3]
    depth = p_cam[..., 2] / torch.where(w == 0, torch.ones_like(w), w)
    return depth, pixel


def project_point(extrinsics, intrinsics, point3, model):
    """Project an inhomogeneous world point [.., 3] -> (depth, pixel)."""
    point4 = torch.cat([point3, torch.ones_like(point3[..., :1])], dim=-1)
    return project_point_homogeneous(extrinsics, intrinsics, point4, model)


def pixel_to_normalized_batch(intrinsics, pixels, model):
    """[N, 2] pixels of one intrinsics group -> [N, 3] normalized
    camera-frame rays (intrinsics removed)."""
    return intr.pixel_to_camera(intrinsics, pixels, model)


def pixel_to_normalized(intrinsics, pixel, model):
    """Pixel -> normalized camera-frame ray (intrinsics removed)."""
    return intr.pixel_to_camera(intrinsics, pixel, model)


def pixel_to_unit_depth_ray(extrinsics, intrinsics, pixel, model):
    """Pixel -> world-frame ray direction with unit depth along the optical
    axis. Parity: `theia::Camera::PixelToUnitDepthRay` (`camera.h:147`)."""
    ray_cam = intr.pixel_to_camera(intrinsics, pixel, model)
    # Camera to world: rotate by R^T, the negated angle-axis.
    return rot.angle_axis_rotate_point(-orientation(extrinsics), ray_cam)


def compose_projection_matrix(extrinsics, intrinsics_f=None):
    """[R | -R c] as a [.., 3, 4] matrix (calibrated projection, K = I).
    `intrinsics_f` is unused, as in the JAX function. Parity:
    `theia::ComposeProjectionMatrix` (`camera/projection_matrix_utils.h`)."""
    R = rotation_matrix(extrinsics)
    t = -(R @ position(extrinsics)[..., None])
    return torch.cat([R, t], dim=-1)


def decompose_projection_matrix(P: torch.Tensor):
    """[.., 3, 4] calibrated projection matrix -> (angle_axis, position).

    Parity: `theia::DecomposeProjectionMatrix` for K = I: the left 3x3
    block projected to SO(3), c = -R^T t."""
    R = rot.project_to_so3(P[..., :3])
    t = P[..., 3]
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return rot.rotation_matrix_to_angle_axis(R), c


def camera_from_projection_matrix(P: torch.Tensor) -> torch.Tensor:
    """[.., 3, 4] -> [.., 6] extrinsics. Parity:
    `theia::Camera::InitializeFromProjectionMatrix` (`camera.h:85`)."""
    aa, c = decompose_projection_matrix(P)
    return make_extrinsics(c, aa)
