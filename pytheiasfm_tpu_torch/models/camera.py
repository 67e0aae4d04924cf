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
    "project_point",
    "project_point_homogeneous",
    "pixel_to_normalized_batch",
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
