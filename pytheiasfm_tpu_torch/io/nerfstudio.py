"""NeRFStudio / SDFStudio exporters.

Counterpart of the JAX package's `io/nerfstudio.py`
(`theia/io/write_nerfstudio.{h,cc}`, `write_sdfstudio.{h,cc}`):
`transforms.json` / `meta_data.json` with OpenGL-convention
camera-to-world matrices (x right, y up, z back: the y and z rows of our
world-to-camera convention flipped).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops.rotation_np import angle_axis_to_rotation_matrix_np

__all__ = ["write_nerfstudio_files", "write_sdfstudio_files"]

_CV_TO_GL = np.diag([1.0, -1.0, -1.0])


def _camera_to_world_gl(recon, v) -> np.ndarray:
    R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[v, 3:])
    c2w = np.eye(4)
    c2w[:3, :3] = R.T @ _CV_TO_GL
    c2w[:3, 3] = recon.view_extrinsics[v, :3]
    return c2w


def write_nerfstudio_files(recon, output_dir: str, aabb_scale: int = 16) -> bool:
    """Parity: `theia::WriteNerfStudio` (`io/write_nerfstudio.h`)."""
    os.makedirs(output_dir, exist_ok=True)
    frames = []
    for v in range(recon.num_views()):
        if not recon.view_estimated[v]:
            continue
        params = recon.intrinsics[recon.view_group[v]]
        prior = recon.view_priors[v]
        frames.append({
            "file_path": recon.view_names[v],
            "fl_x": float(params[0]),
            "fl_y": float(params[0] * params[1]) if len(params) > 1 else float(params[0]),
            "cx": float(params[3]),
            "cy": float(params[4]),
            "w": prior.image_width,
            "h": prior.image_height,
            "transform_matrix": _camera_to_world_gl(recon, v).tolist(),
        })
    with open(os.path.join(output_dir, "transforms.json"), "w") as f:
        json.dump({"aabb_scale": aabb_scale, "frames": frames}, f, indent=2)
    return True


def write_sdfstudio_files(recon, output_dir: str, scene_scale: float = 1.0) -> bool:
    """Parity: `theia::WriteSdfStudio` (`io/write_sdfstudio.h`): each frame's
    intrinsics and camera-to-world matrix in a meta_data.json."""
    os.makedirs(output_dir, exist_ok=True)
    frames = []
    for v in range(recon.num_views()):
        if not recon.view_estimated[v]:
            continue
        params = recon.intrinsics[recon.view_group[v]]
        K = np.eye(4)
        K[0, 0] = params[0]
        K[1, 1] = params[0] * (params[1] if len(params) > 1 else 1.0)
        K[0, 2] = params[3]
        K[1, 2] = params[4]
        frames.append({
            "rgb_path": recon.view_names[v],
            "intrinsics": K.tolist(),
            "camtoworld": _camera_to_world_gl(recon, v).tolist(),
        })
    prior = recon.view_priors[0] if recon.num_views() else None
    out = {
        "camera_model": "OPENCV",
        "height": prior.image_height if prior else 0,
        "width": prior.image_width if prior else 0,
        "scene_box": {
            "aabb": [[-scene_scale] * 3, [scene_scale] * 3],
            "near": 0.05,
            "far": 2.5 * scene_scale,
            "radius": scene_scale,
            "collider_type": "near_far",
        },
        "frames": frames,
    }
    with open(os.path.join(output_dir, "meta_data.json"), "w") as f:
        json.dump(out, f, indent=2)
    return True
