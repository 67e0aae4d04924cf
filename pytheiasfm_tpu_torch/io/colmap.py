"""COLMAP text-model export.

Counterpart of the JAX package's `io/colmap.py`
(`theia/io/write_colmap_files.{h,cc}`): cameras.txt (one RADIAL camera per
intrinsics group), images.txt (`qw qx qy qz tx ty tz` with t = -R c, then
the 2-D point list), points3D.txt. Rotations in f64.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import rotation as rotops
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np

__all__ = ["write_colmap_files"]


def view_rotations_and_quaternions(recon):
    """(world->camera rotations [V, 3, 3], their unit quaternions [V, 4]
    (w, x, y, z)) of every view, in f64."""
    R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[:, 3:].reshape(-1, 3))
    q = rotops.rotation_matrix_to_quaternion(torch.as_tensor(R, dtype=torch.float64)).numpy()
    return R, q


def write_colmap_files(recon, output_dir: str) -> bool:
    """Parity: `theia::WriteColmapFiles` (`write_colmap_files.h`)."""
    os.makedirs(output_dir, exist_ok=True)

    with open(os.path.join(output_dir, "cameras.txt"), "w") as f:
        for g in range(len(recon.group_model)):
            # The group's first view gives the image size.
            views = np.flatnonzero(recon.view_group == g)
            if len(views) == 0:
                continue
            prior = recon.view_priors[views[0]]
            params = recon.intrinsics[g]
            # Pinhole layout: [f, ar, skew, px, py, k1, k2] (intrinsics.py).
            k1 = params[5] if len(params) > 5 else 0.0
            f.write(f"{g} RADIAL {prior.image_width} {prior.image_height} "
                    f"{params[0]} {params[3]} {params[4]} {k1} {k1}\n")

    R_all, q_all = view_rotations_and_quaternions(recon)
    with open(os.path.join(output_dir, "images.txt"), "w") as f:
        for v in range(recon.num_views()):
            if not recon.view_estimated[v]:
                continue
            q, t = q_all[v], -R_all[v] @ recon.view_extrinsics[v, :3]
            f.write(f"{v} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
                    f"{int(recon.view_group[v])} {recon.view_names[v]}\n")
            parts = []
            for track, row in recon._view_track_to_obs[v].items():
                uv = recon.obs_uv[row]
                parts.append(f"{uv[0]} {uv[1]} {track}")
            f.write(" ".join(parts) + "\n")

    # A track's index in each view's point list (the list's order above).
    index = [{t: i for i, t in enumerate(d)} for d in recon._view_track_to_obs]
    with open(os.path.join(output_dir, "points3D.txt"), "w") as f:
        for t in range(recon.num_tracks()):
            if not recon.track_estimated[t]:
                continue
            w = recon.points[t, 3]
            p = recon.points[t, :3] / (w if abs(w) > 1e-12 else 1.0)
            c = recon.track_colors[t]
            f.write(f"{t} {p[0]} {p[1]} {p[2]} {int(c[0])} {int(c[1])} {int(c[2])} 0.0 ")
            parts = []
            for row in recon.track_observations(t):
                v = int(recon.obs_view[row])
                parts.append(f"{v} {index[v][t]}")
            f.write(" ".join(parts) + "\n")
    return True
