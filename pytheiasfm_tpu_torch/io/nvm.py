"""VisualSfM NVM_V3 import/export.

Counterpart of the JAX package's `io/nvm.py` (`theia/io/write_nvm_file.{h,cc}`,
`import_nvm_file.{h,cc}`): a camera per line, `name f qw qx qy qz cx cy cz
k1 0`; a point per line, `xyz rgb n (img feat x y)*` with the features
centred on the principal point. The importer appends the tracks in bulk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rotation as rotops
from ..ops.rotation_np import rotation_matrix_to_angle_axis_np
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from .colmap import view_rotations_and_quaternions
from .recon import append_tracks

__all__ = ["export_nvm_file", "import_nvm_file"]


def export_nvm_file(recon, path: str) -> bool:
    """Parity: `theia::WriteNVMFile` (`write_nvm_file.cc`)."""
    _, q_all = view_rotations_and_quaternions(recon)
    with open(path, "w") as f:
        f.write("NVM_V3 \n\n")
        f.write(f"{recon.num_views()}\n")
        feature_index: list[dict[int, int]] = []
        for v in range(recon.num_views()):
            params = recon.intrinsics[recon.view_group[v]]
            q, c = q_all[v], recon.view_extrinsics[v, :3]
            k1 = params[5] if len(params) > 5 else 0.0
            f.write(f"{recon.view_names[v]} {params[0]} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{c[0]} {c[1]} {c[2]} {k1} 0\n")
            feature_index.append({t: i for i, t in enumerate(recon._view_track_to_obs[v])})
        f.write(f"{recon.num_tracks()}\n")
        for t in range(recon.num_tracks()):
            w = recon.points[t, 3]
            p = recon.points[t, :3] / (w if abs(w) > 1e-12 else 1.0)
            color = recon.track_colors[t]
            rows = recon.track_observations(t)
            parts = [f"{p[0]} {p[1]} {p[2]}",
                     f"{int(color[0])} {int(color[1])} {int(color[2])}", str(len(rows))]
            for row in rows:
                v = int(recon.obs_view[row])
                g = recon.view_group[v]
                px, py = recon.intrinsics[g][3], recon.intrinsics[g][4]
                uv = recon.obs_uv[row]
                parts.append(f"{v} {feature_index[v][t]} {uv[0] - px} {uv[1] - py}")
            f.write(" ".join(parts) + "\n")
    return True


def import_nvm_file(path: str) -> Reconstruction:
    """Parity: `theia::ImportNVMFile` (`import_nvm_file.cc`)."""
    recon = Reconstruction()
    with open(path) as f:
        it = iter(f.read().split())

    def nxt():
        return next(it)

    header = nxt()
    assert header.startswith("NVM_V3"), f"not an NVM_V3 file: {header}"
    num_cams = int(nxt())
    quats = np.zeros((num_cams, 4))
    for v in range(num_cams):
        name = nxt()
        focal = float(nxt())
        quats[v] = [float(nxt()) for _ in range(4)]
        c = np.array([float(nxt()) for _ in range(3)])
        k1 = float(nxt())
        nxt()  # the trailing 0
        recon.add_view(name, prior=CameraIntrinsicsPrior(focal_length=focal))
        recon.view_extrinsics[v, :3] = c
        recon.view_estimated[v] = True
        g = recon.view_group[v]
        recon.intrinsics[g][0] = focal
        if recon.intrinsics.shape[1] > 5:
            recon.intrinsics[g][5] = k1
    if num_cams:
        R = rotops.quaternion_to_rotation_matrix(torch.as_tensor(quats)).numpy()
        recon.view_extrinsics[:, 3:] = rotation_matrix_to_angle_axis_np(R)

    num_points = int(nxt())
    points = np.zeros((num_points, 4))
    colors = np.zeros((num_points, 3), np.uint8)
    counts = np.zeros(num_points, np.int64)
    views, pixels = [], []
    for i in range(num_points):
        points[i] = [float(nxt()) for _ in range(3)] + [1.0]
        colors[i] = [int(float(nxt())) for _ in range(3)]
        counts[i] = int(nxt())
        for _ in range(counts[i]):
            v = int(nxt())
            nxt()  # the feature's index
            x, y = float(nxt()), float(nxt())
            g = recon.view_group[v]
            views.append(v)
            pixels.append((x + recon.intrinsics[g][3], y + recon.intrinsics[g][4]))
    append_tracks(recon, points, colors, counts, views, pixels)
    return recon
