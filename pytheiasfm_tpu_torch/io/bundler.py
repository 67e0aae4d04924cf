"""Bundler (`bundle.out` + `list.txt`) import/export.

Counterpart of the JAX package's `io/bundler.py`
(`theia/io/write_bundler_files.{h,cc}`, `read_bundler_files.{h,cc}`,
`bundler_file_reader.h:76-92`). Bundler's camera frame differs from ours by
diag(1, -1, -1); pixels are centred on the principal point with y up.
The reader appends the tracks in bulk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rotation as rotops
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from .recon import append_tracks

__all__ = ["write_bundler_files", "read_bundler_files"]

_FLIP = np.diag([1.0, -1.0, -1.0])


def write_bundler_files(recon, bundle_file: str, lists_file: str) -> bool:
    """Parity: `theia::WriteBundlerFiles` (`write_bundler_files.cc`)."""
    with open(lists_file, "w") as lf, open(bundle_file, "w") as bf:
        bf.write("# Bundle file v0.3\n")
        bf.write(f"{recon.num_views()} {recon.num_tracks()}\n")
        for v in range(recon.num_views()):
            prior = recon.view_priors[v]
            lf.write(recon.view_names[v])
            if prior.focal_length is not None:
                lf.write(f" 0 {prior.focal_length}")
            lf.write("\n")
            params = recon.intrinsics[recon.view_group[v]]
            k1 = params[5] if len(params) > 5 else 0.0
            k2 = params[6] if len(params) > 6 else 0.0
            bf.write(f"{params[0]} {k1} {k2}\n")
            R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[v, 3:])
            Rb = _FLIP @ R
            tb = _FLIP @ (-R @ recon.view_extrinsics[v, :3])
            for row in Rb:
                bf.write(f"{row[0]} {row[1]} {row[2]}\n")
            bf.write(f"{tb[0]} {tb[1]} {tb[2]}\n")

        for t in range(recon.num_tracks()):
            w = recon.points[t, 3]
            p = recon.points[t, :3] / (w if abs(w) > 1e-12 else 1.0)
            c = recon.track_colors[t]
            bf.write(f"{p[0]} {p[1]} {p[2]}\n")
            bf.write(f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
            rows = recon.track_observations(t)
            parts = [str(len(rows))]
            for row in rows:
                v = int(recon.obs_view[row])
                g = recon.view_group[v]
                px, py = recon.intrinsics[g][3], recon.intrinsics[g][4]
                uv = recon.obs_uv[row]
                # Bundler: origin at the image centre, y up.
                parts.append(f"{v} 0 {uv[0] - px} {-(uv[1] - py)}")
            bf.write(" ".join(parts) + "\n")
    return True


def read_bundler_files(lists_file: str, bundle_file: str) -> Reconstruction:
    """Parity: `theia::ReadBundlerFiles` (`read_bundler_files.cc`)."""
    recon = Reconstruction()
    names, focals = [], []
    with open(lists_file) as lf:
        for line in lf:
            parts = line.split()
            if not parts:
                continue
            names.append(parts[0])
            focals.append(float(parts[2]) if len(parts) >= 3 else None)

    with open(bundle_file) as bf:
        lines = [ln for ln in bf.read().split("\n") if not ln.startswith("#")]
    it = iter(" ".join(lines).split())

    def nxt():
        return next(it)

    num_cams = int(nxt())
    num_points = int(nxt())
    assert num_cams == len(names), "lists/bundle camera count mismatch"
    Rs = []
    for v in range(num_cams):
        focal = float(nxt())
        k1, k2 = float(nxt()), float(nxt())
        recon.add_view(names[v], prior=CameraIntrinsicsPrior(focal_length=focal or focals[v]))
        R = _FLIP @ np.array([[float(nxt()) for _ in range(3)] for _ in range(3)])
        t = _FLIP @ np.array([float(nxt()) for _ in range(3)])
        Rs.append(R)
        recon.view_extrinsics[v, :3] = -R.T @ t
        recon.view_estimated[v] = focal > 0
        g = recon.view_group[v]
        recon.intrinsics[g][0] = focal or (focals[v] or 1.0)
        recon.intrinsics[g][5:7] = [k1, k2]
    if num_cams:
        recon.view_extrinsics[:, 3:] = rotops.rotation_matrix_to_angle_axis(
            torch.as_tensor(np.stack(Rs), dtype=torch.float64)).numpy()

    points = np.zeros((num_points, 4))
    colors = np.zeros((num_points, 3), np.uint8)
    counts = np.zeros(num_points, np.int64)
    views, pixels = [], []
    for i in range(num_points):
        points[i] = [float(nxt()) for _ in range(3)] + [1.0]
        colors[i] = [int(float(nxt())) for _ in range(3)]
        counts[i] = int(nxt())
        for _ in range(counts[i]):
            views.append(int(nxt()))
            nxt()  # the feature's key
            x, y = float(nxt()), float(nxt())
            pixels.append((x, -y))
    append_tracks(recon, points, colors, counts, views, pixels)
    return recon
