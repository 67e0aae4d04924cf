"""PLY point-cloud export.

Counterpart of the JAX package's `io/ply.py` (`theia/io/write_ply_file.{h,cc}`):
the estimated track positions with their colors and, optionally, the
estimated camera positions in green, as an ascii PLY.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_ply_file"]


def write_ply_file(path: str, recon, color_cameras: bool = True) -> bool:
    """Parity: `theia::WritePlyFile` (`write_ply_file.h`)."""
    est_tracks = np.flatnonzero(recon.track_estimated)
    w = recon.points[est_tracks, 3:4]
    pts = recon.points[est_tracks, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)
    colors = recon.track_colors[est_tracks]
    cams = []
    if color_cameras:
        cams = [recon.view_extrinsics[v, :3] for v in range(recon.num_views())
                if recon.view_estimated[v]]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts) + len(cams)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
        for p in cams:
            f.write(f"{p[0]} {p[1]} {p[2]} 0 255 0\n")
    return True
