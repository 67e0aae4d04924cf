"""1DSfM dataset reader (Wilson & Snavely ECCV'14 benchmark format).

Counterpart of the JAX package's `io/onedsfm.py` (`theia/io/read_1dsfm.{h,cc}`):
`cc.txt` (the valid image ids), `list.txt` (image names and EXIF focal
lengths), `coords.txt` (keypoints and colors), `tracks.txt` (feature
tracks) and `EGs.txt` (two-view geometries in the Bundler frame, turned by
diag(1, -1, -1)). Returns (Reconstruction, ViewGraph); the tracks are
appended in bulk.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import rotation as rotops
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from ..sfm.view_graph import TwoViewInfo, ViewGraph
from .recon import append_tracks

__all__ = ["read_1dsfm"]

_FLIP = np.diag([1.0, -1.0, -1.0])


def _read_tracks(recon, path, feature_coords, feature_colors):
    """tracks.txt (read_1dsfm.cc:254): tracks of at least two features, all
    on known views and keypoints, with their mean color."""
    with open(path) as f:
        it = iter(f.read().split())
    colors, counts, views, pixels = [], [], [], []
    for _ in range(int(next(it))):
        obs, color, ok = [], np.zeros(3), True
        for _ in range(int(next(it))):
            v, feat = int(next(it)), int(next(it))
            if v not in feature_coords or feat >= len(feature_coords[v]):
                ok = False
                continue
            obs.append((v, feature_coords[v][feat]))
            color += feature_colors[v][feat]
        if not ok or len(obs) < 2:
            continue
        colors.append((color / max(len(obs), 1)).astype(np.uint8))
        counts.append(len(obs))
        for v, uv in obs:
            views.append(v)
            pixels.append(uv)
    append_tracks(recon, None, np.asarray(colors, np.uint8).reshape(-1, 3), counts, views,
                  pixels)


def read_1dsfm(dataset_directory: str):
    """Parity: `theia::Read1DSFM` (`read_1dsfm.h:67`)."""
    d = dataset_directory

    # cc.txt: the valid connected component (read_1dsfm.cc:94).
    with open(os.path.join(d, "cc.txt")) as f:
        valid = {int(tok) for tok in f.read().split()}

    recon = Reconstruction()
    graph = ViewGraph()

    # list.txt: names and optional "0 focal" (read_1dsfm.cc:115). View ids
    # follow the file's rows; rows outside cc.txt stay as views no edge uses.
    kept = set()
    with open(os.path.join(d, "list.txt")) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            name = os.path.basename(parts[0])
            focal = float(parts[2]) if len(parts) >= 3 else None
            recon.add_view(name if name else f"view_{i}",
                           prior=CameraIntrinsicsPrior(focal_length=focal))
            if i in valid:
                kept.add(i)

    # coords.txt: each image's keypoints (read_1dsfm.cc:203).
    feature_coords: dict[int, np.ndarray] = {}
    feature_colors: dict[int, np.ndarray] = {}
    with open(os.path.join(d, "coords.txt")) as f:
        line = f.readline()
        while line:
            if not line.startswith("#index"):
                line = f.readline()
                continue
            # "#index = %d, name = %s keys = %d, px = %f, py = %f, focal = %f"
            view_id = int(line.split("#index = ")[1].split(",")[0])
            num_keys = int(line.split("keys = ")[1].split(",")[0])
            px = float(line.split("px = ")[1].split(",")[0])
            py = float(line.split("py = ")[1].split(",")[0])
            if view_id < recon.num_views():
                p = recon.view_priors[view_id]
                p.image_width = int(px * 2)
                p.image_height = int(py * 2)
                p.principal_point = (px, py)
            coords = np.zeros((num_keys, 2))
            colors = np.zeros((num_keys, 3), np.uint8)
            for k in range(num_keys):
                row = f.readline().split()
                coords[k] = [float(row[1]), float(row[2])]
                if len(row) >= 8:
                    colors[k] = [int(row[5]), int(row[6]), int(row[7])]
            feature_coords[view_id] = coords
            feature_colors[view_id] = colors
            line = f.readline()

    tracks_path = os.path.join(d, "tracks.txt")
    if os.path.exists(tracks_path):
        _read_tracks(recon, tracks_path, feature_coords, feature_colors)

    # EGs.txt (read_1dsfm.cc:302): i j R (9, row-major) t (3), Bundler frame.
    edges, rotations = [], []
    with open(os.path.join(d, "EGs.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 14:
                continue
            v1, v2 = int(parts[0]), int(parts[1])
            if v1 not in kept or v2 not in kept:
                continue
            Rb = np.array(parts[2:11], float).reshape(3, 3)
            rotations.append(_FLIP @ Rb.T @ _FLIP)
            edges.append((v1, v2, _FLIP @ np.array(parts[11:14], float)))
    if edges:
        aa = rotops.rotation_matrix_to_angle_axis(
            torch.as_tensor(np.stack(rotations), dtype=torch.float64)).numpy()
    for (v1, v2, t), rotation_2 in zip(edges, aa if edges else ()):
        info = TwoViewInfo(rotation_2=np.array(rotation_2), position_2=t)
        p1, p2 = recon.view_priors[v1], recon.view_priors[v2]
        info.focal_length_1 = p1.focal_length or (
            1.2 * (p1.principal_point[0] if p1.principal_point else 1.0))
        info.focal_length_2 = p2.focal_length or (
            1.2 * (p2.principal_point[0] if p2.principal_point else 1.0))
        common = set(recon.tracks_in_view(v1)) & set(recon.tracks_in_view(v2))
        info.num_verified_matches = len(common)
        info.visibility_score = len(common)
        graph.add_edge(v1, v2, info)
    return recon, graph
