"""Triangulation tests used by two-view verification.

Counterpart of the JAX package's `ops/triangulation.py`
(`theia/sfm/triangulation/triangulation.{h,cc}`). Only the cheirality test
is on this slice's path; the triangulation methods port with the structure
slice.
"""

from __future__ import annotations

import torch

__all__ = ["is_triangulated_point_in_front_of_cameras"]


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def is_triangulated_point_in_front_of_cameras(point1, point2, rotation, position):
    """Cheirality test without explicit triangulation.

    Parity: `theia::IsTriangulatedPointInFrontOfCameras`
    (`triangulation.cc:219-236`): point1/point2 are normalized image points
    [.., 2], rotation [.., 3, 3] and position [.., 3] the relative pose
    (camera 2 w.r.t. camera 1).
    """
    dir1 = _homogeneous(point1)
    # dir2 = R^T x2, written as sum_j x2_j R[j, :] so that a block of
    # hypotheses broadcasts against all points without expanding R per point.
    x2 = _homogeneous(point2)
    dir2 = sum(x2[..., j : j + 1] * rotation[..., j, :] for j in range(3))
    dir1_sq = torch.sum(dir1 * dir1, dim=-1)
    dir2_sq = torch.sum(dir2 * dir2, dim=-1)
    dir1_dir2 = torch.sum(dir1 * dir2, dim=-1)
    dir1_pos = torch.sum(dir1 * position, dim=-1)
    dir2_pos = torch.sum(dir2 * position, dim=-1)
    return (dir2_sq * dir1_pos - dir1_dir2 * dir2_pos > 0) & (
        dir1_dir2 * dir1_pos - dir1_sq * dir2_pos > 0
    )
