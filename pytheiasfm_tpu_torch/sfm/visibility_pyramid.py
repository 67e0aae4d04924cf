"""Visibility pyramid: multi-level occupancy score for view selection.

Re-design of `theia/sfm/visibility_pyramid.{h,cc}`
(`visibility_pyramid.h:56-72`): an L-level pyramid of 2^(l+1) x 2^(l+1)
occupancy grids; the score is the total number of occupied cells across
levels. The reference mutates per-point; here the whole score is one
vectorized computation over all points (and batchable over views).
"""

from __future__ import annotations

import numpy as np

__all__ = ["visibility_score", "VisibilityPyramid"]


def visibility_score(points, width, height, num_levels: int = 6) -> int:
    """Score of a point set in a width x height image. points [N, 2]."""
    points = np.asarray(points)
    if len(points) == 0 or width <= 0 or height <= 0:
        return 0
    max_cells = 1 << num_levels
    gx = np.clip((max_cells * points[:, 0] / width).astype(np.int64), 0, max_cells - 1)
    gy = np.clip((max_cells * points[:, 1] / height).astype(np.int64), 0, max_cells - 1)
    score = 0
    for level in range(num_levels - 1, -1, -1):
        shift = num_levels - 1 - level
        cells_x = gx >> shift
        cells_y = gy >> shift
        dim = 1 << (1 + level)
        flat = cells_x * dim + cells_y
        score += len(np.unique(flat))
    return int(score)


class VisibilityPyramid:
    """Stateful parity shim matching the reference's AddPoint/ComputeScore
    API (`visibility_pyramid.h:65-70`)."""

    def __init__(self, width: int, height: int, num_pyramid_levels: int):
        assert width > 0 and height > 0 and num_pyramid_levels > 0
        self.width = width
        self.height = height
        self.num_levels = num_pyramid_levels
        self._points: list[tuple[float, float]] = []

    def add_point(self, point):
        self._points.append((float(point[0]), float(point[1])))

    def compute_score(self) -> int:
        return visibility_score(
            np.asarray(self._points).reshape(-1, 2),
            self.width,
            self.height,
            self.num_levels,
        )
