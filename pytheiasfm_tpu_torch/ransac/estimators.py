"""RANSAC-wrapped robust estimators (`theia/sfm/estimators/`).

Counterpart of the JAX package's `ransac/estimators.py`. Ported so far: the
calibrated relative pose (`estimate_relative_pose`) and the homography
(`estimate_homography`) that two-view verification counts inliers of; the
other estimators port with the slices that use them.

Conventions:
  - "normalized correspondences": calibrated image points (intrinsics
    removed).
  - Relative pose models carry `position` = camera-2 center expressed in
    camera-1 coordinates (reference `RelativePose`, estimate_relative_pose.h).
  - Every tensor carries the problem axis P first; minimal solves carry
    [P, B] (sample) and the solution slot K after it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import epipolar, five_point, triangulation as tri
from . import engine

__all__ = [
    "HOMOGRAPHY_ESTIMATOR",
    "Homography",
    "RELATIVE_POSE_ESTIMATOR",
    "RelativePose",
    "TwoViewData",
    "estimate_homography",
    "estimate_relative_pose",
]


class RelativePose(NamedTuple):
    """Parity: `theia::RelativePose` (estimate_relative_pose.h)."""

    rotation: torch.Tensor  # [.., 3, 3]
    position: torch.Tensor  # [.., 3] camera-2 center in camera-1 frame
    essential_matrix: torch.Tensor  # [.., 3, 3]


class TwoViewData(NamedTuple):
    points1: torch.Tensor  # [P, N, 2]
    points2: torch.Tensor  # [P, N, 2]


_BIG = 1e12


def _relative_pose_solver(subset: TwoViewData):
    """5-pt -> up to 10 E -> best cheirality pose each.

    Parity: `RelativePoseEstimator::EstimateModel`
    (estimate_relative_pose.cc:75). subset points [P, B, 5, 2] -> models
    [P, B, 10, ...], valid [P, B, 10].
    """
    E, valid = five_point.five_point_relative_pose(subset.points1, subset.points2)
    R, pos, _count = epipolar.get_best_pose_from_essential_matrix(
        E, subset.points1[..., None, :, :], subset.points2[..., None, :, :]
    )
    return RelativePose(rotation=R, position=pos, essential_matrix=E), valid


def _relative_pose_residuals(model: RelativePose, data: TwoViewData):
    """Sampson gated by cheirality (estimate_relative_pose.cc:142-152):
    models [P, H, ...] against data [P, N, 2] -> [P, H, N]."""
    p1 = data.points1[:, None]  # [P, 1, N, 2]
    p2 = data.points2[:, None]
    sampson = epipolar.squared_sampson_distance(model.essential_matrix, p1, p2)
    in_front = tri.is_triangulated_point_in_front_of_cameras(
        p1, p2, model.rotation[..., None, :, :], model.position[..., None, :]
    )
    return torch.where(in_front, sampson, _BIG)


RELATIVE_POSE_ESTIMATOR = engine.Estimator(
    sample_size=5,
    solve=_relative_pose_solver,
    residuals=_relative_pose_residuals,
)


def estimate_relative_pose(
    generator, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateRelativePose` (estimate_relative_pose.cc:160),
    over P problems at once.

    points1/points2: normalized (calibrated) correspondences [P, N, 2].
    Returns (RelativePose with leading axis [P], RansacSummary).
    """
    return engine.ransac(
        generator, TwoViewData(points1, points2), RELATIVE_POSE_ESTIMATOR, params,
        mask=mask, **kw,
    )


class Homography(NamedTuple):
    """The homography model: x2 ~ homography x1, h33 = 1."""

    homography: torch.Tensor  # [.., 3, 3]


def _homography_solver(subset: TwoViewData):
    """Four-point DLT: subset points [P, B, 4, 2] -> H [P, B, 1, 3, 3],
    valid [P, B, 1]."""
    H, ok = epipolar.four_point_homography(subset.points1, subset.points2)
    return Homography(H[..., None, :, :]), ok[..., None]


def _homography_residuals(model: Homography, data: TwoViewData):
    """Asymmetric transfer error in image 2 (estimate_homography.cc:108-114):
    models [P, H, 3, 3] against data [P, N, 2] -> [P, H, N]."""
    p1 = data.points1[:, None]  # [P, 1, N, 2]
    Hr = model.homography[..., None, :, :]  # broadcast over N
    proj = [sum(
        (p1[..., j] if j < 2 else 1.0) * Hr[..., i, j] for j in range(3)
    ) for i in range(3)]
    w = proj[2]
    small = torch.abs(w) < 1e-12
    w_safe = torch.where(small, torch.ones_like(w), w)
    p2 = data.points2[:, None]
    err = (p2[..., 0] - proj[0] / w_safe) ** 2 + (p2[..., 1] - proj[1] / w_safe) ** 2
    return torch.where(small, _BIG, err)


HOMOGRAPHY_ESTIMATOR = engine.Estimator(
    sample_size=4,
    solve=_homography_solver,
    residuals=_homography_residuals,
)


def estimate_homography(
    generator, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateHomography` (estimate_homography.cc:122), over
    P problems at once. points1/points2 [P, N, 2]. Returns (Homography with
    leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, TwoViewData(points1, points2), HOMOGRAPHY_ESTIMATOR, params,
        mask=mask, **kw,
    )
