"""RANSAC-wrapped robust estimators (`theia/sfm/estimators/`).

Counterpart of the JAX package's `ransac/estimators.py`. Ported: the two-view
estimators (calibrated relative pose, essential and fundamental matrix,
homography, the uncalibrated relative pose), the calibrated absolute pose
(P3P) and RANSAC triangulation, each with its local-optimization refit. The
others raise `NotImplementedError` naming the ROADMAP item that ports them.

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

from ..ops import epipolar, five_point, p3p, pnp, triangulation as tri
from . import engine

__all__ = [
    "ABSOLUTE_POSE_ESTIMATOR",
    "CalibratedAbsolutePose",
    "Corr2D3D",
    "ESSENTIAL_ESTIMATOR",
    "EssentialMatrix",
    "FUNDAMENTAL_ESTIMATOR",
    "FundamentalMatrix",
    "HOMOGRAPHY_ESTIMATOR",
    "Homography",
    "RELATIVE_POSE_ESTIMATOR",
    "RelativePose",
    "TRIANGULATION_ESTIMATOR",
    "TriangulatedPoint",
    "TriangulationData",
    "TwoViewData",
    "UNCALIBRATED_RELATIVE_POSE_ESTIMATOR",
    "UncalibratedRelativePose",
    "estimate_absolute_pose_with_known_orientation",
    "estimate_calibrated_absolute_pose",
    "estimate_calibrated_absolute_pose_typed",
    "estimate_dominant_plane_from_points",
    "estimate_essential_matrix",
    "estimate_fundamental_matrix",
    "estimate_homography",
    "estimate_radial_dist_uncalibrated_absolute_pose",
    "estimate_radial_distortion_homography",
    "estimate_relative_pose",
    "estimate_relative_pose_with_known_orientation",
    "estimate_rigid_transformation_2d_3d",
    "estimate_similarity_transformation_2d_3d",
    "estimate_triangulation",
    "estimate_uncalibrated_absolute_pose",
    "estimate_uncalibrated_relative_pose",
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


def _enough(inliers, n):
    return torch.sum(inliers, dim=-1) >= n


def _relative_pose_refine(model: RelativePose, data: TwoViewData, inliers):
    """LO step: the 8-point F on the inliers [P, N], projected to the
    essential manifold, then the cheirality pose choice on the inliers
    (the JAX package's `_relative_pose_refine`)."""
    F, ok = epipolar.eight_point_fundamental_matrix(data.points1, data.points2, mask=inliers)
    E = epipolar.project_to_essential(F)
    R, pos, _ = epipolar.get_best_pose_from_essential_matrix(
        E, data.points1, data.points2, mask=inliers
    )
    return RelativePose(rotation=R, position=pos, essential_matrix=E), ok & _enough(inliers, 8)


RELATIVE_POSE_ESTIMATOR = engine.Estimator(
    sample_size=5,
    solve=_relative_pose_solver,
    residuals=_relative_pose_residuals,
    refine=_relative_pose_refine,
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


def _homography_refine(model: Homography, data: TwoViewData, inliers):
    H, ok = epipolar.four_point_homography(data.points1, data.points2, mask=inliers)
    return Homography(H), ok & _enough(inliers, 4)


HOMOGRAPHY_ESTIMATOR = engine.Estimator(
    sample_size=4,
    solve=_homography_solver,
    residuals=_homography_residuals,
    refine=_homography_refine,
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


def _sampson_residuals(F, data: TwoViewData):
    """Squared Sampson distances of models F [P, H, 3, 3] -> [P, H, N]."""
    return epipolar.squared_sampson_distance(F, data.points1[:, None], data.points2[:, None])


class EssentialMatrix(NamedTuple):
    essential_matrix: torch.Tensor  # [.., 3, 3]


def _essential_solver(subset: TwoViewData):
    E, valid = five_point.five_point_relative_pose(subset.points1, subset.points2)
    return EssentialMatrix(E), valid


def _essential_refine(model: EssentialMatrix, data: TwoViewData, inliers):
    F, ok = epipolar.eight_point_fundamental_matrix(data.points1, data.points2, mask=inliers)
    return EssentialMatrix(epipolar.project_to_essential(F)), ok & _enough(inliers, 8)


ESSENTIAL_ESTIMATOR = engine.Estimator(
    sample_size=5,
    solve=_essential_solver,
    residuals=lambda m, d: _sampson_residuals(m.essential_matrix, d),
    refine=_essential_refine,
)


def estimate_essential_matrix(
    generator, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateEssentialMatrix` (estimate_essential_matrix.cc),
    over P problems: five-point minimal solver, Sampson error, the 8-point
    refit projected to the essential manifold for local optimization.
    Returns (EssentialMatrix with leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, TwoViewData(points1, points2), ESSENTIAL_ESTIMATOR, params, mask=mask, **kw
    )


class FundamentalMatrix(NamedTuple):
    fundamental_matrix: torch.Tensor  # [.., 3, 3]


def _fundamental_solver(subset: TwoViewData):
    F, valid = epipolar.seven_point_fundamental_matrix(subset.points1, subset.points2)
    return FundamentalMatrix(F), valid


def _fundamental_refine(model: FundamentalMatrix, data: TwoViewData, inliers):
    F, ok = epipolar.eight_point_fundamental_matrix(data.points1, data.points2, mask=inliers)
    return FundamentalMatrix(F), ok & _enough(inliers, 8)


FUNDAMENTAL_ESTIMATOR = engine.Estimator(
    sample_size=7,
    solve=_fundamental_solver,
    residuals=lambda m, d: _sampson_residuals(m.fundamental_matrix, d),
    refine=_fundamental_refine,
)


def estimate_fundamental_matrix(
    generator, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateFundamentalMatrix`
    (estimate_fundamental_matrix.cc), over P problems: the 7-point minimal
    solver, Sampson error, the 8-point refit for local optimization.
    Returns (FundamentalMatrix with leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, TwoViewData(points1, points2), FUNDAMENTAL_ESTIMATOR, params, mask=mask, **kw
    )


class CalibratedAbsolutePose(NamedTuple):
    """Parity: `theia::CalibratedAbsolutePose`
    (estimate_calibrated_absolute_pose.h)."""

    rotation: torch.Tensor  # [.., 3, 3] world->camera
    position: torch.Tensor  # [.., 3] camera center in world


class Corr2D3D(NamedTuple):
    """Parity: `theia::FeatureCorrespondence2D3D`."""

    feature: torch.Tensor  # [P, N, 2] normalized image point
    world_point: torch.Tensor  # [P, N, 3]


def _p3p_solver(subset: Corr2D3D):
    """P3P: subset [P, B, 3, ...] -> poses [P, B, 4, ...]; t (p_cam = R p + t)
    becomes the camera position c = -R^T t."""
    R, t, valid = p3p.pose_from_three_points(subset.feature, subset.world_point)
    pos = -(R.mT @ t[..., None])[..., 0]
    return CalibratedAbsolutePose(rotation=R, position=pos), valid


def _abs_pose_residuals(model: CalibratedAbsolutePose, data: Corr2D3D):
    """Squared reprojection of normalized features
    (estimate_calibrated_absolute_pose.cc:158-168): models [P, H, ...]
    against data [P, N, ...] -> [P, H, N]."""
    X = data.world_point[:, None]  # [P, 1, N, 3]
    d = X - model.position[..., None, :]
    Rr = model.rotation[..., None, :, :]
    p = [sum(d[..., j] * Rr[..., i, j] for j in range(3)) for i in range(3)]
    z = p[2]
    behind = z < 1e-8
    z_safe = torch.where(behind, torch.ones_like(z), z)
    f = data.feature[:, None]
    err = (p[0] / z_safe - f[..., 0]) ** 2 + (p[1] / z_safe - f[..., 1]) ** 2
    return torch.where(behind, _BIG, err)


def _abs_pose_refine(model: CalibratedAbsolutePose, data: Corr2D3D, inliers):
    """LO step: the DLT PnP with a Gauss-Newton polish on the inliers."""
    R, pos, ok = pnp.dlt_pnp(data.feature, data.world_point, mask=inliers)
    return CalibratedAbsolutePose(rotation=R, position=pos), ok & _enough(inliers, 6)


ABSOLUTE_POSE_ESTIMATOR = engine.Estimator(
    sample_size=3,
    solve=_p3p_solver,
    residuals=_abs_pose_residuals,
    refine=_abs_pose_refine,
)


def estimate_calibrated_absolute_pose(
    generator, feature, world_point, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateCalibratedAbsolutePose`
    (estimate_calibrated_absolute_pose.cc:176; the KNEIP path, P3P), over P
    problems. feature [P, N, 2] normalized, world_point [P, N, 3].
    Returns (CalibratedAbsolutePose with leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, Corr2D3D(feature, world_point), ABSOLUTE_POSE_ESTIMATOR, params, mask=mask,
        **kw,
    )


class UncalibratedRelativePose(NamedTuple):
    """Parity: `theia::UncalibratedRelativePose`
    (estimate_uncalibrated_relative_pose.h)."""

    fundamental_matrix: torch.Tensor  # [.., 3, 3]
    focal_length1: torch.Tensor  # [..]
    focal_length2: torch.Tensor  # [..]
    rotation: torch.Tensor  # [.., 3, 3]
    position: torch.Tensor  # [.., 3]


def _uncalibrated_solver(subset: TwoViewData):
    """8-point F, Bougnoux's focal lengths, the pose of the implied E:
    subset [P, B, 8, 2] -> models [P, B, 1, ...]."""
    F, ok = epipolar.eight_point_fundamental_matrix(subset.points1, subset.points2)
    f1, f2, fvalid = epipolar.focal_lengths_from_fundamental_matrix(F)
    E = epipolar.essential_matrix_from_fundamental_matrix(F, f1, f2)
    n1 = subset.points1 / f1[..., None, None]
    n2 = subset.points2 / f2[..., None, None]
    R, pos, _ = epipolar.get_best_pose_from_essential_matrix(E, n1, n2)
    model = UncalibratedRelativePose(
        fundamental_matrix=F[..., None, :, :],
        focal_length1=f1[..., None],
        focal_length2=f2[..., None],
        rotation=R[..., None, :, :],
        position=pos[..., None, :],
    )
    return model, (ok & fvalid)[..., None]


UNCALIBRATED_RELATIVE_POSE_ESTIMATOR = engine.Estimator(
    sample_size=8,
    solve=_uncalibrated_solver,
    residuals=lambda m, d: _sampson_residuals(m.fundamental_matrix, d),
)


def estimate_uncalibrated_relative_pose(
    generator, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateUncalibratedRelativePose`
    (estimate_uncalibrated_relative_pose.cc), over P problems: the 8-point F,
    focal recovery and the pose from the implied E; Sampson residual on F
    (pixel units; points centred on the principal points). Returns
    (UncalibratedRelativePose with leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, TwoViewData(points1, points2), UNCALIBRATED_RELATIVE_POSE_ESTIMATOR, params,
        mask=mask, **kw,
    )


class TriangulationData(NamedTuple):
    poses: torch.Tensor  # [P, N, 3, 4] calibrated projection matrices
    points: torch.Tensor  # [P, N, 2] normalized observations


class TriangulatedPoint(NamedTuple):
    point: torch.Tensor  # [.., 4] homogeneous, unit norm, sign arbitrary


def _triangulation_solver(subset: TriangulationData):
    pt = tri.triangulate_dlt(
        subset.poses[..., 0, :, :], subset.poses[..., 1, :, :],
        subset.points[..., 0, :], subset.points[..., 1, :],
    )
    return TriangulatedPoint(pt[..., None, :]), torch.ones(
        pt.shape[:-1] + (1,), dtype=torch.bool, device=pt.device)


def _triangulation_residuals(model: TriangulatedPoint, data: TriangulationData):
    """Squared reprojection against every observation; a point at zero
    depth or behind a camera (with respect to its homogeneous sign) gets
    _BIG. Models [P, H, 4] -> [P, H, N]."""
    X = model.point[..., None, None, :]  # [P, H, 1, 1, 4]
    proj = torch.sum(data.poses[:, None] * X, dim=-1)  # [P, H, N, 3]
    z = proj[..., 2]
    bad = torch.abs(z) < 1e-12
    z_safe = torch.where(bad, torch.ones_like(z), z)
    err = torch.sum((proj[..., :2] / z_safe[..., None] - data.points[:, None]) ** 2, dim=-1)
    behind = z * torch.sign(model.point[..., 3])[..., None] <= 0
    return torch.where(bad | behind, _BIG, err)


def _triangulation_refine(model: TriangulatedPoint, data: TriangulationData, inliers):
    pt = tri.triangulate_nview(data.poses, data.points, mask=inliers)
    return TriangulatedPoint(pt), _enough(inliers, 2)


TRIANGULATION_ESTIMATOR = engine.Estimator(
    sample_size=2,
    solve=_triangulation_solver,
    residuals=_triangulation_residuals,
    refine=_triangulation_refine,
)


def estimate_triangulation(
    generator, poses, points, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateTriangulation` (estimate_triangulation.cc),
    over P tracks: RANSAC over view pairs, DLT triangulation, squared
    reprojection residual against every observation, the N-view refit for
    local optimization. poses [P, N, 3, 4] calibrated projection matrices;
    points [P, N, 2] normalized observations. Returns (TriangulatedPoint
    with leading axis [P], RansacSummary)."""
    return engine.ransac(
        generator, TriangulationData(poses, points), TRIANGULATION_ESTIMATOR, params,
        mask=mask, **kw,
    )


def _not_ported(name: str, item: str):
    def estimator(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP item {item})"
        )

    estimator.__name__ = name
    estimator.__doc__ = f"Not ported yet: raises NotImplementedError (ROADMAP item {item})."
    return estimator


# The estimators incremental SfM takes (C1) and the remaining minimal
# solvers' (E1).
estimate_absolute_pose_with_known_orientation = _not_ported(
    "estimate_absolute_pose_with_known_orientation", "C1")
estimate_calibrated_absolute_pose_typed = _not_ported(
    "estimate_calibrated_absolute_pose_typed", "C1")
estimate_relative_pose_with_known_orientation = _not_ported(
    "estimate_relative_pose_with_known_orientation", "E1")
estimate_uncalibrated_absolute_pose = _not_ported("estimate_uncalibrated_absolute_pose", "E1")
estimate_radial_dist_uncalibrated_absolute_pose = _not_ported(
    "estimate_radial_dist_uncalibrated_absolute_pose", "E1")
estimate_similarity_transformation_2d_3d = _not_ported(
    "estimate_similarity_transformation_2d_3d", "E1")
estimate_rigid_transformation_2d_3d = _not_ported("estimate_rigid_transformation_2d_3d", "E1")
estimate_dominant_plane_from_points = _not_ported("estimate_dominant_plane_from_points", "E1")
estimate_radial_distortion_homography = _not_ported(
    "estimate_radial_distortion_homography", "E1")
