"""Full two-view match geometric verification: RANSAC geometry -> guided
epipolar rematch -> triangulation gating -> two-view bundle adjustment.

Counterpart of the JAX package's `sfm/two_view_match_geometric_verification.py`
(`theia/sfm/two_view_match_geometric_verification.{h,cc}`; options
`.h:55-93`, flow `VerifyMatches` at `.cc:114-183`):

  1. homography inlier count (plane-fit diagnostic, `.cc:330`),
  2. RANSAC essential- or fundamental-matrix estimation
     (`estimate_two_view_info`),
  3. optional guided matching along epipolar lines (`.cc:157-168`),
  4. triangulate matches, gate on reprojection error and triangulation angle,
  5. two-view bundle adjustment and a final reprojection gate (`.cc:173-180`),
  6. the `TwoViewInfo` refreshed from the optimized cameras.

Stages 4-5 run batched over a leading pair axis (`refine_relative_pose_batch`,
which `FeatureMatcher` drives); `TwoViewMatchGeometricVerification` is the
single-pair API. A pair without a focal prior on both sides takes the
fundamental-matrix path with focal recovery; its guided rematch draws the
epipolar bands with the recovered focal lengths (`_prior_K`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..ba.two_view import _safe_div, bundle_adjust_two_views, triangulate_two_views
from ..ops.rotation import angle_axis_rotate_point, angle_axis_to_rotation_matrix, hat
from ..ransac import engine, estimators
from .reconstruction import CameraIntrinsicsPrior
from .two_view import (
    EstimateTwoViewInfoOptions,
    compute_resolution_scaled_threshold,
    estimate_two_view_info,
)

__all__ = [
    "TwoViewMatchGeometricVerificationOptions",
    "TwoViewMatchGeometricVerification",
    "fundamental_from_two_view_info",
    "triangulation_gate",
    "refine_relative_pose_batch",
]


@dataclasses.dataclass
class TwoViewMatchGeometricVerificationOptions:
    """Parity: `TwoViewMatchGeometricVerification::Options`
    (`two_view_match_geometric_verification.h:55-93`)."""

    estimate_twoview_info_options: EstimateTwoViewInfoOptions = dataclasses.field(
        default_factory=EstimateTwoViewInfoOptions
    )
    min_num_inlier_matches: int = 30
    guided_matching: bool = False
    guided_matching_max_distance_pixels: float = 2.0
    guided_matching_lowes_ratio: float = 0.8
    bundle_adjustment: bool = True
    triangulation_max_reprojection_error: float = 15.0
    min_triangulation_angle_degrees: float = 4.0
    final_max_reprojection_error: float = 5.0


def _prior_K(prior: CameraIntrinsicsPrior, focal_length: float | None = None) -> np.ndarray:
    """The intrinsics matrix of a view: `focal_length` if given, else the
    prior's (1.0 without one), and the prior's principal point (the image
    centre without one).

    The JAX package always takes the prior's focal length, so for a pair
    without focal priors it builds the guided rematch's F with f = 1 while
    the pose it draws the bands with is in units of the recovered focal
    lengths (ROADMAP.md, section 3). The port passes the recovered focal
    lengths (`TwoViewInfo.focal_length_1/2`) for such pairs; calibrated
    pairs keep the prior's."""
    f = focal_length or prior.focal_length or 1.0
    pp = prior.principal_point or (
        prior.image_width / 2.0,
        prior.image_height / 2.0,
    )
    return np.array([[f, 0.0, pp[0]], [0.0, f, pp[1]], [0.0, 0.0, 1.0]], np.float64)


def fundamental_from_two_view_info(rotation_aa, position, K1, K2):
    """F mapping image-1 pixels to epipolar lines in image 2.

    With camera 1 = [I|0] and camera 2 = (R, c) (c = camera-2 position in the
    camera-1 frame), E = R [c]_x and F = K2^{-T} E K1^{-1}. Leading batch
    axes broadcast.
    """
    E = angle_axis_to_rotation_matrix(rotation_aa) @ hat(position)
    return torch.linalg.inv(K2).mT @ E @ torch.linalg.inv(K1)


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def triangulation_gate(
    rotation_aa,
    position,
    n1,
    n2,
    mask,
    max_reproj_norm,
    min_angle_degrees,
):
    """Triangulate normalized correspondences under ([I|0], (R, c)) and gate
    on reprojection error and triangulation angle.

    Parity: `TwoViewMatchGeometricVerification::TriangulatePoints`
    (`two_view_match_geometric_verification.cc:186-236`).

    All args take leading batch axes. n1/n2 [.., N, 2] normalized coords;
    max_reproj_norm is the pixel threshold already divided by the focal
    length (a float or a tensor broadcasting against [.., N]).
    Returns (points3d [.., N, 3], keep_mask [.., N]).
    """
    X = triangulate_two_views(rotation_aa, position, n1, n2)
    one = torch.ones((), dtype=n1.dtype, device=n1.device)

    z1 = X[..., 2]
    ok_depth1 = z1 > 1e-8
    r1 = X[..., :2] / torch.where(ok_depth1, z1, one)[..., None] - n1
    Xc = angle_axis_rotate_point(rotation_aa[..., None, :], X - position[..., None, :])
    z2 = Xc[..., 2]
    ok_depth2 = z2 > 1e-8
    r2 = Xc[..., :2] / torch.where(ok_depth2, z2, one)[..., None] - n2

    max_r = _as(max_reproj_norm, n1)
    ok_reproj = (torch.sum(r1 * r1, -1) <= max_r**2) & (torch.sum(r2 * r2, -1) <= max_r**2)

    # Triangulation angle between the two observation rays.
    ray1 = X
    ray2 = X - position[..., None, :]
    cosang = torch.sum(ray1 * ray2, -1) / torch.clamp(
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1), min=1e-12
    )
    min_cos = torch.cos(torch.deg2rad(_as(min_angle_degrees, n1)))
    ok_angle = cosang <= min_cos

    keep = mask & ok_depth1 & ok_depth2 & ok_reproj & ok_angle
    return X, keep


def refine_relative_pose_batch(
    rotation_aa,
    position,
    n1,
    n2,
    mask,
    max_tri_reproj_norm,
    min_angle_degrees,
    final_reproj_norm,
    ba_iters: int = 15,
):
    """Batched stages 4+5: triangulation gate -> two-view BA -> final gate.

    All inputs carry a leading pair axis. Returns (rotation_aa, position,
    keep_mask), `keep_mask` the final verified correspondence mask per pair.
    """
    _, keep = triangulation_gate(
        rotation_aa, position, n1, n2, mask, max_tri_reproj_norm, min_angle_degrees
    )
    aa, pos, X, _cost = bundle_adjust_two_views(
        rotation_aa, position, n1, n2, mask=keep, iters=ba_iters
    )
    # Final reprojection gate on the bundle-adjusted points
    # (two_view_match_geometric_verification.cc:298-312).
    z1 = X[..., 2]
    r1 = X[..., :2] / _safe_div(z1)[..., None] - n1
    Xc = angle_axis_rotate_point(aa[..., None, :], X - pos[..., None, :])
    z2 = Xc[..., 2]
    r2 = Xc[..., :2] / _safe_div(z2)[..., None] - n2
    fr = _as(final_reproj_norm, n1)
    ok = (
        (torch.sum(r1 * r1, -1) <= fr**2)
        & (torch.sum(r2 * r2, -1) <= fr**2)
        & (z1 > 1e-8)
        & (z2 > 1e-8)
    )
    return aa, pos, keep & ok


class TwoViewMatchGeometricVerification:
    """Single-pair API. Parity: `theia::TwoViewMatchGeometricVerification`
    (`two_view_match_geometric_verification.h:105-122`).

    `device` is where the pair verifies: None means the CUDA card; pass
    "cpu" to run on the CPU.
    """

    def __init__(
        self,
        options: TwoViewMatchGeometricVerificationOptions,
        prior1: CameraIntrinsicsPrior,
        prior2: CameraIntrinsicsPrior,
        features1,  # KeypointsAndDescriptors
        features2,
        matches,  # list[(i, j)] indexed feature matches
        device=None,
    ):
        self.options = options
        self.prior1 = prior1
        self.prior2 = prior2
        self.features1 = features1
        self.features2 = features2
        self.matches = list(matches)
        self.device = default_device(device)

    def _correspondences(self, matches):
        i1 = np.array([m[0] for m in matches], np.int64)
        i2 = np.array([m[1] for m in matches], np.int64)
        return (
            np.asarray(self.features1.keypoints)[i1, :2],
            np.asarray(self.features2.keypoints)[i2, :2],
        )

    def count_homography_inliers(self, generator, c1, c2) -> int:
        """Parity: `CountHomographyInliers`
        (`two_view_match_geometric_verification.cc:330-366`)."""
        o = self.options.estimate_twoview_info_options
        e1 = compute_resolution_scaled_threshold(
            o.max_sampson_error_pixels, self.prior1.image_width, self.prior1.image_height
        )
        e2 = compute_resolution_scaled_threshold(
            o.max_sampson_error_pixels, self.prior2.image_width, self.prior2.image_height
        )
        params = engine.RansacParameters(
            failure_probability=1.0 - o.expected_ransac_confidence,
            min_iterations=o.min_ransac_iterations,
            max_iterations=o.max_ransac_iterations,
        )
        f32 = torch.float32
        _, summary = estimators.estimate_homography(
            generator,
            torch.as_tensor(c1, dtype=f32, device=self.device)[None],
            torch.as_tensor(c2, dtype=f32, device=self.device)[None],
            params,
            quality="mle" if o.use_mle else "inlier",
            error_thresh=torch.tensor([e1 * e2], dtype=f32, device=self.device),
        )
        return int(summary.num_inliers[0])

    def verify_matches(self, generator=None):
        """Returns (verified_matches list[(i, j)], TwoViewInfo) or None.

        Flow parity: `VerifyMatches`
        (`two_view_match_geometric_verification.cc:114-183`). `generator`
        (default: seeded with 0 on the device) draws the homography's RANSAC
        samples, then the essential (or fundamental) matrix's."""
        opt = self.options
        if len(self.matches) < opt.min_num_inlier_matches:
            return None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        c1, c2 = self._correspondences(self.matches)
        num_h_inliers = self.count_homography_inliers(generator, c1, c2)

        info, inlier_idx = estimate_two_view_info(
            generator,
            opt.estimate_twoview_info_options,
            self.prior1,
            self.prior2,
            c1,
            c2,
            min_num_inlier_matches=opt.min_num_inlier_matches,
            device=self.device,
        )
        if info is None:
            return None
        info.num_homography_inliers = num_h_inliers
        matches = [self.matches[i] for i in inlier_idx]

        f1 = info.focal_length_1 or 1.0
        f2 = info.focal_length_2 or 1.0
        calibrated = self.prior1.focal_length is not None and self.prior2.focal_length is not None
        K1 = _prior_K(self.prior1, None if calibrated else f1)
        K2 = _prior_K(self.prior2, None if calibrated else f2)

        if opt.guided_matching:
            from ..matching.guided_epipolar import GuidedEpipolarMatcher

            F = fundamental_from_two_view_info(
                *(torch.as_tensor(x) for x in (info.rotation_2, info.position_2, K1, K2))
            ).numpy()
            matcher = GuidedEpipolarMatcher(
                max_epipolar_distance=opt.guided_matching_max_distance_pixels,
                lowes_ratio=opt.guided_matching_lowes_ratio,
                device=self.device,
            )
            matches = matcher.get_matches(F, self.features1, self.features2, matches)

        if opt.bundle_adjustment and len(matches) > opt.min_num_inlier_matches:
            c1, c2 = self._correspondences(matches)
            n1 = (c1 - K1[:2, 2]) / f1
            n2 = (c2 - K2[:2, 2]) / f2
            geo_mean_f = float(np.sqrt(f1 * f2))

            def f32(x):
                return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

            aa, pos, keep = refine_relative_pose_batch(
                f32(info.rotation_2),
                f32(info.position_2),
                f32(n1),
                f32(n2),
                torch.ones(len(matches), dtype=torch.bool, device=self.device),
                opt.triangulation_max_reprojection_error / geo_mean_f,
                opt.min_triangulation_angle_degrees,
                opt.final_max_reprojection_error / geo_mean_f,
            )
            keep = keep.cpu().numpy()
            pos = pos.cpu().numpy().astype(np.float64)
            nrm = np.linalg.norm(pos)
            info.rotation_2 = aa.cpu().numpy().astype(np.float64)
            info.position_2 = pos / (nrm if nrm > 0 else 1.0)
            matches = [m for m, k in zip(matches, keep) if k]

        info.num_verified_matches = len(matches)
        if len(matches) <= opt.min_num_inlier_matches:
            return None
        return matches, info
