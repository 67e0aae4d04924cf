"""Two-view geometric verification: the calibrated batch.

Counterpart of the JAX package's `sfm/two_view.py`
(`theia/sfm/estimate_twoview_info.{h,cc}`, `estimate_twoview_info.cc:259`).
Calibrated pairs verify as one batched five-point RANSAC program over a
block of view pairs; `estimate_two_view_info` is the single-pair API over
the same batch. The uncalibrated path (fundamental matrix + focal recovery)
raises: its JAX reference fails (ROADMAP.md, "Faults found").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rotation as rotops
from ..ransac import engine, estimators
from .reconstruction import CameraIntrinsicsPrior
from .view_graph import TwoViewInfo
from .visibility_pyramid import visibility_score

__all__ = [
    "EstimateTwoViewInfoOptions",
    "estimate_two_view_info",
    "estimate_two_view_info_batch",
    "normalize_features_by_priors",
    "compute_resolution_scaled_threshold",
]

# Pairs verified per RANSAC program: bounds the [pairs, hypotheses, 10, ...]
# minimal-solver temporaries (about 3 MB per pair at 1000 hypotheses).
_PAIRS_PER_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class EstimateTwoViewInfoOptions:
    """Parity: `theia::EstimateTwoViewInfoOptions`
    (`estimate_twoview_info.h:51-81`)."""

    ransac_type: str = engine.RansacType.RANSAC
    max_sampson_error_pixels: float = 6.0
    expected_ransac_confidence: float = 0.9999
    min_ransac_iterations: int = 10
    max_ransac_iterations: int = 1000
    use_mle: bool = True
    use_lo: bool = False
    lo_start_iterations: int = 10
    min_focal_length: float = 1.0
    max_focal_length: float = 1e12


def compute_resolution_scaled_threshold(threshold, width, height):
    """Parity: `theia::ComputeResolutionScaledThreshold`: thresholds are
    given for a 1024px-wide image and scaled to the actual resolution."""
    max_dim = max(width, height)
    if max_dim <= 0:
        return threshold
    return threshold * max_dim / 1024.0


def normalize_features_by_priors(
    prior1: CameraIntrinsicsPrior, prior2: CameraIntrinsicsPrior, points1, points2
):
    """Parity: `NormalizeFeatures` (`estimate_twoview_info.cc:66-101`):
    remove the principal point and divide by the prior focal length (focal
    1.0 when either prior lacks one). Host numpy."""
    both_calibrated = (
        prior1.focal_length is not None and prior2.focal_length is not None
    )
    f1 = prior1.focal_length if both_calibrated else 1.0
    f2 = prior2.focal_length if both_calibrated else 1.0
    pp1 = prior1.principal_point or (
        prior1.image_width / 2.0,
        prior1.image_height / 2.0,
    )
    pp2 = prior2.principal_point or (
        prior2.image_width / 2.0,
        prior2.image_height / 2.0,
    )
    n1 = (np.asarray(points1) - np.asarray(pp1)) / f1
    n2 = (np.asarray(points2) - np.asarray(pp2)) / f2
    return n1, n2, both_calibrated


def _ransac_parameters(options: EstimateTwoViewInfoOptions):
    if options.ransac_type != engine.RansacType.RANSAC or options.use_lo:
        raise NotImplementedError(
            "estimate_two_view_info_batch has plain RANSAC only; PROSAC, "
            "LMed and LO-RANSAC are not yet ported (ROADMAP.md queue 1)"
        )
    return engine.RansacParameters(
        failure_probability=1.0 - options.expected_ransac_confidence,
        min_iterations=options.min_ransac_iterations,
        max_iterations=options.max_ransac_iterations,
        use_lo=options.use_lo,
    )


def estimate_two_view_info_batch(
    generator: torch.Generator,
    options: EstimateTwoViewInfoOptions,
    priors1,
    priors2,
    points1,
    points2,
    masks,
    min_num_inlier_matches: int = 5,
    device=None,
):
    """Verify a block of calibrated pairs in batched device programs.

    priors1/priors2: lists of CameraIntrinsicsPrior (len P).
    points1/points2 [P, N, 2] PIXEL coordinates (padded), masks [P, N].
    `generator` draws the RANSAC samples and lives on `device` (default:
    the generator's device). Verification runs in f32, as in the JAX
    package, in chunks of pairs.
    Returns a list of (TwoViewInfo | None, inlier_indices) per pair.
    """
    device = torch.device(device) if device is not None else generator.device
    P = len(priors1)
    n1 = np.zeros_like(np.asarray(points1, np.float64))
    n2 = np.zeros_like(np.asarray(points2, np.float64))
    thresh = np.zeros((P,), np.float64)
    for i in range(P):
        a, b, calibrated = normalize_features_by_priors(
            priors1[i], priors2[i], points1[i], points2[i]
        )
        if not calibrated:
            raise ValueError(
                "estimate_two_view_info_batch handles calibrated pairs only"
            )
        n1[i], n2[i] = a, b
        e1 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels,
            priors1[i].image_width,
            priors1[i].image_height,
        )
        e2 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels,
            priors2[i].image_width,
            priors2[i].image_height,
        )
        thresh[i] = e1 * e2 / (priors1[i].focal_length * priors2[i].focal_length)

    params = _ransac_parameters(options)
    quality = "mle" if options.use_mle else "inlier"
    f32 = torch.float32
    aa_all, pos_all, inl_all, num_all = [], [], [], []
    for s0 in range(0, P, _PAIRS_PER_CHUNK):
        sl = slice(s0, min(s0 + _PAIRS_PER_CHUNK, P))
        model, summary = estimators.estimate_relative_pose(
            generator,
            torch.as_tensor(n1[sl], dtype=f32, device=device),
            torch.as_tensor(n2[sl], dtype=f32, device=device),
            params,
            mask=torch.as_tensor(np.asarray(masks[sl]), device=device),
            quality=quality,
            error_thresh=torch.as_tensor(thresh[sl], dtype=f32, device=device),
        )
        aa_all.append(rotops.rotation_matrix_to_angle_axis(model.rotation))
        pos_all.append(model.position)
        inl_all.append(summary.inliers)
        num_all.append(summary.num_inliers)
    # One host copy per result set.
    aa = torch.cat(aa_all).cpu().numpy().astype(np.float64)
    position = torch.cat(pos_all).cpu().numpy().astype(np.float64)
    inliers = torch.cat(inl_all).cpu().numpy()
    num_inliers = torch.cat(num_all).cpu().numpy()

    results = []
    for i in range(P):
        if num_inliers[i] < min_num_inlier_matches:
            results.append((None, np.zeros((0,), np.int64)))
            continue
        idx = np.flatnonzero(inliers[i])
        info = TwoViewInfo(
            focal_length_1=float(priors1[i].focal_length),
            focal_length_2=float(priors2[i].focal_length),
            rotation_2=aa[i],
            position_2=position[i],
            num_verified_matches=int(num_inliers[i]),
            visibility_score=visibility_score(
                np.asarray(points1[i])[idx],
                priors1[i].image_width or 1024,
                priors1[i].image_height or 1024,
            )
            + visibility_score(
                np.asarray(points2[i])[idx],
                priors2[i].image_width or 1024,
                priors2[i].image_height or 1024,
            ),
        )
        results.append((info, idx))
    return results


def estimate_two_view_info(
    generator: torch.Generator,
    options: EstimateTwoViewInfoOptions,
    prior1: CameraIntrinsicsPrior,
    prior2: CameraIntrinsicsPrior,
    points1,
    points2,
    min_num_inlier_matches: int = 5,
    device=None,
):
    """Single-pair API. Parity: `theia::EstimateTwoViewInfo`
    (`estimate_twoview_info.cc:259`): pixel correspondences [N, 2] ->
    (TwoViewInfo | None, inlier_indices). Runs `estimate_two_view_info_batch`
    on a batch of one pair (f32, as the batch does); pairs without a focal
    prior on both sides raise `NotImplementedError`."""
    if prior1.focal_length is None or prior2.focal_length is None:
        raise NotImplementedError(
            "estimate_two_view_info: the uncalibrated (fundamental matrix) path "
            "is not ported yet; its JAX reference fails (ROADMAP.md, 'Faults found')"
        )
    points1 = np.asarray(points1, np.float64)[None]
    points2 = np.asarray(points2, np.float64)[None]
    return estimate_two_view_info_batch(
        generator, options, [prior1], [prior2], points1, points2,
        np.ones(points1.shape[:2], bool),
        min_num_inlier_matches=min_num_inlier_matches, device=device,
    )[0]
