"""Two-view geometric verification.

Counterpart of the JAX package's `sfm/two_view.py`
(`theia/sfm/estimate_twoview_info.{h,cc}`, `estimate_twoview_info.cc:259`).
Paths (estimate_twoview_info.h:84-96): pairs with a focal prior on both
sides verify by five-point RANSAC on the essential matrix, batched over a
block of pairs (`estimate_two_view_info_batch`); the others by the 8-point
fundamental matrix with focal recovery (`estimate_uncalibrated_two_view_info_batch`,
each pair the single-pair function of its rows). `estimate_two_view_info`
is the single-pair API over both.
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
    "estimate_uncalibrated_two_view_info_batch",
    "make_batched_verifier",
    "normalize_features_by_priors",
    "compute_resolution_scaled_threshold",
]

# Pairs verified per RANSAC program at up to 1000 hypotheses: bounds the
# [pairs, hypotheses, 10, ...] minimal-solver temporaries (about 3 MB per
# pair at 1000 hypotheses). Below 1000 hypotheses a program takes
# proportionally more pairs (`_pairs_per_chunk`), the same bound.
_PAIRS_PER_CHUNK = 64


def _pairs_per_chunk(max_iterations: int) -> int:
    return max(_PAIRS_PER_CHUNK, _PAIRS_PER_CHUNK * 1000 // max(max_iterations, 1))


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


def _ransac_parameters(options: EstimateTwoViewInfoOptions, sampler: str = "random"):
    return engine.RansacParameters(
        failure_probability=1.0 - options.expected_ransac_confidence,
        min_iterations=options.min_ransac_iterations,
        max_iterations=options.max_ransac_iterations,
        use_lo=options.use_lo,
        sampler=sampler,
    )


def _single_pair_parameters(options: EstimateTwoViewInfoOptions):
    """The single-pair API's parameters: PROSAC when asked for
    (`estimate_twoview_info.cc`); the batch draws at random whatever
    `ransac_type` says, as the JAX package's batch does."""
    prosac = options.ransac_type == engine.RansacType.PROSAC
    return _ransac_parameters(options, "prosac" if prosac else "random")


def _thresholds(options, priors1, priors2, calibrated: bool):
    """Per-pair squared Sampson thresholds: the resolution-scaled pixel
    bounds of both images, divided by both focal lengths when calibrated."""
    out = np.zeros((len(priors1),), np.float64)
    for i, (p1, p2) in enumerate(zip(priors1, priors2)):
        e1 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels, p1.image_width, p1.image_height
        )
        e2 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels, p2.image_width, p2.image_height
        )
        out[i] = e1 * e2 / (p1.focal_length * p2.focal_length) if calibrated else e1 * e2
    return out


def _normalized(priors1, priors2, points1, points2, calibrated: bool):
    """`normalize_features_by_priors` over a batch of pairs, each required
    to be calibrated (or, with calibrated=False, not)."""
    n1 = np.zeros_like(np.asarray(points1, np.float64))
    n2 = np.zeros_like(np.asarray(points2, np.float64))
    for i in range(len(priors1)):
        a, b, both = normalize_features_by_priors(priors1[i], priors2[i], points1[i], points2[i])
        if both != calibrated:
            raise ValueError(
                "estimate_two_view_info_batch handles calibrated pairs only"
                if calibrated else "a pair with focal priors on both sides is calibrated"
            )
        n1[i], n2[i] = a, b
    return n1, n2


def _visibility(info, idx, points1, points2, prior1, prior2):
    """Visibility score over the inlier pixels (estimate_twoview_info.cc
    ComputeVisibilityScoreOfInliers, 12 levels over both images)."""
    info.visibility_score = visibility_score(
        np.asarray(points1)[idx], prior1.image_width or 1024, prior1.image_height or 1024
    ) + visibility_score(
        np.asarray(points2)[idx], prior2.image_width or 1024, prior2.image_height or 1024
    )
    return info


def _stage1(estimate, params, quality, generator, points1, points2, mask, thresh,
            num_data=None):
    """`estimate` over a block of pairs in chunks of `_pairs_per_chunk`
    pairs, drawing from `generator` chunk by chunk. Returns the rotation
    angle-axis [P, 3], position [P, 3], inliers [P, N] and num_inliers [P],
    with the focal lengths [P] of both views for an uncalibrated estimate
    (`num_data` given)."""
    chunk = _pairs_per_chunk(params.max_iterations)
    parts = []
    for s0 in range(0, len(points1), chunk):
        sl = slice(s0, min(s0 + chunk, len(points1)))
        model, summary = estimate(
            generator, points1[sl], points2[sl], params, mask=mask[sl], quality=quality,
            error_thresh=thresh[sl], num_data=None if num_data is None else num_data[sl],
        )
        row = [rotops.rotation_matrix_to_angle_axis(model.rotation), model.position,
               summary.inliers, summary.num_inliers]
        if num_data is not None:
            row += [model.focal_length1, model.focal_length2]
        parts.append(row)
    return [torch.cat(p) for p in zip(*parts)]


def make_batched_verifier(params: engine.RansacParameters, quality: str = "mle"):
    """Build a batched calibrated verifier over P pairs.

    `run(generator, points1, points2, mask, thresh)` takes normalized
    coordinates [P, N, 2], mask [P, N] and squared Sampson thresholds [P]
    and returns per pair (rotation angle-axis [P, 3], position [P, 3],
    inliers [P, N], num_inliers [P]) on the inputs' device: the five-point
    relative pose under RANSAC, in chunks of `_pairs_per_chunk` pairs, with
    samples from `generator` (on the inputs' device). Stage 1 of
    `estimate_two_view_info_batch` is this function.
    """

    def run(generator, points1, points2, mask, thresh):
        if not len(points1):
            empty = points1.new_zeros((0, 3))
            return empty, empty, mask.bool(), torch.zeros(0, dtype=torch.int64, device=mask.device)
        return tuple(_stage1(estimators.estimate_relative_pose, params, quality, generator,
                             points1, points2, mask, thresh))

    return run


def _verify(calibrated: bool, params, generator, options, priors1, priors2, points1, points2,
            masks, min_num_inlier_matches, device):
    """Stage 1 over a block of pairs of one kind, in f32 and chunks of pairs
    (`_pairs_per_chunk`): the five-point relative pose for calibrated pairs
    (`make_batched_verifier`), the uncalibrated relative pose (each pair
    over its true count) for the others. Returns a list of (TwoViewInfo |
    None, inlier_indices)."""
    n1, n2 = _normalized(priors1, priors2, points1, points2, calibrated)
    thresh = _thresholds(options, priors1, priors2, calibrated)
    masks = np.asarray(masks)
    quality = "mle" if options.use_mle else "inlier"
    f32 = torch.float32
    inputs = (
        torch.as_tensor(n1, dtype=f32, device=device),
        torch.as_tensor(n2, dtype=f32, device=device),
        torch.as_tensor(masks, device=device),
        torch.as_tensor(thresh, dtype=f32, device=device),
    )
    if calibrated:
        verified = make_batched_verifier(params, quality)(generator, *inputs)
    else:
        verified = _stage1(estimators.estimate_uncalibrated_relative_pose, params, quality,
                           generator, *inputs,
                           num_data=torch.as_tensor(masks.sum(-1), device=device))
    parts = dict(zip(("aa", "position", "inliers", "num", "f1", "f2"), verified))
    # One host copy per result set.
    host = {k: v.cpu().numpy() for k, v in parts.items()}

    results = []
    for i, (p1, p2) in enumerate(zip(priors1, priors2)):
        if host["num"][i] < min_num_inlier_matches:
            results.append((None, np.zeros((0,), np.int64)))
            continue
        if calibrated:
            f1, f2 = float(p1.focal_length), float(p2.focal_length)
        else:
            # The JAX function's wrapper indexes these scalars with a leading
            # axis they do not have and fails (ROADMAP.md, section 3); this is
            # what it plainly means.
            lo, hi = options.min_focal_length, options.max_focal_length
            f1 = float(np.clip(host["f1"][i], lo, hi))
            f2 = float(np.clip(host["f2"][i], lo, hi))
        idx = np.flatnonzero(host["inliers"][i])
        info = TwoViewInfo(
            focal_length_1=f1,
            focal_length_2=f2,
            rotation_2=host["aa"][i].astype(np.float64),
            position_2=host["position"][i].astype(np.float64),
            num_verified_matches=int(host["num"][i]),
        )
        results.append((_visibility(info, idx, points1[i], points2[i], p1, p2), idx))
    return results


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
    package, in chunks of pairs. As the JAX package's batch, it draws at
    random whatever `options.ransac_type` says and honours `use_lo`; a
    pair without a focal prior on both sides raises `ValueError`.
    Returns a list of (TwoViewInfo | None, inlier_indices) per pair.
    """
    device = torch.device(device) if device is not None else generator.device
    return _verify(True, _ransac_parameters(options), generator, options, priors1, priors2,
                   points1, points2, masks, min_num_inlier_matches, device)


def estimate_uncalibrated_two_view_info_batch(
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
    """The uncalibrated path of `estimate_two_view_info`
    (`estimate_twoview_info.cc:259`, fundamental matrix + focal recovery)
    over a block of pairs that lack a focal prior on one side or both:
    each pair gets the single-pair function of its own rows (the sampler
    from `options.ransac_type`, PROSAC's prefix and the inlier ratio over
    its true count), in f32 and chunks of pairs, with samples from
    `generator`. points1/points2 [P, N, 2] PIXEL coordinates (padded),
    masks [P, N] (each pair's rows first). The focal lengths are clipped
    to [min_focal_length, max_focal_length]. Returns a list of
    (TwoViewInfo | None, inlier_indices) per pair.
    """
    device = torch.device(device) if device is not None else generator.device
    return _verify(False, _single_pair_parameters(options), generator, options, priors1,
                   priors2, points1, points2, masks, min_num_inlier_matches, device)


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
    (TwoViewInfo | None, inlier_indices), in f32 as the JAX function runs
    without x64. Pairs with a focal prior on both sides take the calibrated
    path (five-point essential matrix), the others the uncalibrated one
    (`estimate_uncalibrated_two_view_info_batch`). PROSAC is used when
    `options.ransac_type` asks for it, LO-RANSAC when `options.use_lo`."""
    device = torch.device(device) if device is not None else generator.device
    points1 = np.asarray(points1, np.float64)[None]
    points2 = np.asarray(points2, np.float64)[None]
    masks = np.ones(points1.shape[:2], bool)
    calibrated = prior1.focal_length is not None and prior2.focal_length is not None
    return _verify(calibrated, _single_pair_parameters(options), generator, options, [prior1],
                   [prior2], points1, points2, masks, min_num_inlier_matches, device)[0]
