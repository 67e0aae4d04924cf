"""Images -> features -> matches -> reconstruction, end to end.

Counterpart of the JAX package's `pipelines/images.py`, the canonical
pipeline of the reference (`pytests/sfm_pipeline.py:175-287`,
`pyexamples/sfm_pipeline_fountain.py:25-60`): images are read on the host,
features extracted on the device by the port's SIFT (`features/sift.py`),
matched (K1) and geometrically verified in batched programs, and fed
through `ReconstructionBuilder` into the global estimator, all on one
device.
"""

from __future__ import annotations

import numpy as np

from .. import default_device
from ..utils.log import logger

__all__ = ["run_images_pipeline"]


def _prior_for(path, shape, exif_reader=None):
    from ..sfm.reconstruction import CameraIntrinsicsPrior

    H, W = shape
    if exif_reader is not None and path.lower().endswith((".jpg", ".jpeg")):
        try:
            prior = exif_reader.extract_exif_metadata(path)
            if prior is not None and prior.focal_length:
                # Rescale EXIF intrinsics to the (possibly resized) shape.
                s = W / max(prior.image_width, 1)
                return CameraIntrinsicsPrior(
                    image_width=W,
                    image_height=H,
                    focal_length=prior.focal_length * s,
                    principal_point=(W / 2.0, H / 2.0),
                )
        except Exception:  # unreadable EXIF, or no PIL: the default below
            pass
    # Reference default when EXIF is absent: 1.2 * max dimension
    # (set_camera_intrinsics_from_priors.cc).
    return CameraIntrinsicsPrior(
        image_width=W,
        image_height=H,
        focal_length=1.2 * max(W, H),
        principal_point=(W / 2.0, H / 2.0),
    )


def run_images_pipeline(
    image_paths,
    max_dim: int = 1024,
    max_features: int = 2048,
    estimator_type: str = "global",
    lowes_ratio: float = 0.8,
    min_num_inlier_matches: int = 30,
    use_exif: bool = True,
    seed: int = 0,
    pair_preselection_neighbors: int | None = None,
    matcher_seed: int = 0,
    device=None,
    profile: bool = False,
):
    """Full pipeline over a list of image paths on `device` (None: the CUDA
    card).

    Returns (models, stats): reconstructed models (list of Reconstruction)
    and a dict of per-phase timings (host clock, each phase ending in a
    device synchronize) and counts, the JAX package's keys. With `profile`,
    each phase also runs under `torch.profiler`, and `stats["launches"]` /
    `stats["device_seconds"]` give its kernel launches and their device
    time by phase ("extract", "match_verify", "reconstruct").

    `matcher_seed` seeds the generator of the matcher's RANSAC draws (the
    JAX package's matcher uses `PRNGKey(0)`; `seed` is the estimator's, as
    there).

    `pair_preselection_neighbors`: when set, candidate pairs are chosen by
    a k-NN graph over global image descriptors (L2-normalized mean-pooled
    local descriptors) instead of all pairs: the reference's
    `FeatureExtractorAndMatcher` + GraphMatch orchestration
    (`feature_extractor_and_matcher.h:55-138`, `graph_match.h:63`).
    """
    from ..features import SiftParams, detect_and_describe, load_grayscale
    from ..matching.matcher import FeatureMatcher
    from ..matching.options import FeatureMatcherOptions
    from ..sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from ..sfm.exif_reader import ExifReader
    from ..sfm.reconstruction_builder import (
        ReconstructionBuilder,
        ReconstructionBuilderOptions,
    )
    from ..utils.timing import StageTimer

    device = default_device(device)
    timer = StageTimer(device, profile)
    est_type = {
        "global": ReconstructionEstimatorType.GLOBAL,
        "incremental": ReconstructionEstimatorType.INCREMENTAL,
        "hybrid": ReconstructionEstimatorType.HYBRID,
    }[estimator_type]

    stats = {}
    exif = ExifReader() if use_exif else None
    sift = SiftParams(max_features_per_octave=max(max_features // 2, 256))

    mopt = FeatureMatcherOptions(
        lowes_ratio=lowes_ratio,
        min_num_feature_matches=min_num_inlier_matches,
        max_num_features=max_features,
        perform_geometric_verification=True,
    )
    mopt.geometric_verification_options.min_num_inlier_matches = min_num_inlier_matches
    # Guided epipolar rematch recovers correspondences the ratio test was
    # too conservative for: the composed stage 2 of the reference's
    # verification (two_view_match_geometric_verification.cc:157-168).
    mopt.geometric_verification_options.guided_matching = True
    matcher = FeatureMatcher(mopt, device=device, seed=matcher_seed)
    bopt = ReconstructionBuilderOptions(
        min_num_inlier_matches=min_num_inlier_matches,
        reconstruction_estimator_options=ReconstructionEstimatorOptions(
            reconstruction_estimator_type=est_type, rng_seed=seed
        ),
    )
    builder = ReconstructionBuilder(bopt, device=device)

    n_feats = []
    names = []
    global_descs = []
    with timer("extract"):
        for path in image_paths:
            name = str(path).rsplit("/", 1)[-1]
            img = load_grayscale(str(path), max_dim=max_dim)
            kp, _scales, desc, _resp = detect_and_describe(img, sift, device=device)
            kp, desc = kp[:max_features], desc[:max_features]
            n_feats.append(len(kp))
            prior = _prior_for(str(path), img.shape, exif)
            matcher.add_image(name, kp, desc, intrinsics_prior=prior)
            builder.add_image_with_camera_intrinsics_prior(name, prior)
            names.append(name)
            if pair_preselection_neighbors:
                g = desc.mean(axis=0) if len(desc) else np.zeros(128, np.float32)
                global_descs.append(g / max(np.linalg.norm(g), 1e-12))
            logger.info("extracted %d features from %s", len(kp), name)
    stats["t_extract_s"] = timer.seconds["extract"]
    stats["features_per_image"] = n_feats

    if pair_preselection_neighbors:
        from ..matching.graph_match import graph_match

        idx_pairs = graph_match(
            np.asarray(global_descs), pair_preselection_neighbors, device=device
        )
        matcher.set_image_pairs_to_match([(names[i], names[j]) for i, j in idx_pairs])
        stats["preselected_pairs"] = len(idx_pairs)
        logger.info(
            "pair preselection: %d/%d candidate pairs",
            len(idx_pairs), len(names) * (len(names) - 1) // 2,
        )

    with timer("match_verify"):
        n_pairs = builder.match_features(matcher)
    stats["t_match_verify_s"] = timer.seconds["match_verify"]
    stats["verified_pairs"] = n_pairs

    with timer("reconstruct"):
        models = builder.build_reconstruction()
    stats["t_reconstruct_s"] = timer.seconds["reconstruct"]
    stats["models"] = len(models)
    stats["views_estimated"] = sum(int(np.sum(m.view_estimated)) for m in models)
    stats["tracks_estimated"] = sum(int(np.sum(m.track_estimated)) for m in models)
    if profile:
        stats["launches"] = timer.launches
        stats["device_seconds"] = timer.device_seconds
    return models, stats
