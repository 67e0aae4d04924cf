"""The incremental SfM pipeline.

Counterpart of the JAX package's `sfm/incremental_estimator.py`
(`theia/sfm/incremental_reconstruction_estimator.{h,cc}`: `.h:81-141`, flow
`.cc:161-298`). The host orchestrates; localization (one batched RANSAC
over the candidate views), triangulation and bundle adjustment run on the
estimator's device, through the same layers as the global path. As in the
JAX package, each pass localizes the candidates within
`multiple_view_localization_ratio` of the best visibility score (capped at
the partial-BA window) in one RANSAC call, triangulates the union of their
tracks in one call and runs one partial or full BA.

After `estimate`, `localization_passes` counts the batched localization
calls, `bundle_adjustment_calls` the BA calls and `view_scoring_time` the
seconds spent ranking views by their visibility pyramids (part of the
summary's `pose_estimation_time`).
"""

from __future__ import annotations

import time

import numpy as np

from .. import default_device
from ..ba.entry import bundle_adjust_partial_reconstruction
from ..utils.log import logger
from .estimator_options import (
    ReconstructionEstimatorOptions,
    ReconstructionEstimatorSummary,
    set_bundle_adjustment_options,
    set_ransac_parameters,
)
from .localize import LocalizeViewToReconstructionOptions, localize_views_to_reconstruction_batch
from .reconstruction_estimator_utils import (
    num_estimated_tracks,
    num_estimated_views,
    set_outlier_tracks_to_unestimated,
    set_underconstrained_tracks_to_unestimated,
    set_underconstrained_views_to_unestimated,
)
from .select_tracks import select_good_tracks_for_bundle_adjustment
from .track_estimator import TrackEstimatorOptions, estimate_tracks
from .visibility_pyramid import VisibilityPyramid

__all__ = ["IncrementalReconstructionEstimator"]

kMinNumInitialTracks = 100  # incremental_reconstruction_estimator.cc:326
kMinNumObserved3dPoints = 30  # .cc:432
kNumPyramidLevels = 6  # .cc:433


class _GrowingEstimator:
    """What the incremental and hybrid estimators share: their options, the
    view ranking, structure estimation and the growth measure."""

    def __init__(self, options: ReconstructionEstimatorOptions | None = None, device=None):
        self.options = options or ReconstructionEstimatorOptions()
        self.device = default_device(device)
        self.localization_passes = 0
        self.bundle_adjustment_calls = 0
        self.view_scoring_time = 0.0

    def _start(self, view_graph, recon):
        opt = self.options
        self.recon = recon
        self.view_graph = view_graph
        self.summary = ReconstructionEstimatorSummary()
        self.reconstructed_views: list[int] = []
        self.num_optimized_views = 0
        self.localization_passes = 0
        self.bundle_adjustment_calls = 0
        self.view_scoring_time = 0.0
        self.triangulation_options = TrackEstimatorOptions(
            max_acceptable_reprojection_error_pixels=(
                opt.triangulation_max_reprojection_error_in_pixels
            ),
            min_triangulation_angle_degrees=opt.min_triangulation_angle_degrees,
            bundle_adjustment=opt.bundle_adjust_tracks,
            triangulation_method=opt.triangulation_method,
        )
        self.localization_options = LocalizeViewToReconstructionOptions(
            reprojection_error_threshold_pixels=opt.absolute_pose_reprojection_error_threshold,
            ransac_params=set_ransac_parameters(opt),
            min_num_inliers=opt.min_num_absolute_pose_inliers,
            pnp_type=int(opt.localization_pnp_type),
        )

    def _finish(self, t_start: float, name: str) -> ReconstructionEstimatorSummary:
        recon = self.recon
        self.summary.estimated_views = {int(v) for v in np.flatnonzero(recon.view_estimated)}
        self.summary.estimated_tracks = {int(t) for t in np.flatnonzero(recon.track_estimated)}
        self.summary.success = num_estimated_views(recon) >= 2 and num_estimated_tracks(recon) > 0
        self.summary.total_time = time.perf_counter() - t_start
        self.summary.message = (f"estimated {num_estimated_views(recon)} views, "
                                f"{num_estimated_tracks(recon)} tracks")
        logger.info("%s SfM: %s in %.3fs (pose %.3fs, triangulation %.3fs, BA %.3fs; %d "
                    "localization passes, %d BA calls)", name, self.summary.message,
                    self.summary.total_time, self.summary.pose_estimation_time,
                    self.summary.triangulation_time, self.summary.bundle_adjustment_time,
                    self.localization_passes, self.bundle_adjustment_calls)
        return self.summary

    def _find_views_to_localize(self) -> list[tuple[int, int]]:
        """Parity: `FindViewsToLocalize` (.cc:427-464): the unlocalized views
        that observe at least kMinNumObserved3dPoints estimated tracks, as
        (visibility-pyramid score, view) pairs, best first."""
        t0 = time.perf_counter()
        recon = self.recon
        scores = []
        for v in self.unlocalized_views:
            prior = recon.view_priors[v]
            pyramid = VisibilityPyramid(prior.image_width or 1024, prior.image_height or 768,
                                        kNumPyramidLevels)
            n = 0
            for t, r in recon._view_track_to_obs[v].items():
                if recon.track_estimated[t]:
                    n += 1
                    pyramid.add_point(recon.obs_uv[r])
            if n >= kMinNumObserved3dPoints:
                scores.append((pyramid.compute_score(), v))
        scores.sort(reverse=True)
        self.view_scoring_time += time.perf_counter() - t0
        return scores

    def _estimate_structure(self, track_ids):
        """Parity: `EstimateStructure` (.cc:465-474)."""
        estimate_tracks(self.recon, track_ids, self.triangulation_options, device=self.device)

    def _unoptimized_growth_percentage(self) -> float:
        """Parity: `UnoptimizedGrowthPercentage` (.cc:477)."""
        if self.num_optimized_views == 0:
            return 100.0
        return (100.0 * (len(self.reconstructed_views) - self.num_optimized_views)
                / self.num_optimized_views)

    def _bundle_adjust(self, views, tracks, num_views: int, **kw):
        self.bundle_adjustment_calls += 1
        return bundle_adjust_partial_reconstruction(
            set_bundle_adjustment_options(self.options, num_views), views, tracks, self.recon,
            device=self.device, **kw)

    def _remove_outlier_tracks(self, max_error_pixels: float, track_ids=None):
        return set_outlier_tracks_to_unestimated(
            self.recon, max_error_pixels, self.options.min_triangulation_angle_degrees,
            track_ids=track_ids, device=self.device)


class IncrementalReconstructionEstimator(_GrowingEstimator):
    """Parity: `theia::IncrementalReconstructionEstimator`
    (`incremental_reconstruction_estimator.h:81-141`). `device`: where the
    numeric stages run (None: the CUDA card)."""

    def estimate(self, view_graph, recon) -> ReconstructionEstimatorSummary:
        opt = self.options
        self._start(view_graph, recon)
        t_start = time.perf_counter()
        self.unlocalized_views = {v for v in view_graph.view_ids() if not recon.view_estimated[v]}

        t0 = time.perf_counter()
        recon.set_camera_intrinsics_from_priors()
        self.summary.camera_intrinsics_calibration_time = time.perf_counter() - t0

        # Steps 1-3: the initial pair (.cc:186-199).
        if (num_estimated_tracks(recon) < opt.min_num_absolute_pose_inliers
                or num_estimated_views(recon) < 2):
            if not self._choose_initial_view_pair():
                self.summary.success = False
                self.summary.message = "no suitable initial pair"
                return self.summary
        else:
            self.reconstructed_views = [int(v) for v in np.flatnonzero(recon.view_estimated)]
            self.unlocalized_views -= set(self.reconstructed_views)
            self.num_optimized_views = len(self.reconstructed_views)

        # Steps 4-6: localize -> triangulate -> BA (.cc:205-298), one
        # batched localization of the best candidates a pass.
        views_to_localize: list[int] = []
        failed = -1
        while self.unlocalized_views and failed != len(views_to_localize):
            failed = 0
            t0 = time.perf_counter()
            scored = self._find_views_to_localize()
            self.summary.pose_estimation_time += time.perf_counter() - t0
            if not scored:
                break
            cutoff = scored[0][0] * opt.multiple_view_localization_ratio
            batch = [v for s, v in scored if s >= cutoff]
            views_to_localize = batch[: max(1, opt.partial_bundle_adjustment_num_views)]
            logger.info("localizing %d candidate views in one call (%d unlocalized)",
                        len(views_to_localize), len(self.unlocalized_views))
            t0 = time.perf_counter()
            self.localization_passes += 1
            localized = localize_views_to_reconstruction_batch(
                views_to_localize, self.localization_options, recon, device=self.device)
            self.summary.pose_estimation_time += time.perf_counter() - t0
            failed = len(views_to_localize) - len(localized)
            if not localized:
                continue
            new_views = list(localized)
            self.reconstructed_views.extend(new_views)
            self.unlocalized_views -= set(new_views)

            # Outlier tracks seen in the new views (.cc:236-246).
            tracks_new: set[int] = set()
            for v in new_views:
                tracks_new.update(recon.tracks_in_view(v))
            self._remove_outlier_tracks(
                self.triangulation_options.max_acceptable_reprojection_error_pixels, tracks_new)

            t0 = time.perf_counter()
            self._estimate_structure(tracks_new)
            self.summary.triangulation_time += time.perf_counter() - t0

            t0 = time.perf_counter()
            if self._unoptimized_growth_percentage() < opt.full_bundle_adjustment_growth_percent:
                self._partial_bundle_adjustment()
            else:
                self._full_bundle_adjustment()
                set_underconstrained_tracks_to_unestimated(recon)
                set_underconstrained_views_to_unestimated(recon)
            self.summary.bundle_adjustment_time += time.perf_counter() - t0

        # Final full BA and pruning.
        t0 = time.perf_counter()
        self._full_bundle_adjustment()
        set_underconstrained_tracks_to_unestimated(recon)
        set_underconstrained_views_to_unestimated(recon)
        self.summary.bundle_adjustment_time += time.perf_counter() - t0
        return self._finish(t_start, "incremental")

    def _choose_initial_view_pair(self) -> bool:
        """Parity: `ChooseInitialViewPair` (.cc:325-384): candidates ordered
        by (fewest homography inliers, most verified matches); a pair is
        taken when its two-view triangulation gives enough tracks and BA
        succeeds."""
        recon = self.recon
        candidates = sorted(
            (info.num_homography_inliers, -info.num_verified_matches, (i, j))
            for (i, j), info in self.view_graph.edges.items()
            if info.num_verified_matches > kMinNumInitialTracks
        )
        for _, _, (i, j) in candidates:
            recon.view_estimated[:] = False
            recon.track_estimated[:] = False
            self._initialize_cameras_from_two_view_info(i, j)
            self._estimate_structure(recon.tracks_in_view(i))
            if num_estimated_tracks(recon) < kMinNumInitialTracks:
                continue
            if not self._full_bundle_adjustment():
                continue
            if num_estimated_tracks(recon) > kMinNumInitialTracks:
                self.reconstructed_views = [i, j]
                self.unlocalized_views.discard(i)
                self.unlocalized_views.discard(j)
                return True
        return False

    def _initialize_cameras_from_two_view_info(self, v1: int, v2: int):
        """Parity: `InitializeCamerasFromTwoViewInfo` (.cc:305-323)."""
        recon = self.recon
        info = self.view_graph.get_edge(v1, v2)
        recon.view_extrinsics[v1] = 0.0
        recon.view_extrinsics[v2, :3] = info.position_2
        recon.view_extrinsics[v2, 3:] = info.rotation_2
        if info.focal_length_1 > 0:
            recon.intrinsics[recon.view_group[v1]][0] = info.focal_length_1
        if info.focal_length_2 > 0:
            recon.intrinsics[recon.view_group[v2]][0] = info.focal_length_2
        recon.view_estimated[v1] = True
        recon.view_estimated[v2] = True

    def _select_tracks(self, views) -> set[int]:
        opt, recon = self.options, self.recon
        if opt.subsample_tracks_for_bundle_adjustment:
            return select_good_tracks_for_bundle_adjustment(
                recon, views, opt.track_subset_selection_long_track_length_threshold,
                opt.track_selection_image_grid_cell_size_pixels,
                opt.min_num_optimized_tracks_per_view, device=self.device)
        return {t for v in views for t in recon.tracks_in_view(v) if recon.track_estimated[t]}

    def _full_bundle_adjustment(self) -> bool:
        """Parity: `FullBundleAdjustment` (.cc:482-518)."""
        views = [int(v) for v in np.flatnonzero(self.recon.view_estimated)]
        summary = self._bundle_adjust(views, self._select_tracks(views),
                                      len(self.reconstructed_views))
        self.num_optimized_views = len(self.reconstructed_views)
        self._remove_outlier_tracks(self.options.max_reprojection_error_in_pixels)
        return bool(summary.success)

    def _partial_bundle_adjustment(self) -> bool:
        """Parity: `PartialBundleAdjustment` (.cc:521-577): the k most
        recently added views."""
        k = min(len(self.reconstructed_views), self.options.partial_bundle_adjustment_num_views)
        views = self.reconstructed_views[-k:]
        return bool(self._bundle_adjust(views, self._select_tracks(views), k).success)
