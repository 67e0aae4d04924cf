"""The hybrid SfM pipeline (HSfM, Cui et al. CVPR'17).

Counterpart of the JAX package's `sfm/hybrid_estimator.py`
(`theia/sfm/hybrid_reconstruction_estimator.{h,cc}`, `.h:55-134`): global
rotation averaging fixes every camera's orientation, then the positions
grow incrementally: position-only (2-point) localization with a full-pose
fallback, one view at a time, triangulation after each, and bundle
adjustment with the orientations constant until the final pass.

After `estimate`, `localization_passes` counts the localization calls
(one a view tried, two where the fallback runs), `bundle_adjustment_calls`
the BA calls and `view_scoring_time` the seconds spent ranking views by
their visibility pyramids.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..global_pose import rotation_estimator as rot_est
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np
from ..utils.log import logger
from .estimator_options import ReconstructionEstimatorSummary
from .incremental_estimator import _GrowingEstimator, kMinNumInitialTracks
from .localize import localize_view_to_reconstruction
from .reconstruction_estimator_utils import (
    num_estimated_tracks,
    set_underconstrained_tracks_to_unestimated,
    set_underconstrained_views_to_unestimated,
)

__all__ = ["HybridReconstructionEstimator"]


class HybridReconstructionEstimator(_GrowingEstimator):
    """Parity: `theia::HybridReconstructionEstimator`
    (`hybrid_reconstruction_estimator.h:86`). `device`: where the numeric
    stages run (None: the CUDA card). The global rotations come from
    `global_pose.rotation_estimator.estimate_rotations`, of any of its five
    types (`global_rotation_estimator_type`)."""

    def estimate(self, view_graph, recon) -> ReconstructionEstimatorSummary:
        opt = self.options
        self._start(view_graph, recon)
        t_start = time.perf_counter()
        recon.set_camera_intrinsics_from_priors()

        # Step 1: global camera orientations (`EstimateCameraOrientations`,
        # hybrid_reconstruction_estimator.cc:309).
        t0 = time.perf_counter()
        self.orientations = rot_est.estimate_rotations(
            view_graph, int(opt.global_rotation_estimator_type), device=self.device)
        for v, aa in self.orientations.items():
            recon.view_extrinsics[v, 3:] = np.asarray(aa)
        self.summary.pose_estimation_time += time.perf_counter() - t0
        logger.info("hybrid: %d global orientations in %.3fs", len(self.orientations),
                    self.summary.pose_estimation_time)

        self.unlocalized_views = {v for v in view_graph.view_ids() if not recon.view_estimated[v]}

        # Steps 2-3: the seed pair, its positions in the global-rotation frame.
        if not self._choose_initial_view_pair():
            self.summary.success = False
            self.summary.message = "no suitable initial pair"
            logger.warning("hybrid SfM aborted: no suitable initial pair")
            return self.summary

        # Steps 4-7: localize the positions one view at a time.
        views_to_localize: list[int] = []
        failed = -1
        while self.unlocalized_views and failed != len(views_to_localize):
            failed = 0
            t0 = time.perf_counter()
            views_to_localize = [v for _, v in self._find_views_to_localize()]
            self.summary.pose_estimation_time += time.perf_counter() - t0
            if not views_to_localize:
                break
            for v in views_to_localize:
                t0 = time.perf_counter()
                ok = self._localize_view(v)
                self.summary.pose_estimation_time += time.perf_counter() - t0
                if not ok:
                    failed += 1
                    continue
                self.reconstructed_views.append(v)
                self.unlocalized_views.discard(v)

                t0 = time.perf_counter()
                self._estimate_structure(recon.tracks_in_view(v))
                self.summary.triangulation_time += time.perf_counter() - t0

                t0 = time.perf_counter()
                if (self._unoptimized_growth_percentage()
                        >= opt.full_bundle_adjustment_growth_percent):
                    self._hybrid_bundle_adjust(full=True)
                    set_underconstrained_tracks_to_unestimated(recon)
                    set_underconstrained_views_to_unestimated(recon)
                else:
                    self._hybrid_bundle_adjust(full=False)
                self.summary.bundle_adjustment_time += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._hybrid_bundle_adjust(full=True, final=True)
        set_underconstrained_tracks_to_unestimated(recon)
        set_underconstrained_views_to_unestimated(recon)
        self.summary.bundle_adjustment_time += time.perf_counter() - t0
        return self._finish(t_start, "hybrid")

    def _choose_initial_view_pair(self) -> bool:
        """Parity: `ChooseInitialViewPair` + `InitializeCamerasFromTwoViewInfo`
        (hybrid_reconstruction_estimator.cc): the positions seeded in the
        frame of the global orientations (the relative position rotates by
        R_1^T into the world)."""
        recon = self.recon
        candidates = sorted(
            (info.num_homography_inliers, -info.num_verified_matches, (i, j))
            for (i, j), info in self.view_graph.edges.items()
            if info.num_verified_matches > kMinNumInitialTracks
            and i in self.orientations and j in self.orientations
        )
        for _, _, (i, j) in candidates:
            recon.view_estimated[:] = False
            recon.track_estimated[:] = False
            info = self.view_graph.get_edge(i, j)
            R1 = angle_axis_to_rotation_matrix_np(self.orientations[i])
            recon.view_extrinsics[i, :3] = 0.0
            recon.view_extrinsics[i, 3:] = self.orientations[i]
            recon.view_extrinsics[j, :3] = R1.T @ np.asarray(info.position_2)
            recon.view_extrinsics[j, 3:] = self.orientations[j]
            recon.view_estimated[i] = True
            recon.view_estimated[j] = True

            self._estimate_structure(recon.tracks_in_view(i))
            if num_estimated_tracks(recon) < kMinNumInitialTracks:
                continue
            if not self._hybrid_bundle_adjust(full=True):
                continue
            if num_estimated_tracks(recon) > kMinNumInitialTracks:
                self.reconstructed_views = [i, j]
                self.unlocalized_views.discard(i)
                self.unlocalized_views.discard(j)
                return True
        return False

    def _localize_view(self, view_id: int) -> bool:
        """Parity: `LocalizeView` (.cc:285-306): position only first (the
        orientation is known from rotation averaging), the full pose as a
        fallback."""
        if view_id in self.orientations:
            self.recon.view_extrinsics[view_id, 3:] = self.orientations[view_id]
            opts = dataclasses.replace(self.localization_options, assume_known_orientation=True,
                                       bundle_adjust_view=False)
            self.localization_passes += 1
            ok, _ = localize_view_to_reconstruction(view_id, opts, self.recon,
                                                    device=self.device)
            if ok:
                return True
        opts = dataclasses.replace(self.localization_options, assume_known_orientation=False)
        self.localization_passes += 1
        ok, _ = localize_view_to_reconstruction(view_id, opts, self.recon, device=self.device)
        return ok

    def _hybrid_bundle_adjust(self, full: bool, final: bool = False) -> bool:
        """BA with the orientations constant; the final pass frees the full
        poses (the reference's last full BA refines everything)."""
        opt, recon = self.options, self.recon
        if full:
            views = [int(v) for v in np.flatnonzero(recon.view_estimated)]
            self.num_optimized_views = len(self.reconstructed_views)
        else:
            k = min(len(self.reconstructed_views), opt.partial_bundle_adjustment_num_views)
            views = self.reconstructed_views[-k:]
        tracks = {t for v in views for t in recon.tracks_in_view(v) if recon.track_estimated[t]}
        summary = self._bundle_adjust(views, tracks, len(views), orientation_constant=not final)
        if full:
            self._remove_outlier_tracks(opt.max_reprojection_error_in_pixels)
        return bool(summary.success)
