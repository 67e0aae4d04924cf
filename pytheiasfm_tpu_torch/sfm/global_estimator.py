"""The global SfM pipeline.

Counterpart of the JAX package's `sfm/global_estimator.py`
(`theia/sfm/global_reconstruction_estimator.{h,cc}`, steps 1-9 at
`global_reconstruction_estimator.cc:142-271`). The host orchestrates; every
numeric stage runs on the estimator's device: rotation averaging (L1 +
IRLS), the orientation and 1DSfM filters, pairwise translations, LUD
positions, track triangulation, bundle adjustment (the iterative Schur at
the reference-default options, the dense Schur with constant intrinsics)
with outlier removal and retriangulation.

Steps 1-7 (`_estimate_poses`) are also what `tools/global_pose.py` runs and
times stage by stage. Every rotation and position estimator type of the
JAX package runs, and the maximal parallel-rigid subgraph
(`extract_maximal_rigid_subgraph`).

With `options.mesh` (every rank runs `estimate` on the same graph and
container) the rotations, the positions, the triangulation and bundle
adjustment shard over the mesh, as the JAX package passes its mesh to them
(`:94`, `:153`, `:336`); the rest runs on every rank, and after the filters
of steps 4-6 every rank takes rank 0's view graph and orientations, so that
the sharded stages start from the same bits on every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..parallel.sharding import mesh_axis
from ..ba.entry import bundle_adjust_partial_reconstruction, bundle_adjust_reconstruction
from ..global_pose import filters
from ..global_pose import position_estimator as pos_est
from ..global_pose import rotation_estimator as rot_est
from ..global_pose.pairwise_translation import (
    optimize_relative_positions_with_known_rotations,
)
from ..models import camera as cam
from ..utils.log import logger
from ..utils.timing import StageTimer
from .estimator_options import (
    ReconstructionEstimatorOptions,
    ReconstructionEstimatorSummary,
    set_bundle_adjustment_options,
)
from .reconstruction_estimator_utils import (
    num_estimated_tracks,
    num_estimated_views,
    set_outlier_tracks_to_unestimated,
    set_reconstruction_from_estimated_poses,
    set_underconstrained_tracks_to_unestimated,
    set_underconstrained_views_to_unestimated,
)
from .select_tracks import select_good_tracks_for_bundle_adjustment
from .track_estimator import TrackEstimatorOptions, estimate_all_tracks, estimate_tracks

__all__ = ["GlobalReconstructionEstimator", "POSE_STAGES"]

# The stages of steps 1-7 as `_estimate_poses` times them (step 2, the
# intrinsics from the priors, is `calibration_time`).
POSE_STAGES = (
    "initial filter",
    "MST + rotations",
    "orientation filter",
    "pairwise translations",
    "1DSfM",
    "positions",
)


class GlobalReconstructionEstimator:
    """Parity: `theia::GlobalReconstructionEstimator`
    (`global_reconstruction_estimator.h:71-90`). `device`: where the
    numeric stages run (None: the CUDA card). After `estimate`,
    `bundle_adjustment_rounds` holds one dict a BA round: the kernel that
    ran (`solver`: "dense", "iterative" or "flat"), LM and PCG iterations,
    initial and final cost, outliers removed, tracks retriangulated, the
    seconds of the solve and of the outlier filter, and the iterative
    kernel's size gates (`size_gates`, None for the other kernels);
    `removed_edges` the count of view-graph edges each filter removed."""

    def __init__(self, options: ReconstructionEstimatorOptions | None = None, device=None):
        self.options = options or ReconstructionEstimatorOptions()
        self.device = default_device(device)
        self.bundle_adjustment_rounds: list[dict] = []
        self.removed_edges: dict[str, int] = {}
        self.calibration_time = 0.0

    # ------------------------------------------------------------- pipeline

    def estimate(self, view_graph, recon,
                 timer: StageTimer | None = None) -> ReconstructionEstimatorSummary:
        """Steps of `GlobalReconstructionEstimator::Estimate`
        (`global_reconstruction_estimator.cc:142`):
        1 filter the initial view graph   2 intrinsics from the priors
        3 global rotations                4 filter rotations
        5 pairwise translations           6 1DSfM translation filter
        7 positions                       8 triangulate
        9 BA + outlier removal + retriangulation rounds

        `timer` times (and, when it profiles, profiles) the stages: those of
        `POSE_STAGES`, "triangulation" and "bundle adjustment".
        """
        timer = timer or StageTimer(self.device)
        opt = self.options
        summary = ReconstructionEstimatorSummary()
        t_start = time.perf_counter()
        self.removed_edges = {}
        poses = self._estimate_poses(view_graph, recon, timer, removed=self.removed_edges)
        self.estimated_poses = poses
        if poses is None:
            summary.message = "insufficient view pairs"
            logger.warning("global SfM aborted: insufficient view pairs")
            return summary
        summary.camera_intrinsics_calibration_time = self.calibration_time
        summary.rotation_estimation_time = timer.seconds["MST + rotations"]
        summary.position_estimation_time = timer.seconds["positions"]
        summary.pose_estimation_time = sum(timer.seconds[k] for k in POSE_STAGES[1:])
        logger.info("pose estimation: %d positions in %.3fs", len(poses[1]),
                    summary.pose_estimation_time)

        # 8. Triangulate all tracks (.cc:456-472).
        with timer("triangulation"):
            self._estimate_structure(recon)
        summary.triangulation_time = timer.seconds["triangulation"]
        logger.info("triangulation: %d estimated tracks in %.3fs",
                    num_estimated_tracks(recon), summary.triangulation_time)
        set_underconstrained_tracks_to_unestimated(recon)
        set_underconstrained_views_to_unestimated(recon)

        # 9. Bundle adjustment with retriangulation rounds (.cc:233-271).
        with timer("bundle adjustment"):
            self._bundle_adjustment_loop(recon)
        summary.bundle_adjustment_time = timer.seconds["bundle adjustment"]
        logger.info("bundle adjustment: %.3fs", summary.bundle_adjustment_time)

        summary.estimated_views = {int(v) for v in np.nonzero(recon.view_estimated)[0]}
        summary.estimated_tracks = {int(t) for t in np.nonzero(recon.track_estimated)[0]}
        summary.success = num_estimated_views(recon) >= 2 and num_estimated_tracks(recon) > 0
        summary.total_time = time.perf_counter() - t_start
        summary.message = (f"estimated {num_estimated_views(recon)} views, "
                           f"{num_estimated_tracks(recon)} tracks")
        logger.info("global SfM: %s in %.3fs", summary.message, summary.total_time)
        return summary

    def _estimate_poses(self, view_graph, recon, stage: StageTimer | None = None,
                        edges: dict | None = None, removed: dict | None = None):
        """Steps 1-7 on `view_graph` and `recon` (both changed in place), each
        stage of `POSE_STAGES` timed by `stage`; the estimated poses are
        written into `recon`. `edges` gets the edge set after each filter
        stage, `removed` the count of edges each filter removed. Returns
        (orientations, positions), or None when step 1 leaves no edge."""
        opt, device = self.options, self.device
        stage = stage or StageTimer(device)
        edges = {} if edges is None else edges
        removed = {} if removed is None else removed

        # 1. Filter the initial view graph (min inliers, largest CC).
        with stage("initial filter"):
            before = view_graph.num_edges()
            ok = self._filter_initial_view_graph(view_graph, recon)
            removed["initial filter"] = before - view_graph.num_edges()
            edges["initial filter"] = frozenset(view_graph.edges)
        if not ok:
            return None

        # 2. Calibrate any uncalibrated cameras (.cc:166).
        t0 = time.perf_counter()
        recon.set_camera_intrinsics_from_priors()
        self.calibration_time = time.perf_counter() - t0

        # 3. Global rotations (.cc:327-371).
        with stage("MST + rotations"):
            orientations = rot_est.estimate_rotations(
                view_graph, int(opt.global_rotation_estimator_type), mesh=opt.mesh,
                device=device,
            )

        # 4. Filter relative rotations that disagree (.cc:375-381).
        with stage("orientation filter"):
            removed["orientation filter"] = filters.filter_view_pairs_from_orientation(
                view_graph, orientations, opt.rotation_filtering_max_difference_degrees,
                device=device,
            )
            if opt.extract_maximal_rigid_subgraph:
                # Parity: FilterRotations' rigid-subgraph step
                # (extract_maximally_parallel_rigid_subgraph.h:63).
                filters.extract_maximally_parallel_rigid_subgraph(
                    orientations, view_graph, device=device
                )
                for v in list(orientations):
                    if not view_graph.has_view(v):
                        orientations.pop(v)
            for v in view_graph.remove_disconnected_view_pairs():
                orientations.pop(v, None)
            edges["orientation filter"] = frozenset(view_graph.edges)

        # 5. Refine relative translations with known rotations (.cc:195-202).
        with stage("pairwise translations"):
            if opt.refine_relative_translations_after_rotation_estimation:
                self._optimize_pairwise_translations(view_graph, orientations, recon)

        # 6. 1DSfM relative-translation filtering (.cc:404).
        with stage("1DSfM"):
            removed["1DSfM"] = 0
            if opt.filter_relative_translations_with_1dsfm:
                removed["1DSfM"] = filters.filter_view_pairs_from_relative_translation(
                    view_graph,
                    orientations,
                    num_iterations=opt.translation_filtering_num_iterations,
                    translation_projection_tolerance=(
                        opt.translation_filtering_projection_tolerance
                    ),
                    rng=np.random.default_rng(opt.rng_seed),
                    device=device,
                )
                for v in view_graph.remove_disconnected_view_pairs():
                    orientations.pop(v, None)
            edges["1DSfM"] = frozenset(view_graph.edges)

        if opt.mesh is not None:
            # Steps 4-6 ran on every rank: rank 0's graph and orientations.
            state, orientations = mesh_axis(opt.mesh).broadcast_object(
                (view_graph.__dict__, orientations))
            view_graph.__dict__.update(state)

        # 7. Global positions (.cc:418-452).
        with stage("positions"):
            positions = pos_est.estimate_positions(
                view_graph, orientations, int(opt.global_position_estimator_type),
                mesh=opt.mesh, device=device,
            )
        set_reconstruction_from_estimated_poses(orientations, positions, recon)
        return orientations, positions

    # ----------------------------------------------------------- sub-stages

    def _filter_initial_view_graph(self, view_graph, recon) -> bool:
        """Parity: `FilterInitialViewGraph`
        (`global_reconstruction_estimator.cc:304-325`)."""
        opt = self.options
        to_remove = [
            (i, j)
            for (i, j), info in view_graph.edges.items()
            if info.num_verified_matches < opt.min_num_two_view_inliers
        ]
        for i, j in to_remove:
            view_graph.remove_edge(i, j)
        keep = set(view_graph.largest_connected_component_ids())
        for v in list(view_graph.view_ids()):
            if v not in keep:
                view_graph.remove_view(v)
        return view_graph.num_edges() >= 1

    def _optimize_pairwise_translations(self, view_graph, orientations, recon):
        """Parity: `OptimizePairwiseTranslations`
        (`global_reconstruction_estimator.cc:195-202`): refine each edge's
        relative position on the epipolar constraint over the views' shared
        (normalized) features, batched over all edges."""
        edges = [
            (i, j)
            for (i, j) in view_graph.edges
            if i in orientations and j in orientations
        ]
        if not edges:
            return
        # Shared-track correspondences per edge, as observation rows.
        corr = []
        for (i, j) in edges:
            vi = recon._view_track_to_obs[i]
            vj = recon._view_track_to_obs[j]
            common = [t for t in vi if t in vj]
            corr.append(([vi[t] for t in common], [vj[t] for t in common]))
        K = max((len(c[0]) for c in corr), default=0)
        if K < 5:
            return
        Kp = 8
        while Kp < K:
            Kp *= 2
        E = len(edges)
        dtype = np.float64
        x1 = np.zeros((E, Kp, 2), dtype)
        x2 = np.zeros((E, Kp, 2), dtype)
        mask = np.zeros((E, Kp), bool)
        rot1 = np.zeros((E, 3), dtype)
        rot2 = np.zeros((E, 3), dtype)
        init = np.zeros((E, 3), dtype)

        # Normalize the whole observation table once per intrinsics group.
        norm_uv = np.zeros((len(recon.obs_view), 2), dtype)
        obs_group = recon.view_group[recon.obs_view]
        for g in np.unique(obs_group):
            rows = np.nonzero(obs_group == g)[0]
            ray = cam.pixel_to_normalized_batch(
                torch.as_tensor(recon.intrinsics[g], device=self.device),
                torch.as_tensor(recon.obs_uv[rows], device=self.device),
                int(recon.group_model[g]),
            )
            norm_uv[rows] = (ray[:, :2] / ray[:, 2:3]).cpu().numpy()

        for e, ((i, j), (rows_i, rows_j)) in enumerate(zip(edges, corr)):
            k = len(rows_i)
            if k:
                x1[e, :k] = norm_uv[rows_i]
                x2[e, :k] = norm_uv[rows_j]
                mask[e, :k] = True
            rot1[e] = orientations[i]
            rot2[e] = orientations[j]
            init[e] = np.asarray(view_graph.get_edge(i, j).position_2)

        refined, ok = optimize_relative_positions_with_known_rotations(
            *(torch.as_tensor(a, device=self.device) for a in (rot1, rot2, x1, x2, mask, init))
        )
        refined = refined.cpu().numpy()
        ok = ok.cpu().numpy()
        for e, (i, j) in enumerate(edges):
            if ok[e]:
                view_graph.get_edge(i, j).position_2 = refined[e]

    def _estimate_structure(self, recon, track_ids=None):
        """Parity: `EstimateStructure`
        (`global_reconstruction_estimator.cc:456-472`)."""
        opt = self.options
        te_options = TrackEstimatorOptions(
            max_acceptable_reprojection_error_pixels=(
                opt.triangulation_max_reprojection_error_in_pixels
            ),
            min_triangulation_angle_degrees=opt.min_triangulation_angle_degrees,
            bundle_adjustment=opt.bundle_adjust_tracks,
            triangulation_method=opt.triangulation_method,
            mesh=opt.mesh,
        )
        if track_ids is None:
            return estimate_all_tracks(recon, te_options, device=self.device)
        return estimate_tracks(recon, track_ids, te_options, device=self.device)

    def _bundle_adjustment_loop(self, recon):
        """Parity: the retriangulation + BA loop
        (`global_reconstruction_estimator.cc:233-271,480-498`): BA, drop the
        outlier and under-constrained tracks, retriangulate the unestimated
        tracks, up to `num_retriangulation_iterations` + 1 rounds; stops
        early when a round drops no outlier."""
        opt, device = self.options, self.device
        ba_options = set_bundle_adjustment_options(opt, num_estimated_views(recon))
        self.bundle_adjustment_rounds = []
        for it in range(opt.num_retriangulation_iterations + 1):
            t0 = time.perf_counter()
            if opt.subsample_tracks_for_bundle_adjustment:
                tracks = select_good_tracks_for_bundle_adjustment(
                    recon,
                    long_track_length_threshold=(
                        opt.track_subset_selection_long_track_length_threshold
                    ),
                    image_grid_cell_size_pixels=opt.track_selection_image_grid_cell_size_pixels,
                    min_num_optimized_tracks_per_view=opt.min_num_optimized_tracks_per_view,
                    device=device,
                )
                views = [int(v) for v in np.nonzero(recon.view_estimated)[0]]
                ba_summary = bundle_adjust_partial_reconstruction(
                    ba_options, views, tracks, recon, device=device
                )
            else:
                ba_summary = bundle_adjust_reconstruction(ba_options, recon, device=device)
            t1 = time.perf_counter()
            num_outliers = set_outlier_tracks_to_unestimated(
                recon, opt.max_reprojection_error_in_pixels,
                opt.min_triangulation_angle_degrees, device=device,
            )
            set_underconstrained_tracks_to_unestimated(recon)
            t2 = time.perf_counter()
            rnd = dict(round=it, solver=ba_summary.linear_solver,
                       iterations=int(ba_summary.num_iterations),
                       pcg_iterations=ba_summary.num_linear_solver_iterations,
                       initial_cost=ba_summary.initial_cost, final_cost=ba_summary.final_cost,
                       outliers=num_outliers, retriangulated=0, solve_s=t1 - t0,
                       filter_s=t2 - t1, size_gates=ba_summary.size_gates)
            self.bundle_adjustment_rounds.append(rnd)
            logger.info("BA round %d (%s): %d LM iterations, cost %.4g -> %.4g, %d outliers "
                        "(solve %.2fs, filter %.2fs)", it, rnd["solver"], rnd["iterations"],
                        rnd["initial_cost"], rnd["final_cost"], num_outliers, t1 - t0, t2 - t1)
            if it == opt.num_retriangulation_iterations or num_outliers == 0:
                break
            # Retriangulate the dropped tracks.
            unest = np.nonzero(~recon.track_estimated)[0]
            rnd["retriangulated"] = len(unest)
            self._estimate_structure(recon, unest)
