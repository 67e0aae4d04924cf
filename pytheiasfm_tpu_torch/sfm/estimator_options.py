"""Reconstruction-estimator configuration tree.

Counterpart of the JAX package's `sfm/estimator_options.py`
(`theia/sfm/reconstruction_estimator_options.h:100-352` and the summary of
`reconstruction_estimator.h:50-63`), with the same field names and defaults.
"""

from __future__ import annotations

import dataclasses
import enum

from ..ba.lm import (
    BundleAdjustmentOptions,
    OptimizeIntrinsicsType,
    TrackParametrizationType,
)
from ..ba.losses import LossFunctionType
from ..ransac.engine import RansacParameters
from .track_estimator import TriangulationMethodType

__all__ = [
    "ReconstructionEstimatorType",
    "GlobalRotationEstimatorType",
    "GlobalPositionEstimatorType",
    "TrackParametrizationType",
    "PnPType",
    "ReconstructionEstimatorOptions",
    "ReconstructionEstimatorSummary",
    "set_bundle_adjustment_options",
    "set_ransac_parameters",
]


class ReconstructionEstimatorType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:56-58`."""

    GLOBAL = 0
    INCREMENTAL = 1
    HYBRID = 2


class GlobalRotationEstimatorType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:65-69`."""

    ROBUST_L1L2 = 0
    NONLINEAR = 1
    LINEAR = 2
    LAGRANGE_DUAL = 3
    HYBRID = 4


class GlobalPositionEstimatorType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:81-84`."""

    NONLINEAR = 0
    LINEAR_TRIPLET = 1
    LEAST_UNSQUARED_DEVIATION = 2
    LIGT = 3


class PnPType(enum.IntEnum):
    """Parity: `estimate_calibrated_absolute_pose.h:54`."""

    KNEIP = 0
    SQPNP = 1
    DLS = 2


@dataclasses.dataclass
class ReconstructionEstimatorOptions:
    """Parity: `theia::ReconstructionEstimatorOptions`
    (`reconstruction_estimator_options.h:100-352`)."""

    reconstruction_estimator_type: ReconstructionEstimatorType = (
        ReconstructionEstimatorType.GLOBAL
    )
    global_rotation_estimator_type: GlobalRotationEstimatorType = (
        GlobalRotationEstimatorType.ROBUST_L1L2
    )
    global_position_estimator_type: GlobalPositionEstimatorType = (
        GlobalPositionEstimatorType.LEAST_UNSQUARED_DEVIATION
    )

    # General.
    max_reprojection_error_in_pixels: float = 5.0
    min_num_two_view_inliers: int = 30
    rng_seed: int = 0

    # RANSAC.
    ransac_confidence: float = 0.9999
    ransac_min_iterations: int = 50
    ransac_max_iterations: int = 1000
    ransac_use_mle: bool = True
    ransac_use_lo: bool = True
    # SPRT two-stage preemption (`sample_consensus_estimator.h:58`
    # use_Tdd_test; wired to the batched SPRT path in ransac/engine.py).
    ransac_use_Tdd_test: bool = False
    ransac_lo_start_iterations: int = 50

    # Global SfM rotation filtering.
    rotation_filtering_max_difference_degrees: float = 5.0
    refine_relative_translations_after_rotation_estimation: bool = True
    extract_maximal_rigid_subgraph: bool = False
    filter_relative_translations_with_1dsfm: bool = True
    translation_filtering_num_iterations: int = 48
    translation_filtering_projection_tolerance: float = 0.1
    rotation_estimation_robust_loss_scale: float = 0.1
    refine_camera_positions_and_points_after_position_estimation: bool = True

    # Incremental SfM.
    multiple_view_localization_ratio: float = 0.8
    absolute_pose_reprojection_error_threshold: float = 4.0
    min_num_absolute_pose_inliers: int = 30
    full_bundle_adjustment_growth_percent: float = 5.0
    partial_bundle_adjustment_num_views: int = 20
    relative_position_estimation_max_sampson_error_pixels: float = 4.0

    # Triangulation.
    min_triangulation_angle_degrees: float = 3.0
    triangulation_max_reprojection_error_in_pixels: float = 10.0
    bundle_adjust_tracks: bool = True
    triangulation_method: TriangulationMethodType = TriangulationMethodType.MIDPOINT
    num_retriangulation_iterations: int = 1

    # Bundle adjustment.
    bundle_adjustment_loss_function_type: LossFunctionType = LossFunctionType.TRIVIAL
    bundle_adjustment_robust_loss_width: float = 10.0
    max_num_iterations: int = 50
    linear_solver_iterations: int = 40
    # Reference defaults (`reconstruction_estimator_options.h:281-290`):
    # optimize focal length + radial distortion, homogeneous points on the
    # unit-sphere manifold. Set `intrinsics_to_optimize = NONE` when
    # calibration is accurately known (also the reference's advice).
    track_parametrization_type: TrackParametrizationType = (
        TrackParametrizationType.XYZW_MANIFOLD
    )
    intrinsics_to_optimize: OptimizeIntrinsicsType = (
        OptimizeIntrinsicsType.FOCAL_LENGTH
        | OptimizeIntrinsicsType.RADIAL_DISTORTION
    )

    # Track subsampling.
    subsample_tracks_for_bundle_adjustment: bool = False
    track_subset_selection_long_track_length_threshold: int = 10
    track_selection_image_grid_cell_size_pixels: int = 100
    min_num_optimized_tracks_per_view: int = 200

    # Localization.
    localization_pnp_type: PnPType = PnPType.DLS

    # Multi-device execution (no reference analogue): a `torch.distributed`
    # device mesh (`parallel.make_mesh`). Rotations, positions,
    # triangulation and bundle adjustment shard over it; every rank runs the
    # estimator on the same inputs and ends with the same reconstruction.
    # None = one device.
    mesh: object = None


@dataclasses.dataclass
class ReconstructionEstimatorSummary:
    """Parity: `theia::ReconstructionEstimatorSummary`
    (`reconstruction_estimator.h:50-63`)."""

    success: bool = False
    estimated_views: set = dataclasses.field(default_factory=set)
    estimated_tracks: set = dataclasses.field(default_factory=set)
    camera_intrinsics_calibration_time: float = 0.0
    pose_estimation_time: float = 0.0
    # Finer split of pose_estimation_time (the reference's performance
    # tables report Rotation and Position separately, performance.md:52-70).
    rotation_estimation_time: float = 0.0
    position_estimation_time: float = 0.0
    triangulation_time: float = 0.0
    bundle_adjustment_time: float = 0.0
    total_time: float = 0.0
    message: str = ""


def set_bundle_adjustment_options(
    options: ReconstructionEstimatorOptions, num_views: int
) -> BundleAdjustmentOptions:
    """Parity: `theia::SetBundleAdjustmentOptions`
    (`reconstruction_estimator_utils.cc`)."""
    return BundleAdjustmentOptions(
        loss_function_type=options.bundle_adjustment_loss_function_type,
        robust_loss_width=options.bundle_adjustment_robust_loss_width,
        max_num_iterations=options.max_num_iterations,
        linear_solver_iterations=options.linear_solver_iterations,
        track_parametrization_type=options.track_parametrization_type,
        intrinsics_to_optimize=options.intrinsics_to_optimize,
        mesh=options.mesh,
    )


def set_ransac_parameters(
    options: ReconstructionEstimatorOptions,
) -> RansacParameters:
    """Parity: `theia::SetRansacParameters`
    (`reconstruction_estimator_utils.cc`). The error threshold stays
    caller-set."""
    return dataclasses.replace(
        RansacParameters(),
        failure_probability=1.0 - options.ransac_confidence,
        min_iterations=options.ransac_min_iterations,
        max_iterations=options.ransac_max_iterations,
        use_mle=options.ransac_use_mle,
        use_lo=options.ransac_use_lo,
        use_Tdd_test=options.ransac_use_Tdd_test,
    )
