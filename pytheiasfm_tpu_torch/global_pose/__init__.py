"""Global pose estimation: rotation averaging, view-graph filters, pairwise
translations and position averaging. Counterpart of the JAX package's
`global_pose/` (`theia/sfm/global_pose_estimation/`): every estimator is a
function over flat edge arrays (from `ViewGraph.edge_arrays`), with
operator-form CG on the device."""

from .filters import (  # noqa: F401
    extract_maximally_parallel_rigid_subgraph,
    filter_view_graph_cycles_by_rotation,
    filter_view_pairs_from_orientation,
    filter_view_pairs_from_relative_translation,
)
from .position_estimator import (  # noqa: F401
    GlobalPositionEstimatorType,
    bata_positions,
    estimate_positions,
    least_unsquared_deviation_positions,
    ligt_positions,
    linear_triplet_positions,
    nonlinear_positions,
)
from .rotation_estimator import (  # noqa: F401
    GlobalRotationEstimatorType,
    estimate_rotations,
    hybrid_rotation_averaging,
    irls_rotation_refine,
    l1_rotation_global,
    lagrange_dual_rotation_averaging,
    linear_rotation_averaging,
    nonlinear_rotation_averaging,
    orientations_from_maximum_spanning_tree,
    robust_rotation_averaging,
)
from .triplet_baseline import compute_triplet_baseline_ratios  # noqa: F401
