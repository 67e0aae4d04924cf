"""Global pose estimation: rotation averaging, view-graph filters, pairwise
translations and position averaging. Counterpart of the JAX package's
`global_pose/` (`theia/sfm/global_pose_estimation/`): every estimator is a
function over flat edge arrays (from `ViewGraph.edge_arrays`), with
operator-form CG on the device."""

from .filters import (  # noqa: F401
    filter_view_pairs_from_orientation,
    filter_view_pairs_from_relative_translation,
)
from .position_estimator import (  # noqa: F401
    GlobalPositionEstimatorType,
    estimate_positions,
    least_unsquared_deviation_positions,
)
from .rotation_estimator import (  # noqa: F401
    GlobalRotationEstimatorType,
    estimate_rotations,
    orientations_from_maximum_spanning_tree,
    robust_rotation_averaging,
)
