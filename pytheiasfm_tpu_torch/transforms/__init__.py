"""Similarity and alignment transforms (`theia/sfm/transformation/`):
point-cloud and reconstruction alignment (`alignment.py`), Sim(3)
alignment and pose-graph optimization (`pose_graph_sim3.py`)."""

from .alignment import (  # noqa: F401
    align_point_clouds_umeyama,
    align_reconstructions,
    align_reconstructions_robust,
    sim3_transform_points,
    transform_reconstruction,
)
from .pose_graph_sim3 import (  # noqa: F401
    Sim3AlignmentOptions,
    Sim3AlignmentSummary,
    Sim3AlignmentType,
    align_overlap_reconstructions_with_points_and_poses_robust,
    find_common_tracks_by_feature_in_reconstructions,
    optimize_alignment_sim3,
    optimize_sim3_pose_graph,
)
