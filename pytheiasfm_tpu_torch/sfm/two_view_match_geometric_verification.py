"""Options of the full two-view match verification.

Counterpart of the options dataclass of the JAX package's
`sfm/two_view_match_geometric_verification.py`
(`two_view_match_geometric_verification.h:55-93`). This slice runs stage 1
of verification only (RANSAC geometry); the guided epipolar rematch and the
two-view bundle adjustment that `guided_matching` and `bundle_adjustment`
turn on are stage 2, which ports in a later slice.
"""

from __future__ import annotations

import dataclasses

from .two_view import EstimateTwoViewInfoOptions

__all__ = ["TwoViewMatchGeometricVerificationOptions"]


@dataclasses.dataclass
class TwoViewMatchGeometricVerificationOptions:
    """Parity: `TwoViewMatchGeometricVerification::Options`
    (`two_view_match_geometric_verification.h:55-93`)."""

    estimate_twoview_info_options: EstimateTwoViewInfoOptions = dataclasses.field(
        default_factory=EstimateTwoViewInfoOptions
    )
    min_num_inlier_matches: int = 30
    guided_matching: bool = False
    guided_matching_max_distance_pixels: float = 2.0
    guided_matching_lowes_ratio: float = 0.8
    bundle_adjustment: bool = True
    triangulation_max_reprojection_error: float = 15.0
    min_triangulation_angle_degrees: float = 4.0
    final_max_reprojection_error: float = 5.0
