"""Feature-matcher options.

Parity: `theia/matching/feature_matcher_options.h:45-87`; the same fields and
defaults as the JAX package's `matching/options.py`.
"""

from __future__ import annotations

import dataclasses

from ..sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions,
)

__all__ = ["FeatureMatcherOptions"]


@dataclasses.dataclass
class FeatureMatcherOptions:
    """Same field names/defaults as the reference where the concept maps.

    `geometric_verification_options` is the composed verification config
    (`feature_matcher_options.h:82-86`).
    """

    num_threads: int = 1  # kept for API parity; batching is the parallelism
    keep_only_symmetric_matches: bool = True
    use_lowes_ratio: bool = True
    lowes_ratio: float = 0.8
    min_num_feature_matches: int = 30
    perform_geometric_verification: bool = True
    geometric_verification_options: TwoViewMatchGeometricVerificationOptions = (
        dataclasses.field(
            default_factory=TwoViewMatchGeometricVerificationOptions
        )
    )
    # Padding cap for the per-image descriptor count on device.
    max_num_features: int = 4096
