"""Scene containers, two-view geometry, localization and the
reconstruction estimators."""

from .hybrid_estimator import HybridReconstructionEstimator  # noqa: F401
from .incremental_estimator import IncrementalReconstructionEstimator  # noqa: F401
from .localize import (  # noqa: F401
    LocalizeViewToReconstructionOptions,
    localize_view_to_reconstruction,
    localize_views_to_reconstruction_batch,
)
