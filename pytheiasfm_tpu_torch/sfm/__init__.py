"""Scene containers, two-view geometry, localization and the
reconstruction estimators."""

from . import reconstruction, track_builder, view_graph  # noqa: F401
from .reconstruction import CameraIntrinsicsPrior, Reconstruction  # noqa: F401
from .track_builder import TrackBuilder  # noqa: F401
from .view_graph import TwoViewInfo, ViewGraph  # noqa: F401

from .hybrid_estimator import HybridReconstructionEstimator  # noqa: F401
from .incremental_estimator import IncrementalReconstructionEstimator  # noqa: F401
from .localize import (  # noqa: F401
    LocalizeViewToReconstructionOptions,
    localize_view_to_reconstruction,
    localize_views_to_reconstruction_batch,
)
