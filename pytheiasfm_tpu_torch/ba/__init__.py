"""Bundle adjustment. Counterpart of the JAX package's `ba/`: the robust
losses (`losses.py`), the two-view refinements (`two_view.py`), the LM
types, shared pieces and flat implicit-PCG kernel (`lm.py`), the dense-Schur
kernel and exact joint covariance (`dense_schur.py`), the iterative-Schur
kernel (`iterative_schur.py`), the selected-block covariance
(`covariance.py`) and the entries over a reconstruction (`entry.py`)."""

from . import covariance, dense_schur, entry, iterative_schur, lm, losses, two_view  # noqa: F401
from .dense_schur import DENSE_SCHUR_MAX_CAMERAS, bundle_adjust_dense  # noqa: F401
from .iterative_schur import bundle_adjust_iterative  # noqa: F401
from .lm import (  # noqa: F401
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    TrackParametrizationType,
    bundle_adjust,
)
from .losses import LossFunctionType  # noqa: F401
