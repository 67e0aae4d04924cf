"""Bundle adjustment. Counterpart of the JAX package's `ba/`: the robust
losses (`losses.py`), the two-view refinements (`two_view.py`), the LM
types and shared pieces (`lm.py`), the iterative-Schur kernel
(`iterative_schur.py`) and the entries over a reconstruction (`entry.py`).
The dense Schur (ROADMAP item A7), the flat kernel (A5b) and the covariance
(D1) are not ported."""

from . import entry, iterative_schur, lm, losses, two_view  # noqa: F401
from .iterative_schur import bundle_adjust_iterative  # noqa: F401
from .lm import (  # noqa: F401
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    TrackParametrizationType,
    bundle_adjust,
)
from .losses import LossFunctionType  # noqa: F401
