"""Bundle-adjustment enums.

Counterpart of the enums of the JAX package's `ba/lm.py` that the estimator
options name. The solver itself comes with the BA port (ROADMAP item A5).
"""

from __future__ import annotations

import enum

from ..models.intrinsics import OptimizeIntrinsicsType

__all__ = ["OptimizeIntrinsicsType", "TrackParametrizationType"]


class TrackParametrizationType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:93-95`."""

    XYZW = 0
    XYZW_MANIFOLD = 1
    INVERSE_DEPTH = 2
