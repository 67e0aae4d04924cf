"""Track-estimation enums.

Counterpart of `TriangulationMethodType` from the JAX package's
`sfm/track_estimator.py`. The track estimator itself comes with the
structure port (ROADMAP item A4).
"""

from __future__ import annotations

import enum

__all__ = ["TriangulationMethodType"]


class TriangulationMethodType(enum.IntEnum):
    """Parity: `theia::TriangulationMethodType` (`estimate_track.h:49`)."""

    MIDPOINT = 0
    SVD = 1
    L2_MINIMIZATION = 2
