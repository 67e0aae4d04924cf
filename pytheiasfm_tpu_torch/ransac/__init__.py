"""Batched RANSAC framework (sample consensus over minimal solvers)."""

from . import engine  # noqa: F401
from .engine import (  # noqa: F401
    Estimator,
    RansacParameters,
    RansacSummary,
    RansacType,
    ransac,
)
