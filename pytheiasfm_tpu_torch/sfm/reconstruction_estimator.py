"""Reconstruction-estimator factory.

Counterpart of the JAX package's `sfm/reconstruction_estimator.py`
(`theia::ReconstructionEstimator::Create`, `reconstruction_estimator.h:75`).
"""

from __future__ import annotations

from .estimator_options import ReconstructionEstimatorOptions, ReconstructionEstimatorType
from .global_estimator import GlobalReconstructionEstimator
from .hybrid_estimator import HybridReconstructionEstimator
from .incremental_estimator import IncrementalReconstructionEstimator

__all__ = ["create_reconstruction_estimator"]

_ESTIMATORS = {
    ReconstructionEstimatorType.GLOBAL: GlobalReconstructionEstimator,
    ReconstructionEstimatorType.INCREMENTAL: IncrementalReconstructionEstimator,
    ReconstructionEstimatorType.HYBRID: HybridReconstructionEstimator,
}


def create_reconstruction_estimator(
    options: ReconstructionEstimatorOptions | None = None, device=None
):
    """The estimator that `options.reconstruction_estimator_type` names, on
    `device` (None: the CUDA card)."""
    options = options or ReconstructionEstimatorOptions()
    t = options.reconstruction_estimator_type
    if t not in _ESTIMATORS:
        raise ValueError(f"unknown reconstruction estimator type: {t}")
    return _ESTIMATORS[t](options, device=device)
