"""Reconstruction-estimator factory.

Counterpart of the JAX package's `sfm/reconstruction_estimator.py`
(`theia::ReconstructionEstimator::Create`, `reconstruction_estimator.h:75`).
GLOBAL is ported; INCREMENTAL and HYBRID raise naming ROADMAP item C1.
"""

from __future__ import annotations

from .estimator_options import ReconstructionEstimatorOptions, ReconstructionEstimatorType
from .global_estimator import GlobalReconstructionEstimator

__all__ = ["create_reconstruction_estimator"]


def create_reconstruction_estimator(
    options: ReconstructionEstimatorOptions | None = None, device=None
):
    """The estimator that `options.reconstruction_estimator_type` names, on
    `device` (None: the CUDA card)."""
    options = options or ReconstructionEstimatorOptions()
    t = options.reconstruction_estimator_type
    if t == ReconstructionEstimatorType.GLOBAL:
        return GlobalReconstructionEstimator(options, device=device)
    if t in (ReconstructionEstimatorType.INCREMENTAL, ReconstructionEstimatorType.HYBRID):
        raise NotImplementedError(
            f"the {ReconstructionEstimatorType(t).name} reconstruction estimator is not "
            "ported yet (ROADMAP item C1)"
        )
    raise ValueError(f"unknown reconstruction estimator type: {t}")
