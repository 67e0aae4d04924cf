"""Sequential probability ratio test for preemptive RANSAC verification.

Counterpart of the JAX package's `math/sprt.py`
(`theia/math/probability/sequential_probability_ratio.h:51-65`, Matas and
Chum's SPRT): the decision threshold, and the test over batched inlier
sequences that the RANSAC engine's two-stage verification uses.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "calculate_sprt_decision_threshold",
    "sequential_probability_ratio_test",
]


def calculate_sprt_decision_threshold(
    sigma: float, epsilon: float, time_compute_model_ratio: float = 200.0,
    num_models_verified: int = 1,
) -> float:
    """Optimal SPRT decision threshold A* (Wald), parity with
    `CalculateSPRTDecisionThreshold` (`sequential_probability_ratio.h:51`):
    ten fixed-point steps of A = a0 + log(A)."""
    c = (1.0 - sigma) * math.log((1.0 - sigma) / (1.0 - epsilon)) + sigma * math.log(
        sigma / epsilon
    )
    a0 = time_compute_model_ratio * c / num_models_verified + 1.0
    a = a0
    for _ in range(10):
        a = a0 + math.log(a)
    return a


def sequential_probability_ratio_test(inlier_flags, sigma, epsilon, decision_threshold):
    """Run the SPRT over batched boolean inlier sequences [.., n].

    Returns (passed [..], observed inlier ratio [..]). The log-likelihood
    ratio accumulates along the last axis in float32, as in the JAX
    package; the test fails where it ever reaches log(A)
    (`sequential_probability_ratio.h:65`).
    """
    flags = inlier_flags.to(torch.float32)
    log_lr = flags * math.log(sigma / epsilon) + (1.0 - flags) * math.log(
        (1.0 - sigma) / (1.0 - epsilon)
    )
    cum = torch.cumsum(log_lr, dim=-1)
    passed = torch.amax(cum, dim=-1) < math.log(decision_threshold)
    # The count of 0/1 flags is exact in f32; XLA's `jnp.mean` then scales
    # it by the f32 reciprocal of n.
    return passed, torch.sum(flags, dim=-1) * (1.0 / flags.shape[-1])
