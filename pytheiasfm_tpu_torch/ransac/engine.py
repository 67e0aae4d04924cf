"""Batched RANSAC engine.

Counterpart of the JAX package's `ransac/engine.py`
(`theia/solvers/sample_consensus_estimator.h:147`, `ransac.h:47`). The whole
hypothesis budget of every problem in a batch is evaluated as one tensor
program: sample -> minimal solve -> residuals against all data -> quality
-> argmin. The batch dimension P (one problem per image pair) is written out
where the JAX package uses `vmap`.

RANSAC is split in two so that a test can feed both packages the same
samples: `_draw_samples` draws the sample indices, `score_samples` solves and
scores given indices. Randomness comes from an explicit `torch.Generator`;
its stream differs from `jax.random`'s, so parity with the JAX package is
exact only given the same indices.

Scoring always runs in blocks of hypotheses: the cost is a reduction over
the data, so blocks give the same result as one [P, B*K, N] residual tensor
with a bounded footprint (the JAX package blocks only when B*K is a
multiple of 256).

An estimator is a namespace of functions over batched tensors:

    sample_size: int               minimal sample cardinality
    solve(subset) ->               (models with leading axes [P, B, K],
                                    valid [P, B, K])
    residuals(models, data) ->     [P, H, N] squared errors of models with
                                   leading axes [P, H] against data [P, N]

`data` is a NamedTuple of tensors with leading axes [P, N].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = [
    "RansacParameters",
    "RansacSummary",
    "RansacType",
    "Estimator",
    "ransac",
    "score_samples",
]

# Elements of one [P, H, N] residual block; bounds scoring memory.
_SCORE_BLOCK_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class RansacParameters:
    """Parity: `theia::RansacParameters`
    (`solvers/sample_consensus_estimator.h:58`); the same fields as the JAX
    package's. Fields of the variants this port does not have yet (LO,
    PROSAC, exhaustive, SPRT) are kept and raise when set."""

    error_thresh: float = 1e-4  # SQUARED error threshold (as in reference)
    failure_probability: float = 0.01
    max_iterations: int = 512  # hypothesis batch size
    min_iterations: int = 100
    use_mle: bool = False
    use_lo: bool = False
    lo_iterations: int = 2
    sampler: str = "random"  # only "random" is ported
    use_Tdd_test: bool = False
    sprt_sigma: float = 0.05
    sprt_epsilon: float = 0.1
    sprt_subset_size: int = 64
    sprt_keep_fraction: float = 0.25


@dataclasses.dataclass
class RansacSummary:
    """Parity: `theia::RansacSummary` (`sample_consensus_estimator.h:129`),
    each field with a leading problem axis [P]."""

    inliers: torch.Tensor  # [P, N] bool mask
    num_inliers: torch.Tensor  # [P]
    num_iterations: torch.Tensor  # [P] adaptive-equivalent iteration count
    confidence: torch.Tensor  # [P] inlier ratio
    best_cost: torch.Tensor  # [P]
    num_lo_iterations: int = 0


class RansacType:
    """Parity: `theia::RansacType` (`create_and_initialize_ransac_variant.h:52`)."""

    RANSAC = "random"
    PROSAC = "prosac"
    LMED = "lmed"
    EXHAUSTIVE = "exhaustive"


@dataclasses.dataclass(frozen=True)
class Estimator:
    sample_size: int
    solve: Callable[[Any], tuple[Any, torch.Tensor]]
    residuals: Callable[[Any, Any], torch.Tensor]


def _check_supported(params: RansacParameters, quality: str):
    missing = []
    if params.sampler != "random":
        missing.append(f"sampler={params.sampler!r}")
    if params.use_lo:
        missing.append("use_lo")
    if params.use_Tdd_test:
        missing.append("use_Tdd_test (SPRT)")
    if quality not in ("mle", "inlier"):
        missing.append(f"quality={quality!r}")
    if missing:
        raise NotImplementedError(
            "pytheiasfm_tpu_torch RANSAC has the random sampler with MLE or "
            "inlier quality only; not yet ported: " + ", ".join(missing)
        )


def _draw_samples(generator, mask, num_samples: int, sample_size: int):
    """[P, B, sample_size] indices, uniform without replacement over the
    valid rows of each problem: the top-k of uniform random keys, with
    invalid rows keyed -1."""
    P, N = mask.shape
    keys = torch.rand(
        (P, num_samples, N), generator=generator, device=mask.device
    )
    keys = torch.where(mask[:, None, :], keys, -1.0)
    return torch.topk(keys, sample_size, dim=-1).indices


def _mle_cost(residuals, thresh):
    """MSAC cost (parity: `mle_quality_measurement.h`): inliers contribute
    their error, outliers the threshold."""
    return torch.sum(torch.minimum(residuals, thresh), dim=-1)


def _inlier_cost(residuals, thresh):
    """Parity: `inlier_support.h` — maximize inlier count."""
    return -torch.sum(residuals < thresh, dim=-1).to(residuals.dtype)


def _take(x, idx):
    """x [P, M, ...] at model indices idx [P, H] -> [P, H, ...]."""
    P = x.shape[0]
    return x[torch.arange(P, device=x.device)[:, None], idx]


def _gather_subset(data, sample_idx):
    """Data rows [P, N, ...] at sample indices [P, B, S] -> [P, B, S, ...]."""
    P = sample_idx.shape[0]
    rows = torch.arange(P, device=sample_idx.device)[:, None, None]
    return type(data)(*(a[rows, sample_idx] for a in data))


def score_samples(
    sample_idx: torch.Tensor,
    data: Any,
    estimator: Estimator,
    params: RansacParameters,
    mask: torch.Tensor | None = None,
    quality: str = "inlier",
    error_thresh: torch.Tensor | None = None,
    num_data: torch.Tensor | None = None,
):
    """Solve and score given samples; the deterministic half of `ransac`.

    Args:
      sample_idx: [P, B, sample_size] indices into the data rows.
      data: NamedTuple of tensors [P, N, ...].
      mask: [P, N] validity of data rows.
      error_thresh: [P] per-problem squared thresholds (default
        `params.error_thresh`).
      num_data: [P] true counts for the inlier ratio (default N, the
        padded count, as in the JAX package).

    Returns (best_model with leading axis [P], RansacSummary).
    """
    _check_supported(params, quality)
    first = data[0]
    P, N = first.shape[:2]
    dtype, device = first.dtype, first.device
    if error_thresh is None:
        thresh = torch.full((P,), params.error_thresh, dtype=dtype, device=device)
    else:
        thresh = torch.as_tensor(error_thresh, dtype=dtype, device=device)
    if num_data is None:
        num_data = torch.full((P,), N, device=device)

    models, valid = estimator.solve(_gather_subset(data, sample_idx))  # [P, B, K]
    flat_models = type(models)(*(m.flatten(1, 2) for m in models))  # [P, BK, ...]
    flat_valid = valid.flatten(1, 2)
    BK = flat_valid.shape[1]

    res_mask = None if mask is None else mask[:, None, :]
    hb = max(1, min(BK, _SCORE_BLOCK_ELEMENTS // max(P * N, 1)))
    costs = []
    for h0 in range(0, BK, hb):
        block = type(flat_models)(*(m[:, h0 : h0 + hb] for m in flat_models))
        res = estimator.residuals(block, data)  # [P, H, N]
        if res_mask is not None:
            res = torch.where(res_mask, res, torch.inf)
        if quality == "mle":
            costs.append(_mle_cost(res, thresh[:, None, None]))
        else:
            costs.append(_inlier_cost(res, thresh[:, None, None]))
    cost = torch.cat(costs, dim=1)  # [P, BK]
    cost = torch.where(flat_valid, cost, torch.inf)

    # First minimum on ties, as jnp.argmin.
    best = torch.argmin(cost, dim=1)  # [P]
    best_model = type(flat_models)(*(_take(m, best[:, None])[:, 0] for m in flat_models))
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]

    one_model = type(best_model)(*(m[:, None] for m in best_model))
    final_res = estimator.residuals(one_model, data)[:, 0]  # [P, N]
    inliers = final_res < thresh[:, None]
    if mask is not None:
        inliers = inliers & mask
    num_inliers = torch.sum(inliers, dim=-1)
    inlier_ratio = num_inliers / torch.clamp(num_data, min=1)

    # The iteration count the sequential adaptive loop would have used
    # (parity: ComputeMaxIterations, sample_consensus_estimator.h).
    eps = 1e-12
    log_fail = torch.log(torch.tensor(params.failure_probability, dtype=dtype, device=device))
    p_good = torch.clamp(inlier_ratio.to(dtype), eps, 1.0) ** estimator.sample_size
    needed = log_fail / torch.clamp(torch.log1p(-torch.clamp(p_good, 0.0, 1 - eps)), max=-eps)
    num_iterations = torch.clamp(
        torch.ceil(needed), params.min_iterations, params.max_iterations
    ).to(torch.int32)

    summary = RansacSummary(
        inliers=inliers,
        num_inliers=num_inliers,
        num_iterations=num_iterations,
        confidence=inlier_ratio,
        best_cost=best_cost,
    )
    return best_model, summary


def ransac(
    generator: torch.Generator,
    data: Any,
    estimator: Estimator,
    params: RansacParameters,
    mask: torch.Tensor | None = None,
    quality: str = "inlier",
    error_thresh: torch.Tensor | None = None,
    num_data: torch.Tensor | None = None,
):
    """Run the full hypothesis budget of P problems as one batched program.

    Args:
      generator: the random stream for sampling (on the data's device).
      data: NamedTuple of tensors [P, N, ...] (padded; use `mask`).
      estimator: the model estimator namespace.
      params: RANSAC parameters; `max_iterations` hypotheses per problem.
      mask: [P, N] validity of data rows.
      quality: "mle" or "inlier".
      error_thresh: [P] per-problem squared thresholds.

    Returns (best_model with leading axis [P], RansacSummary).
    """
    _check_supported(params, quality)
    first = data[0]
    if mask is None:
        mask = torch.ones(first.shape[:2], dtype=torch.bool, device=first.device)
    sample_idx = _draw_samples(
        generator, mask, params.max_iterations, estimator.sample_size
    )
    return score_samples(
        sample_idx, data, estimator, params, mask=mask, quality=quality,
        error_thresh=error_thresh, num_data=num_data,
    )
