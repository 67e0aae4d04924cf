"""Batched RANSAC engine.

Counterpart of the JAX package's `ransac/engine.py`
(`theia/solvers/sample_consensus_estimator.h:147`, `ransac.h:47`). The whole
hypothesis budget of every problem in a batch is evaluated as one tensor
program: sample -> minimal solve -> residuals against all data -> quality
-> argmin. The batch dimension P (one problem per image pair) is written out
where the JAX package uses `vmap`.

RANSAC is split in two so that a test can feed both packages the same
samples: `_draw_samples` (and, for SPRT, `_draw_subset`) draw the indices,
`score_samples` solves, scores and refines given them. Randomness comes from
an explicit `torch.Generator`; its stream differs from `jax.random`'s, so
parity with the JAX package is exact only given the same indices.

Variants, as in the JAX package: the random and PROSAC samplers (an
"exhaustive" sampler draws at random there too), inlier-count, MSAC ("mle")
and LMed quality, T(d,d) / SPRT two-stage verification (`use_Tdd_test`) and
LO-RANSAC rounds (`use_lo`, through the estimator's `refine`).

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
    refine(models, data, inliers)  optional LO step: models [P, ...] refit
      -> (models, ok [P])          on inliers [P, N]
    is_valid(models) -> [P, H]     optional model check

`data` is a NamedTuple of tensors with leading axes [P, N].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..math import sprt

__all__ = [
    "RansacParameters",
    "RansacSummary",
    "RansacType",
    "Estimator",
    "prosac_prefix",
    "ransac",
    "score_samples",
]

# Elements of one [P, H, N] residual block; bounds scoring memory.
_SCORE_BLOCK_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class RansacParameters:
    """Parity: `theia::RansacParameters`
    (`solvers/sample_consensus_estimator.h:58`); the same fields as the JAX
    package's."""

    error_thresh: float = 1e-4  # SQUARED error threshold (as in reference)
    failure_probability: float = 0.01
    max_iterations: int = 512  # hypothesis batch size
    min_iterations: int = 100
    use_mle: bool = False
    # Local optimization (LO-RANSAC), `sample_consensus_estimator.h:88-97`.
    use_lo: bool = False
    lo_iterations: int = 2
    # PROSAC: data assumed sorted by quality when sampler == "prosac".
    sampler: str = "random"  # "random" | "prosac" | "exhaustive"
    # T(d,d) / SPRT two-stage verification: every hypothesis is scored on a
    # data subset, the SPRT rejects hypotheses whose likelihood ratio
    # crosses Wald's threshold, and the best surviving fraction is verified
    # against the full data.
    use_Tdd_test: bool = False
    sprt_sigma: float = 0.05  # P(inlier | bad model)
    sprt_epsilon: float = 0.1  # P(inlier | good model) lower bound
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
    refine: Optional[Callable[[Any, Any, torch.Tensor], tuple[Any, torch.Tensor]]] = None
    is_valid: Optional[Callable[[Any], torch.Tensor]] = None


def prosac_prefix(num_samples: int, num_data: torch.Tensor, sample_size: int):
    """PROSAC's growth schedule [P, B]: hypothesis b of a problem with
    num_data [P] rows draws from its first n_b rows, n_b ramping from
    sample_size + 2 to num_data over the first half of the budget, clipped
    to [sample_size + 1, num_data] (the JAX package's
    `(params.max_iterations and sample_size + 2)` is sample_size + 2)."""
    b = torch.arange(num_samples, dtype=torch.float64, device=num_data.device)
    ramp = torch.clamp(2.0 * (b + 1) / num_samples, max=1.0)
    count = num_data.to(torch.float64)[:, None]
    n_b = torch.ceil((1.0 - ramp) * (sample_size + 2) + ramp * count)
    return torch.minimum(torch.clamp(n_b, min=sample_size + 1), count).to(torch.int64)


def _draw_samples(generator, mask, num_samples: int, sample_size: int, sampler="random",
                  num_data=None):
    """[P, B, sample_size] indices, uniform without replacement over the
    valid rows of each problem: the top-k of uniform random keys, with
    invalid rows keyed -1. PROSAC keys the rows past each hypothesis's
    prefix -1 too; its prefix grows to `num_data` [P] (default N, the
    padded count, as the JAX package's), so that a padded problem given
    its true count draws as the same problem unpadded."""
    P, N = mask.shape
    keys = torch.rand((P, num_samples, N), generator=generator, device=mask.device)
    allowed = mask[:, None, :]
    if sampler == RansacType.PROSAC:
        if num_data is None:
            num_data = torch.full((P,), N, device=mask.device)
        n_b = prosac_prefix(num_samples, torch.as_tensor(num_data, device=mask.device),
                            sample_size)
        allowed = allowed & (torch.arange(N, device=mask.device) < n_b[..., None])
    keys = torch.where(allowed, keys, -1.0)
    return torch.topk(keys, sample_size, dim=-1).indices


def _draw_subset(generator, mask, size: int):
    """[P, size] indices of the SPRT subset: `size` valid rows of each
    problem, uniform without replacement."""
    keys = torch.rand(mask.shape, generator=generator, device=mask.device)
    return torch.topk(torch.where(mask, keys, -1.0), size, dim=-1).indices


def sprt_subset_size(params: RansacParameters, num_rows: int, sample_size: int) -> int:
    return min(num_rows, max(params.sprt_subset_size, 4 * sample_size))


def _mle_cost(residuals, thresh):
    """MSAC cost (parity: `mle_quality_measurement.h`): inliers contribute
    their error, outliers the threshold."""
    return torch.sum(torch.minimum(residuals, thresh), dim=-1)


def _inlier_cost(residuals, thresh):
    """Parity: `inlier_support.h` — maximize inlier count."""
    return -torch.sum(residuals < thresh, dim=-1).to(residuals.dtype)


def _lmed_cost(residuals, mask=None):
    """Parity: `lmed_quality_measurement.h` — the median squared residual
    over each row's valid entries, NaNs excluded (`jnp.nanmedian`; the mean
    of the two middle values for an even count; NaN for none). Without a
    mask, over all entries (`jnp.median`: NaN if any is NaN)."""
    n = residuals.shape[-1]
    if mask is None:
        keep = torch.ones_like(residuals, dtype=torch.bool)
    else:
        keep = mask.expand(residuals.shape) & ~torch.isnan(residuals)
    srt = torch.sort(torch.where(keep, residuals, torch.inf), dim=-1).values
    count = torch.sum(keep, dim=-1, keepdim=True)
    lo = torch.clamp((count - 1) // 2, 0, n - 1)
    hi = torch.clamp(count // 2, 0, n - 1)
    med = 0.5 * (torch.gather(srt, -1, lo) + torch.gather(srt, -1, hi))[..., 0]
    med = torch.where(count[..., 0] > 0, med, torch.nan)
    if mask is None:
        med = torch.where(torch.any(torch.isnan(residuals), dim=-1), torch.nan, med)
    return med


def _cost(res, quality, thresh, mask):
    """Quality of residuals [P, H, N] with invalid rows at +inf; thresh
    broadcasts against [P, H, 1], mask against [P, H, N]."""
    if quality == "mle":
        return _mle_cost(res, thresh)
    if quality == "lmed":
        return _lmed_cost(res, mask)
    return _inlier_cost(res, thresh)


def _take(x, idx):
    """x [P, M, ...] at model indices idx [P, H] -> [P, H, ...]."""
    P = x.shape[0]
    return x[torch.arange(P, device=x.device)[:, None], idx]


def _gather_subset(data, sample_idx):
    """Data rows [P, N, ...] at sample indices [P, B, S] -> [P, B, S, ...]."""
    P = sample_idx.shape[0]
    rows = torch.arange(P, device=sample_idx.device)[:, None, None]
    return type(data)(*(a[rows, sample_idx] for a in data))


def _map_models(fn, models):
    return type(models)(*(fn(m) for m in models))


def _score_blocks(models, data, estimator, quality, thresh, mask):
    """The cost [P, H] of every hypothesis [P, H] against data [P, N], in
    blocks of hypotheses whose residuals hold at most _SCORE_BLOCK_ELEMENTS."""
    P, N = data[0].shape[:2]
    H = models[0].shape[1]
    res_mask = None if mask is None else mask[:, None, :]
    hb = max(1, min(H, _SCORE_BLOCK_ELEMENTS // max(P * N, 1)))
    costs = []
    for h0 in range(0, H, hb):
        res = estimator.residuals(_map_models(lambda m: m[:, h0 : h0 + hb], models), data)
        if res_mask is not None:
            res = torch.where(res_mask, res, torch.inf)
        costs.append(_cost(res, quality, thresh, res_mask))
    return torch.cat(costs, dim=1)


def _sprt_stage(models, valid, data, estimator, params, quality, thresh, mask, subset_idx):
    """Stage 1 of T(d,d) verification (the JAX engine's `use_Tdd_test`):
    every hypothesis [P, BK] against the subset rows `subset_idx` [P, n1];
    the SPRT drops hypotheses whose inlier sequence crosses Wald's
    threshold, and the best surviving fraction by the subset cost (MSAC,
    or LMed under LMed quality; ties to the lower index, as
    `lax.top_k`) goes on to full verification. Returns the kept models,
    their validity and the number kept."""
    P, BK = valid.shape
    rows = torch.arange(P, device=valid.device)[:, None]
    sub_data = type(data)(*(a[rows, subset_idx] for a in data))
    sub_mask = None if mask is None else mask[rows, subset_idx]
    decision = sprt.calculate_sprt_decision_threshold(params.sprt_sigma, params.sprt_epsilon)
    n1 = subset_idx.shape[1]
    hb = max(1, min(BK, _SCORE_BLOCK_ELEMENTS // max(P * n1, 1)))
    sub_costs, passed = [], []
    for h0 in range(0, BK, hb):
        res = estimator.residuals(_map_models(lambda m: m[:, h0 : h0 + hb], models), sub_data)
        if sub_mask is not None:
            res = torch.where(sub_mask[:, None, :], res, torch.inf)
        passed.append(sprt.sequential_probability_ratio_test(
            res < thresh, params.sprt_sigma, params.sprt_epsilon, decision)[0])
        if quality == "lmed":
            sub_costs.append(_lmed_cost(res, None if sub_mask is None else sub_mask[:, None, :]))
        else:
            # MSAC even for inlier quality: on a small subset the inlier
            # count saturates and ties would evict the sharpest hypotheses.
            sub_costs.append(_mle_cost(res, thresh))
    sub_cost = torch.where(valid & torch.cat(passed, dim=1), torch.cat(sub_costs, dim=1),
                           torch.inf)
    M = max(1, int(BK * params.sprt_keep_fraction))
    keep = torch.sort(sub_cost, dim=1, stable=True).indices[:, :M]
    kept = _map_models(lambda m: _take(m, keep), models)
    return kept, _take(valid, keep) & torch.isfinite(_take(sub_cost, keep))


def score_samples(
    sample_idx: torch.Tensor,
    data: Any,
    estimator: Estimator,
    params: RansacParameters,
    mask: torch.Tensor | None = None,
    quality: str = "inlier",
    error_thresh: torch.Tensor | None = None,
    num_data: torch.Tensor | None = None,
    subset_idx: torch.Tensor | None = None,
):
    """Solve, score and refine given samples; the deterministic half of
    `ransac`.

    Args:
      sample_idx: [P, B, sample_size] indices into the data rows.
      data: NamedTuple of tensors [P, N, ...].
      mask: [P, N] validity of data rows.
      quality: "inlier", "mle" or "lmed".
      error_thresh: [P] per-problem squared thresholds (default
        `params.error_thresh`).
      num_data: [P] true counts for the inlier ratio (default N, the
        padded count, as in the JAX package).
      subset_idx: [P, n1] the SPRT subset's rows; required when
        `params.use_Tdd_test`.

    Returns (best_model with leading axis [P], RansacSummary).
    """
    if quality not in ("inlier", "mle", "lmed"):
        raise ValueError(f"unknown RANSAC quality {quality!r}")
    first = data[0]
    P, N = first.shape[:2]
    dtype, device = first.dtype, first.device
    if error_thresh is None:
        thresh = torch.full((P,), params.error_thresh, dtype=dtype, device=device)
    else:
        thresh = torch.as_tensor(error_thresh, dtype=dtype, device=device)
    if num_data is None:
        num_data = torch.full((P,), N, device=device)
    thresh3 = thresh[:, None, None]

    models, valid = estimator.solve(_gather_subset(data, sample_idx))  # [P, B, K]
    flat_models = _map_models(lambda m: m.flatten(1, 2), models)  # [P, BK, ...]
    flat_valid = valid.flatten(1, 2)

    if params.use_Tdd_test:
        if subset_idx is None:
            raise ValueError("use_Tdd_test needs the SPRT subset's indices (subset_idx)")
        flat_models, flat_valid = _sprt_stage(
            flat_models, flat_valid, data, estimator, params, quality, thresh3, mask,
            subset_idx,
        )

    cost = _score_blocks(flat_models, data, estimator, quality, thresh3, mask)  # [P, H]
    if estimator.is_valid is not None:
        flat_valid = flat_valid & estimator.is_valid(flat_models)
    cost = torch.where(flat_valid, cost, torch.inf)

    # First minimum on ties, as jnp.argmin.
    best = torch.argmin(cost, dim=1)  # [P]
    best_model = _map_models(lambda m: _take(m, best[:, None])[:, 0], flat_models)
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]

    def residuals_of(model):
        return estimator.residuals(_map_models(lambda m: m[:, None], model), data)[:, 0]

    # Local optimization: non-minimal refits on the current inlier set,
    # each kept where it is valid and no worse.
    num_lo = 0
    if params.use_lo and estimator.refine is not None:
        res_mask = None if mask is None else mask[:, None, :]
        for _ in range(params.lo_iterations):
            inl = residuals_of(best_model) < thresh[:, None]
            if mask is not None:
                inl = inl & mask
            refined, ok = estimator.refine(best_model, data, inl)
            res_ref = residuals_of(refined)
            if mask is not None:
                res_ref = torch.where(mask, res_ref, torch.inf)
            cost_ref = _cost(res_ref[:, None], quality, thresh3, res_mask)[:, 0]
            better = ok & (cost_ref <= best_cost)
            best_model = type(best_model)(*(
                torch.where(better.view((P,) + (1,) * (old.ndim - 1)), new, old)
                for new, old in zip(refined, best_model)
            ))
            best_cost = torch.where(better, cost_ref, best_cost)
            num_lo += 1

    inliers = residuals_of(best_model) < thresh[:, None]
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
        num_lo_iterations=num_lo,
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
      quality: "inlier", "mle" or "lmed" (the reference's LMed variant).
      error_thresh: [P] per-problem squared thresholds.
      num_data: [P] true counts of padded problems: the inlier ratio's
        denominator and PROSAC's largest prefix (default N).

    Returns (best_model with leading axis [P], RansacSummary).
    """
    first = data[0]
    if mask is None:
        mask = torch.ones(first.shape[:2], dtype=torch.bool, device=first.device)
    sample_idx = _draw_samples(
        generator, mask, params.max_iterations, estimator.sample_size, params.sampler,
        num_data,
    )
    subset_idx = None
    if params.use_Tdd_test:
        subset_idx = _draw_subset(
            generator, mask, sprt_subset_size(params, mask.shape[1], estimator.sample_size)
        )
    return score_samples(
        sample_idx, data, estimator, params, mask=mask, quality=quality,
        error_thresh=error_thresh, num_data=num_data, subset_idx=subset_idx,
    )
