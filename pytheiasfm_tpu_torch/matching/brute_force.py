"""Batched brute-force descriptor matching.

Counterpart of the JAX package's `matching/brute_force.py`
(`theia/matching/brute_force_feature_matcher.cc:48-107`, `distance.h:48`,
`feature_matcher_utils.h:45`): the squared-L2 distance matrix is one matmul
(|a|^2 + |b|^2 - 2ab), Lowe's ratio a row top-2 reduction, and the
symmetric cross-check compares row and column argmins. Masked entries are
+inf here, as in the JAX function (the streaming kernel uses its own finite
sentinel).

`match_descriptors_batch_auto` is the matcher's entry: the K1 kernel
(`streaming_matcher.py`) for CUDA tensors, this plain path for CPU tensors,
which is also what the JAX package runs on the CPU. There is no fallback: a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from .streaming_matcher import _top2_lowest, match_descriptors_batch_streaming

__all__ = [
    "match_descriptor_pair",
    "match_descriptors_batch",
    "match_descriptors_batch_auto",
]


def _distance_matrix(d1, d2, use_bf16: bool):
    """Squared-L2 distances [P, N1, N2]. With `use_bf16` the product takes
    bf16-rounded descriptors upcast to f32, i.e. bf16 products accumulated
    in f32 (`preferred_element_type=f32` in the JAX function)."""
    if use_bf16:
        prod = d1.to(torch.bfloat16).float() @ d2.to(torch.bfloat16).float().mT
    else:
        prod = d1 @ d2.mT
    sq1 = torch.sum(d1.float() ** 2, dim=-1)
    sq2 = torch.sum(d2.float() ** 2, dim=-1)
    return torch.clamp(sq1[..., :, None] + sq2[..., None, :] - 2.0 * prod, min=0.0)


def _top2_min(m):
    """(best, second, argmin) per row of [P, N1, N2]; second = inf for
    1-wide rows. Ties as `lax.top_k`: the lowest index first."""
    if m.shape[-1] >= 2:
        return _top2_lowest(m, -1)
    best = m[..., 0]
    return best, torch.full_like(best, torch.inf), torch.zeros(
        best.shape, dtype=torch.int32, device=m.device
    )


def match_descriptors_batch(
    d1,  # [P, N1, D]
    d2,  # [P, N2, D]
    mask1,  # [P, N1]
    mask2,  # [P, N2]
    lowes_ratio: float,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
    use_bf16: bool = True,
):
    """All image pairs at once. Returns (match_idx [P, N1] int32 — index
    into d2 or -1, distance [P, N1]).

    Mirrors the reference's forward Lowe's-ratio pass + symmetric
    intersection (`brute_force_feature_matcher.cc:48-107`).
    """
    dist = _distance_matrix(d1, d2, use_bf16)
    dist = torch.where(mask2[..., None, :], dist, torch.inf)
    dist = torch.where(mask1[..., :, None], dist, torch.inf)
    ratio2 = torch.tensor(lowes_ratio, dtype=dist.dtype, device=dist.device) ** 2

    best, second, fwd_idx = _top2_min(dist)
    ok = mask1 & torch.isfinite(best)
    if use_lowes_ratio:
        ok &= best < ratio2 * second

    if keep_only_symmetric:
        best_r, second_r, rev_idx = _top2_min(dist.mT)  # rev_idx -> into d1
        ok_r = torch.isfinite(best_r)
        if use_lowes_ratio:
            ok_r &= best_r < ratio2 * second_r
        fwd = fwd_idx.long()
        rows = torch.arange(d1.shape[-2], device=d1.device)
        sym = (torch.gather(rev_idx, -1, fwd) == rows) & torch.gather(ok_r, -1, fwd)
        ok &= sym

    return torch.where(ok, fwd_idx, -1).to(torch.int32), best


def match_descriptor_pair(
    d1,  # [N1, D]
    d2,  # [N2, D]
    mask1,  # [N1] valid rows
    mask2,  # [N2]
    lowes_ratio: float,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
    use_bf16: bool = True,
):
    """One pair: (match_idx [N1] int32 — index into d2 or -1, distance
    [N1])."""
    idx, dist = match_descriptors_batch(
        d1[None], d2[None], mask1[None], mask2[None], lowes_ratio,
        use_lowes_ratio=use_lowes_ratio,
        keep_only_symmetric=keep_only_symmetric,
        use_bf16=use_bf16,
    )
    return idx[0], dist[0]


def match_descriptors_batch_auto(
    d1,
    d2,
    mask1,
    mask2,
    lowes_ratio: float,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
):
    """Device dispatch: the fused K1 kernel for CUDA tensors (at every N),
    the plain matcher for CPU tensors."""
    fn = match_descriptors_batch_streaming if d1.is_cuda else match_descriptors_batch
    return fn(
        d1, d2, mask1, mask2, lowes_ratio,
        use_lowes_ratio=use_lowes_ratio,
        keep_only_symmetric=keep_only_symmetric,
    )
