"""Triplet baseline ratios from triangulated feature depths.

Counterpart of the JAX package's `global_pose/triplet_baseline.py`
(`theia/sfm/global_pose_estimation/compute_triplet_baseline_ratios.{h,cc}`,
decl `:48`): each relative pose of a view triplet (1-2, 1-3, 2-3) has a
unit-norm baseline; triangulating the features common to all three views
recovers consistent relative scales as depth ratios, with the median over
features as the robust estimate. All features go as one masked batch, with
a masked median.

The cheirality gate is the JAX package's (`triplet_baseline.py:50-60`): a
feature whose midpoint lies behind either camera of a pair is dropped,
where the reference keeps it.
"""

from __future__ import annotations

import math

import torch

from ..ops import rotation as rotops

__all__ = ["compute_triplet_baseline_ratios"]

_MIN_TRIANGULATION_ANGLE_DEG = 2.0  # kMinTriangulationAngle (.cc:61)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pair_depths(aa2, pos2, f1, f2):
    """Midpoint-triangulate feature pairs [N, 3] under a unit-baseline
    relative pose; return (depth1, depth2, valid), each [N]. Mirrors
    GetTriangulatedPointDepths (.cc:55-87): origins {0, position_2},
    directions {f1, R2ᵀ f2}, a sufficient-angle gate, the midpoint, depths
    to both origins; then the cheirality gate."""
    d1 = f1 / torch.linalg.norm(f1, dim=-1, keepdim=True)
    f2n = f2 / torch.linalg.norm(f2, dim=-1, keepdim=True)
    d2 = rotops.angle_axis_rotate_point((-aa2).expand_as(f2n), f2n)

    # Sufficient triangulation angle between the two rays.
    cos_ang = torch.clamp(_dot(d1, d2), -1.0, 1.0)
    ok = cos_ang < math.cos(math.radians(_MIN_TRIANGULATION_ANGLE_DEG))

    # Midpoint of the closest points on the two rays:
    #   argmin_{t1,t2} |t1 d1 - (p2 + t2 d2)|^2.
    b = pos2
    d1d2 = _dot(d1, d2)
    denom = 1.0 - d1d2 * d1d2
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    bd1, bd2 = _dot(b, d1), _dot(b, d2)
    t1 = (bd1 - bd2 * d1d2) / denom
    t2 = (bd1 * d1d2 - bd2) / denom
    point = 0.5 * (t1[:, None] * d1 + (b + t2[:, None] * d2))

    depth1 = torch.linalg.norm(point, dim=-1)
    depth2 = torch.linalg.norm(point - pos2, dim=-1)
    ok = ok & (t1 > 0) & (t2 > 0) & torch.isfinite(depth1) & torch.isfinite(depth2)
    return depth1, depth2, ok


def _masked_median(values, mask):
    order = torch.sort(torch.where(mask, values, torch.inf)).values
    mid = torch.clamp(torch.sum(mask) // 2, 0, values.shape[0] - 1)
    return torch.gather(order, 0, mid.reshape(1))[0]


def compute_triplet_baseline_ratios(
    aa12, pos12,  # relative pose 1->2 (angle-axis, unit-ish position)
    aa13, pos13,  # relative pose 1->3
    aa23, pos23,  # relative pose 2->3
    f1, f2, f3,   # [N, 2] NORMALIZED feature coordinates per view
    mask,         # [N] valid correspondences
):
    """Returns (baseline [3] = (1, b12_13, b12_23), num_valid).

    Parity: `theia::ComputeTripletBaselineRatios` (.cc:91-160): the ratios
    are medians of depth1_12/depth1_13 and depth2_12/depth2_23 over the
    features that triangulate in all three pairs; num_valid == 0 means
    failure (the reference returns false). Tensors on one device."""
    ones = torch.ones((f1.shape[0], 1), dtype=f1.dtype, device=f1.device)
    h1, h2, h3 = (torch.cat([f, ones], dim=1) for f in (f1, f2, f3))

    d1_12, d2_12, ok12 = _pair_depths(aa12, pos12, h1, h2)
    d1_13, _, ok13 = _pair_depths(aa13, pos13, h1, h3)
    d2_23, _, ok23 = _pair_depths(aa23, pos23, h2, h3)
    valid = mask & ok12 & ok13 & ok23
    ratio2 = d1_12 / torch.where(d1_13 == 0, 1e-12, d1_13)
    ratio3 = d2_12 / torch.where(d2_23 == 0, 1e-12, d2_23)
    b2 = _masked_median(ratio2, valid)
    b3 = _masked_median(ratio3, valid)
    n = torch.sum(valid)
    one = torch.ones((), dtype=f1.dtype, device=f1.device)
    baseline = torch.stack([one, torch.where(n > 0, b2, 0.0), torch.where(n > 0, b3, 0.0)])
    return baseline, n
