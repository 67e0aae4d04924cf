"""Point-cloud alignment.

Counterpart of `align_point_clouds_umeyama` and `sim3_transform_points` of
the JAX package's `transforms/alignment.py`
(`theia/sfm/transformation/align_point_clouds.h:52`, the closed-form
weighted Umeyama Sim(3)). The reconstruction transforms and the robust
alignment come with the end-to-end port (ROADMAP item A8).
"""

from __future__ import annotations

import torch

__all__ = ["align_point_clouds_umeyama", "sim3_transform_points"]


def align_point_clouds_umeyama(left, right, weights=None):
    """Weighted Umeyama: find (scale s, rotation R, translation t) minimizing
    sum_i w_i || right_i - (s R left_i + t) ||^2.

    Parity: `theia::AlignPointCloudsUmeyamaWithWeights`
    (`align_point_clouds.h:52+`). left/right [N, 3]; returns (R [3,3],
    t [3], s scalar tensor).
    """
    dtype = left.dtype
    w = torch.ones(left.shape[0], dtype=dtype, device=left.device) if weights is None \
        else weights.to(dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mu_l = w @ left / wsum
    mu_r = w @ right / wsum
    dl = left - mu_l
    dr = right - mu_r
    sigma = (dr * w[:, None]).T @ dl / wsum  # cross-covariance
    var_l = torch.sum(w * torch.sum(dl * dl, dim=-1)) / wsum

    U, D, Vt = torch.linalg.svd(sigma)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.ones(3, dtype=dtype, device=left.device)
    S[2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ torch.diag(S) @ Vt
    s = torch.sum(D * S) / torch.clamp(var_l, min=1e-12)
    t = mu_r - s * (R @ mu_l)
    return R, t, s


def sim3_transform_points(points, R, t, s):
    """x' = s R x + t (batched)."""
    return s * (points @ R.T) + t
