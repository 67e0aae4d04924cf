"""Point-cloud and reconstruction alignment.

Counterpart of the JAX package's `transforms/alignment.py`
(`theia/sfm/transformation/`): `align_point_clouds.h:52` (closed-form
weighted Umeyama Sim(3)), `align_reconstructions.h:47-59` (align by the
common views' positions, and a RANSAC-robust variant),
`transform_reconstruction.h` (a similarity applied to every camera and
point). The Umeyama solve takes tensors on any device; the reconstruction
functions work on the host container in f64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotation_np import angle_axis_to_rotation_matrix_np, rotation_matrix_to_angle_axis_np

__all__ = [
    "align_point_clouds_umeyama",
    "sim3_transform_points",
    "transform_reconstruction",
    "align_reconstructions",
    "align_reconstructions_robust",
]


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


def transform_reconstruction(recon, R, t, s):
    """Apply a similarity to every camera and point in place.

    Parity: `theia::TransformReconstruction`
    (`transformation/transform_reconstruction.h`): camera position
    c' = s R c + t, camera orientation R_c' = R_c R^T, point X' = s R X + t.
    """
    Rnp, tnp, snp = np.asarray(R), np.asarray(t), float(s)
    V = recon.num_views()
    centers = recon.view_extrinsics[:V, :3]
    recon.view_extrinsics[:V, :3] = snp * (centers @ Rnp.T) + tnp
    R_all = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[:V, 3:])
    recon.view_extrinsics[:V, 3:] = rotation_matrix_to_angle_axis_np(
        np.einsum("vij,kj->vik", R_all, Rnp)
    )
    w = recon.points[:, 3:4]
    wsafe = np.where(np.abs(w) < 1e-12, 1.0, w)
    pts3 = recon.points[:, :3] / wsafe
    recon.points[:, :3] = (snp * (pts3 @ Rnp.T) + tnp) * wsafe


def _common_view_positions(recon1, recon2):
    names = [
        n for n in recon1.view_name_to_id
        if n in recon2.view_name_to_id
        and recon1.view_estimated[recon1.view_name_to_id[n]]
        and recon2.view_estimated[recon2.view_name_to_id[n]]
    ]
    if not names:
        return np.zeros((0, 3)), np.zeros((0, 3))
    p1 = np.stack([recon1.view_extrinsics[recon1.view_name_to_id[n], :3] for n in names])
    p2 = np.stack([recon2.view_extrinsics[recon2.view_name_to_id[n], :3] for n in names])
    return p1, p2


def _umeyama_np(src, ref, weights=None):
    f64 = torch.float64
    R, t, s = align_point_clouds_umeyama(
        torch.as_tensor(src, dtype=f64), torch.as_tensor(ref, dtype=f64),
        None if weights is None else torch.as_tensor(weights, dtype=f64),
    )
    return R.numpy(), t.numpy(), float(s)


def align_reconstructions(recon_to_align, reference_recon):
    """Align `recon_to_align` onto `reference_recon` by the positions of
    their common estimated views. Parity: `theia::AlignReconstructions`
    (`align_reconstructions.h:47`). Returns (R, t, s)."""
    p_src, p_ref = _common_view_positions(recon_to_align, reference_recon)
    if len(p_src) < 3:
        raise ValueError("need >= 3 common estimated views to align")
    R, t, s = _umeyama_np(p_src, p_ref)
    transform_reconstruction(recon_to_align, R, t, s)
    return R, t, s


def align_reconstructions_robust(
    recon_to_align,
    reference_recon,
    robust_error_threshold: float = 2.0,
    num_iterations: int = 100,
    rng=None,
):
    """RANSAC over triples of common view positions, then a weighted
    Umeyama on the best inlier set. Parity:
    `theia::AlignReconstructionsRobust` (`align_reconstructions.h:55`);
    the triples come from `rng` (numpy, default seed 0) as in the JAX
    package. Returns (R, t, s)."""
    rng = rng or np.random.default_rng(0)
    p_src, p_ref = _common_view_positions(recon_to_align, reference_recon)
    n = len(p_src)
    if n < 3:
        raise ValueError("need >= 3 common estimated views to align")
    best, best_inliers = None, -1
    for _ in range(num_iterations):
        idx = rng.choice(n, size=3, replace=False)
        R, t, s = _umeyama_np(p_src[idx], p_ref[idx])
        resid = np.linalg.norm(s * (p_src @ R.T) + t - p_ref, axis=-1)
        inl = int((resid < robust_error_threshold).sum())
        if inl > best_inliers:
            best_inliers = inl
            best = resid < robust_error_threshold
    R, t, s = _umeyama_np(p_src, p_ref, best.astype(np.float64))
    transform_reconstruction(recon_to_align, R, t, s)
    return R, t, s
