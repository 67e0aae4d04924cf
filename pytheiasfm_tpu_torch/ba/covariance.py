"""Selected-block covariance at any scale by matrix-free Schur solves.

Counterpart of the JAX package's `ba/covariance.py`
(`selected_covariance_pcg`). The exact joint covariance
(`dense_schur.joint_covariance_dense`) inverts the whole [6V, 6V] camera
Schur complement; the reference's `ceres::Covariance`
(`bundle_adjuster.cc:660-744`) works at any scale because it solves only
for the requested blocks. Here the columns of S^-1 of the selected views
come from block-Jacobi-preconditioned CG against the implicit operator

    S x = U x - sum_t Z_t (W_t^T x|_{views of t})          (mu = 0)

with the per-track pieces (U_v, W_t = Jc^T Jp, Z_t = W_t V_t^-1) held in
their track-slot form, the camera-side adjoint a segment sum. A selected
track's marginal, V_t^-1 + sum_ab Z_a^T S^-1[v_a, v_b] Z_b, needs S^-1
columns at its observing views only, which the entry adds to the solve.

The CG is one loop whose convergence test is read on the host every
`cg_chunk_iters` iterations: the JAX function runs that many iterations a
device launch (a TPU watchdog form) and tests between launches, so both
stop after the same iteration. Semantics are the dense path's: frozen
(gauge) cameras carry identity rows with a 1e-8 ridge, the operator is
undamped, and the caller scales by the empirical variance factor.
"""

from __future__ import annotations

import torch

from ..ops.segment import segment_sum
from .dense_schur import _Layout
from .lm import BundleAdjustmentOptions, inv_small_spd
from .losses import loss_rho

__all__ = ["selected_covariance_pcg"]


def _cov_blocks(lay, extrinsics, intrinsics, points, camera_free, point_free, options):
    """The implicit operator's pieces: (Uv, W, Z, Vinv, Minv, cost, nres)."""
    prob = lay.prob
    V, T, L = lay.V, lay.T, lay.L
    dtype, dev = extrinsics.dtype, extrinsics.device
    cam_free = camera_free.to(dtype)[:, None]
    pt_free = point_free.to(dtype)[:, None]
    _, Jc, _, _, Jp, s = prob.residuals(extrinsics, intrinsics, points, with_jac=True,
                                        want_intr_jac=False)
    Jc = Jc * cam_free[prob.obs_view][:, None, :]
    Jp = Jp * pt_free[prob.obs_track][:, None, :]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Vt, W = lay.point_blocks(Jc.reshape(T, L, 2, 6), Jp.reshape(T, L, 2, 3))
    Vinv = inv_small_spd(Vt + (1.0 - pt_free)[..., None] * eye3 + 1e-10 * eye3, 3)
    Z = W @ Vinv[:, None]  # [T, L, 6, 3]
    Uv = segment_sum(Jc.mT @ Jc, prob.obs_view, V)
    Uv = Uv + (1.0 - cam_free)[..., None] * eye6 + 1e-8 * eye6
    # The exact diagonal of S for the block-Jacobi preconditioner: the
    # off-diagonal sum reaches the diagonal only where a slot pairs with
    # itself (a track sees a view once).
    ZWt = (Z @ W.mT).reshape(T * L, 6, 6)
    Sdiag = Uv - segment_sum(ZWt, prob.obs_view, V)
    Minv = inv_small_spd(0.5 * (Sdiag + Sdiag.mT), 6)
    cost = torch.sum(loss_rho(s, options.loss_function_type, options.robust_loss_width)
                     * prob.maskf)
    return Uv, W, Z, Vinv, Minv, 0.5 * cost, 2.0 * torch.sum(prob.maskf)


def _matvec(Uv, W, Z, obs_view, x):
    """S x for a block x [V, 6, K]."""
    V = Uv.shape[0]
    T, L = W.shape[0], W.shape[1]
    K = x.shape[-1]
    xs = x.reshape(V, 6 * K)[obs_view].reshape(T, L, 6, K)
    g = torch.einsum("tlij,tlik->tjk", W, xs)  # [T, 3, K]
    zg = (Z @ g[:, None]).reshape(T * L, 6, K)
    return Uv @ x - segment_sum(zg, obs_view, V)


def selected_covariance_pcg(extrinsics, intrinsics, points, view_group, group_model_idx,
                            track_views, obs_uv, obs_sqrt_info, obs_mask, camera_free,
                            point_free, sel_views, sel_tracks, present_models: tuple,
                            num_views: int, num_tracks: int, max_track_len: int,
                            num_groups: int, options: BundleAdjustmentOptions,
                            cg_iterations: int = 4000, cg_chunk_iters: int = 200):
    """Returns (cam_cov [K, 6, 6], track_cov [Kt, 3, 3], cost, num_residuals,
    relative CG residual) without the sigma^2 factor (the caller applies
    it). sel_views [K]: the views whose S^-1 columns are solved for;
    sel_tracks [Kt]: tracks whose observing views are among them. CG stops
    after `cg_iterations`, or at a check (every `cg_chunk_iters`
    iterations) where the largest relative residual of a column is under
    1e-12 (f64) / 1e-7 (f32), or has not fallen below 0.8 of the last
    check's (the operator's rounding floor)."""
    dtype, dev = extrinsics.dtype, extrinsics.device
    V = num_views
    lay = _Layout(view_group, group_model_idx, track_views, obs_uv, obs_sqrt_info, obs_mask,
                  present_models, V, num_tracks, max_track_len, options, dtype)
    obs_view = lay.prob.obs_view
    Uv, W, Z, Vinv, Minv, cost, nres = _cov_blocks(lay, extrinsics, intrinsics, points,
                                                  camera_free, point_free, options)
    sel_views, sel_tracks = sel_views.long(), sel_tracks.long()
    K6 = 6 * sel_views.shape[0]
    kk = torch.arange(K6, device=dev)
    rhs = torch.zeros((V, 6, K6), dtype=dtype, device=dev)
    rhs[sel_views[kk // 6], kk % 6, kk] = 1.0

    def dot(a, b):
        return torch.sum(a * b, dim=(0, 1))

    tiny = torch.full((), 1e-30, dtype=dtype, device=dev)
    x = torch.zeros_like(rhs)
    r = rhs - _matvec(Uv, W, Z, obs_view, x)
    z = Minv @ r
    p = z
    rz = dot(r, z)
    bnorm = max(float(torch.sqrt(torch.sum(rhs * rhs, dim=(0, 1))).max()), 1e-30)
    tol = 1e-12 if dtype == torch.float64 else 1e-7
    rel, prev_rel = float("inf"), float("inf")
    for it in range(1, cg_iterations + 1):
        Ap = _matvec(Uv, W, Z, obs_view, p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-30, tiny, denom)
        x = x + p * alpha
        r = r - Ap * alpha
        z = Minv @ r
        rz_new = dot(r, z)
        p = z + p * (rz_new / torch.where(torch.abs(rz) < 1e-30, tiny, rz))
        rz = rz_new
        if it % cg_chunk_iters and it < cg_iterations:
            continue
        rel = float(torch.sqrt(torch.sum(r * r, dim=(0, 1))).max()) / bnorm
        if rel < tol or rel > 0.8 * prev_rel:
            break
        prev_rel = rel

    # The selected camera blocks and the selected tracks' marginals.
    Km = sel_views.shape[0]
    cols = x.reshape(V, 6, Km, 6)
    cam_cov = cols[sel_views, :, torch.arange(Km, device=dev), :]  # [Km, 6, 6]
    pos_of_view = torch.full((V,), -1, dtype=torch.long, device=dev)
    pos_of_view[sel_views] = torch.arange(Km, device=dev)
    tv_sel = lay.track_views[sel_tracks]  # [Kt, L]
    pos_b = pos_of_view[tv_sel]
    covered = pos_b >= 0
    Sg = cols[tv_sel[:, :, None], :, torch.clamp(pos_b, min=0)[:, None, :], :]
    Sg = Sg * (covered[:, :, None] & covered[:, None, :]).to(dtype)[..., None, None]
    Z_sel = Z[sel_tracks]
    corr = torch.einsum("taki,tabkl,tblj->tij", Z_sel, Sg, Z_sel)
    return cam_cov, Vinv[sel_tracks] + corr, cost, nres, rel
