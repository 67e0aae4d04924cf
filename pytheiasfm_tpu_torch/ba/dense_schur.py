"""Dense-Schur LM bundle adjustment: the calibrated configuration's solver.

Counterpart of the JAX package's `ba/dense_schur.py` (`bundle_adjust_dense`,
`joint_covariance_dense`): the reference's SPARSE_SCHUR below
`min_cameras_for_iterative_solver` cameras
(`reconstruction_estimator_options.h:291-300`). Points are eliminated track
by track and the reduced camera system, a [6V, 6V] matrix (Vp = 768 at 553
views: 85 MB in f32), is materialized and solved directly:

  layout    observations in the padded [T, L] track-slot layout; the
            point-side sums (V_t = Jp^T Jp, bp) are dense sums over L;
  Schur     S = U + mu D - sum_t sum_{l, l'} Z_tl W_tl'^T, Z = W V^-1, with
            W_tl = Jc_tl^T Jp_tl: each track's slot-pair blocks [L, L, 6, 6],
            formed in chunks of 4096 tracks, are subtracted from S viewed as
            [V, V, 6, 6] by `index_add_` over the pair index v_l V + v_l'
            (loop-invariant, built once);
  solve     `torch.linalg.cholesky_ex` and triangular solves; a failed
            factorization makes the step non-finite, so LM rejects it, as
            the JAX kernel's NaN step is. The points back-substitute track by
            track.

The JAX kernel places every coupling block into a dense [Tc, V, 6, 3]
operand by one-hot matmuls and contracts 3 Tc deep (a TPU form: 7.3e12
operations an LM iteration at 553 views); the pair blocks are the same sum
in 8.9e8. `use_mixed_precision_solves` rounds Z and W to bf16 before the
block products, which accumulate in the state's dtype (the JAX `mm_dtype`
cast: a bf16 product is exact in f32, so only the order of the sum
differs). The LM loop is `lm.run_lm`. XYZW and XYZW_MANIFOLD tracks,
per-DOF camera freezing, view priors and frozen intrinsics; free intrinsics
and INVERSE_DEPTH go to the other kernels.

With a mesh (the JAX kernel's `shard_map` over the track axis) each rank
forms the pair blocks of its block of the tracks, and one `all_reduce`
sums them before the Cholesky; the rest is replicated on every rank, the
LM decisions are rank 0's, and every rank returns rank 0's result.
"""

from __future__ import annotations

import torch

from ..ops.segment import segment_sum
from ..parallel.sharding import mesh_axis
from .iterative_schur import _abt
from .lm import (
    BundleAdjustmentOptions,
    _free_masks,
    _Problem,
    _prior_cost,
    _prior_terms,
    inv_small_spd,
    run_lm,
)
from .losses import loss_rho

__all__ = ["bundle_adjust_dense", "joint_covariance_dense", "DENSE_SCHUR_MAX_CAMERAS"]

# AUTO's crossover to the iterative Schur, as the reference's
# `min_cameras_for_iterative_solver` (=1000).
DENSE_SCHUR_MAX_CAMERAS = 1024

# Tracks a chunk of the pair-block products ([4096, L, L, 6, 6]: 21 MB in
# f32 at L = 6), the JAX kernel's TCHUNK.
_TRACK_CHUNK = 4096


class _Layout:
    """The slot layout's loop-invariant pieces: the flat observation table
    over the [T, L] slots and each track chunk's pair indices."""

    def __init__(self, view_group, group_model_idx, track_views, obs_uv, obs_sqrt_info,
                 obs_mask, present_models, num_views, num_tracks, max_track_len, options,
                 dtype, comm=None):
        V, T, L = num_views, num_tracks, max_track_len
        O = T * L
        dev = track_views.device
        self.V, self.T, self.L = V, T, L
        self.track_views = track_views.long()
        obs_view = self.track_views.reshape(O)
        obs_track = torch.arange(T, device=dev).repeat_interleave(L)
        self.prob = _Problem(
            (obs_view, obs_track, obs_uv.reshape(O, 2), obs_sqrt_info.reshape(O, 2),
             obs_mask.reshape(O)),
            view_group, torch.zeros(T, dtype=torch.long, device=dev),
            torch.zeros((T, 3), dtype=dtype, device=dev), present_models, group_model_idx,
            options.track_parametrization_type, options.loss_function_type,
            options.robust_loss_width, dtype)
        tv = self.track_views
        # This rank's block of the tracks (all of them on one device).
        self.comm = comm
        first, last = (0, T) if comm is None else comm.block(T)
        self.chunks = [
            (lo, min(last, lo + _TRACK_CHUNK),
             (tv[lo:min(last, lo + _TRACK_CHUNK), :, None] * V
              + tv[lo:min(last, lo + _TRACK_CHUNK), None, :]).reshape(-1))
            for lo in range(first, last, _TRACK_CHUNK)
        ]

    @staticmethod
    def point_blocks(Jc, Jp):
        """(Vt [T, 3, 3], W [T, L, 6, 3]) of slot Jacobians [T, L, 2, .]."""
        return torch.sum(Jp.mT @ Jp, dim=1), Jc.mT @ Jp

    def schur(self, diag_blocks, W, Z, mm_dtype):
        """S = diag(diag_blocks) - sum_t sum_{l, l'} Z_tl W_tl'^T as [6V, 6V],
        symmetrized."""
        V, dtype = self.V, W.dtype
        if mm_dtype != dtype:
            W, Z = W.to(mm_dtype).to(dtype), Z.to(mm_dtype).to(dtype)
        pairs = torch.zeros((V * V, 6, 6), dtype=dtype, device=W.device)
        for lo, hi, pair in self.chunks:
            prod = _abt(Z[lo:hi, :, None], W[lo:hi, None])  # [Tc, L, L, 6, 6]
            pairs.index_add_(0, pair, prod.reshape(-1, 6, 6))
        if self.comm is not None:
            pairs = self.comm.sum(pairs)
        S = -pairs.reshape(V, V, 6, 6).permute(0, 2, 1, 3)
        ar = torch.arange(V, device=W.device)
        S[ar, :, ar, :] += diag_blocks
        S = S.reshape(6 * V, 6 * V)
        return 0.5 * (S + S.T)


def bundle_adjust_dense(extrinsics, intrinsics, points, view_group, group_model_idx,
                        track_views, obs_uv, obs_sqrt_info, obs_mask, camera_free,
                        point_free, present_models: tuple, num_views: int, num_tracks: int,
                        max_track_len: int, num_groups: int,
                        options: BundleAdjustmentOptions, priors=None, mesh=None):
    """LM to convergence with the dense Schur on the device of the input
    tensors. Returns (extrinsics, intrinsics, points, summary); the
    intrinsics are constant.

    extrinsics [V, 6], intrinsics [G, P], points [T, 3] or [T, 4]
    (XYZW_MANIFOLD), view_group [V], group_model_idx [G], the slot layout
    (track_views [T, L], obs_uv and obs_sqrt_info [T, L, 2], obs_mask
    [T, L]), camera_free [V] or [V, 6], point_free [T]. `priors`: the
    entry's 9-tuple of per-view prior arrays, or None. `mesh`: every rank
    passes the whole problem and sums the Schur pair blocks of its block of
    the tracks (see the module doc)."""
    dtype, dev = extrinsics.dtype, extrinsics.device
    V, T, L = num_views, num_tracks, max_track_len
    comm = mesh_axis(mesh)
    lay = _Layout(view_group, group_model_idx, track_views, obs_uv, obs_sqrt_info, obs_mask,
                  present_models, V, T, L, options, dtype, comm)
    prob = lay.prob
    if prob.invdepth:
        raise ValueError("bundle_adjust_dense does not support INVERSE_DEPTH; "
                         "use lm.bundle_adjust")
    ov, ot = prob.obs_view, prob.obs_track
    tv = lay.track_views
    cam_free, pt_free = _free_masks(camera_free, point_free, options, V, dtype)
    intr_rows = intrinsics[prob.obs_group]
    mm_dtype = torch.bfloat16 if options.use_mixed_precision_solves else dtype
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    def cost_of(state):
        ext, pts = state
        return prob.cost(ext, intrinsics, pts, intr_rows=intr_rows) + _prior_cost(ext, priors)

    def lm_step(state, mu):
        ext_c, pts_c = state
        r, Jc, _, _, Jp, _ = prob.residuals(ext_c, intrinsics, pts_c, with_jac=True,
                                            want_intr_jac=False, intr_rows=intr_rows)
        Jc = (Jc * cam_free[ov][:, None, :]).reshape(T, L, 2, 6)
        Jp = (Jp * pt_free[ot][:, None, :]).reshape(T, L, 2, 3)
        r = r.reshape(T, L, 2)
        r_pr, J_pr = _prior_terms(ext_c, priors, cam_free)

        # Point side: dense sums over the slots.
        Vt, W = lay.point_blocks(Jc, Jp)
        diagVt = torch.diagonal(Vt, dim1=-2, dim2=-1)
        Vinv = inv_small_spd(Vt + mu * (eye3 * torch.clamp(diagVt, min=1e-6)[..., None, :])
                             + 1e-10 * eye3, 3)
        bp = -torch.sum(Jp * r[..., None], dim=(1, 2))  # [T, 3]
        Z = W @ Vinv[:, None]  # [T, L, 6, 3]

        # Camera side: segment sums over the observations' views.
        Jc_o = Jc.reshape(T * L, 2, 6)
        bc = -segment_sum(torch.sum(Jc_o * r.reshape(-1, 2, 1), dim=1), ov, V)
        Dc = segment_sum(torch.sum(Jc_o * Jc_o, dim=1), ov, V)
        Uv = segment_sum(Jc_o.mT @ Jc_o, ov, V)
        if J_pr is not None:
            bc = bc - torch.sum(J_pr * r_pr[..., None], dim=1)
            Dc = Dc + torch.sum(J_pr * J_pr, dim=1)
            Uv = Uv + J_pr.mT @ J_pr
        Dc = torch.clamp(Dc, min=1e-6)

        # Reduced RHS g = bc - W V^-1 bp.
        u = torch.sum(Vinv * bp[:, None, :], dim=-1)  # [T, 3]
        w_slot = torch.sum(W * u[:, None, None, :], dim=-1)  # [T, L, 6]
        g = bc - segment_sum(w_slot.reshape(T * L, 6), ov, V)

        # S: U blocks + LM damping + frozen-DOF identity + ridge on the
        # diagonal, minus the pair blocks.
        diag_blocks = (Uv + mu * (eye6 * Dc[..., None, :])
                       + (1.0 - cam_free)[..., None, :] * eye6 + 1e-8 * eye6)
        S = lay.schur(diag_blocks, W, Z, mm_dtype)
        chol, info = torch.linalg.cholesky_ex(S)
        dxc = torch.cholesky_solve(g.reshape(-1, 1), chol).reshape(V, 6)
        dxc = torch.where(info == 0, dxc, nan)
        dc = dxc * cam_free

        # Back-substitute the points: dp = V^-1 (bp - W^T dxc).
        s = torch.sum(W * dc[tv][..., None], dim=(1, 2))  # [T, 3]
        dp = torch.sum(Vinv * (bp - s)[:, None, :], dim=-1) * pt_free
        new_state = (ext_c + dc, prob.apply_step(pts_c, dp))
        pred = 0.5 * (torch.sum(dc * (mu * Dc * dc + bc))
                      + torch.sum(dp * (mu * torch.clamp(diagVt, min=1e-6) * dp + bp)))
        return new_state, pred, torch.all(torch.isfinite(dxc)), 0

    (ext, pts), summary = run_lm(cost_of, lm_step, (extrinsics, points), options, "dense", comm)
    if comm is not None:
        ext, pts = comm.broadcast(ext), comm.broadcast(pts)
    return ext, intrinsics, pts, summary


def joint_covariance_dense(extrinsics, intrinsics, points, view_group, group_model_idx,
                           track_views, obs_uv, obs_sqrt_info, obs_mask, camera_free,
                           point_free, present_models: tuple, num_views: int,
                           num_tracks: int, max_track_len: int, num_groups: int,
                           options: BundleAdjustmentOptions):
    """Exact joint-problem marginal covariances through the dense Schur
    complement (the general `ceres::Covariance` on the full problem,
    `bundle_adjuster.cc:660-744`):

      cov(cams)   = sigma^2 S^-1             (S = U - W V^-1 W^T, mu = 0)
      cov(track)  = sigma^2 (V_t^-1 + Y_t^T S^-1 Y_t),  Y_t = W_t V_t^-1

    Frozen (gauge) cameras carry identity rows, their blocks placeholders.
    Returns (cam_cov [V, 6, 6], track_cov [T, 3, 3], cost, num_residuals)
    without the sigma^2 factor, which the caller applies."""
    dtype, dev = extrinsics.dtype, extrinsics.device
    V, T, L = num_views, num_tracks, max_track_len
    lay = _Layout(view_group, group_model_idx, track_views, obs_uv, obs_sqrt_info, obs_mask,
                  present_models, V, T, L, options, dtype)
    prob = lay.prob
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
    Z = W @ Vinv[:, None]  # [T, L, 6, 3]: Y_t's rows
    Uv = segment_sum(Jc.mT @ Jc, prob.obs_view, V)
    S = lay.schur(Uv + (1.0 - cam_free)[..., None, :] * eye6 + 1e-8 * eye6, W, Z, dtype)
    chol = torch.linalg.cholesky(S)
    Sb = torch.cholesky_solve(torch.eye(6 * V, dtype=dtype, device=dev), chol).reshape(V, 6, V, 6)
    ar = torch.arange(V, device=dev)
    cam_cov = Sb[ar, :, ar, :]
    # Track marginals V^-1 + sum_{a, b} Z_a^T S^-1[v_a, v_b] Z_b, by chunks.
    tv = lay.track_views
    parts = []
    for lo in range(0, T, 2048):
        t = tv[lo:lo + 2048]
        Sg = Sb[t[:, :, None], :, t[:, None, :], :]  # [Tc, L, L, 6, 6]
        Zc = Z[lo:lo + 2048]
        parts.append(torch.einsum("taki,tabkl,tblj->tij", Zc, Sg, Zc))
    track_cov = Vinv + torch.cat(parts)
    # The variance factor's cost is the robust rho(s), which the
    # Gauss-Newton covariance is defined against.
    cost = torch.sum(loss_rho(s, options.loss_function_type, options.robust_loss_width)
                     * prob.maskf)
    return cam_cov, track_cov, 0.5 * cost, 2.0 * torch.sum(prob.maskf)
