"""Iterative-Schur LM bundle adjustment: the main path's solver.

Counterpart of the JAX package's `ba/iterative_schur.py`
(`bundle_adjust_iterative`, `_bundle_adjust_iterative_impl`): the
reference's ITERATIVE_SCHUR + SCHUR_JACOBI configuration
(`reconstruction_estimator_options.h:291-300`). Points are eliminated per
track; PCG solves the camera system

    S~ x = g,  S~ = S_cc - B Sq^-1 B^T,  S x = Jc^T (y - Jp V^-1 Jp^T y) + mu D x

applied matrix-free, with the Schur-Jacobi (6x6 block) preconditioner.

Observations live in two layouts, built by `ba/entry.py`:
  track-slot    [T, L]  (L the padded longest track): residuals,
                Jacobians and the point-side sums, dense over the slot axis;
  view-rowchunk [R, C]  rows of up to C observations of one view, `rc_src`
                indexing back into the flat [T*L] slots: the camera-side
                sums gather into rows, sum over C, then add rows into their
                view by `index_add_`.

Free intrinsics (the reference default optimizes focal length and radial
distortion, `reconstruction_estimator_options.h:281-284`):
  - one shared group (G == 1): the intrinsics block is eliminated exactly
    before PCG (bordered Schur), on its statically free columns only (3 of
    10 for PINHOLE focal+radial; the state stays [G, P] and the step
    scatters back);
  - several groups: the intrinsics join the PCG state as a [G, P] block
    with its own block-Jacobi preconditioner.

Above 1024 views a two-level preconditioner adds an exact coarse Schur
complement over aggregates of consecutive views, Cholesky-factored once an
LM iteration. The gate, the aggregate size and the track subsample of the
coarse build are computed from the sizes the kernel is given; `ba/entry.py`
pads views and tracks as the JAX entry does, so they switch at the same
scenes (553 views pad to 768: no coarse level).

Loop control is the JAX kernel's (`lm._pcg`, `lm.run_lm`): PCG stops at
`linear_solver_iterations` or when |r|^2 <= tol^2 |g|^2, LM accepts a step
that lowers a finite cost, updates the damping from the gain ratio, and
stops when the relative cost change of a step, accepted or not, falls below
`function_tolerance`. Both loops read their stopping test on the host once
an iteration, so they run the iterations the JAX `while_loop`s run. View
priors add their 6x6 blocks to the diagonal (and the coarse level's
extras). `use_mixed_precision_solves`
rounds the PCG matvec's operands to bf16 (accumulation stays in the state's
dtype).

On a mesh (the JAX kernel with its slot and rowchunk arrays sharded over
the device mesh, GSPMD inserting the collectives) the track-slot inputs and
the points are this rank's block of the tracks, and its view rowchunks are
those of its own slots. Every sum into views, groups or the coarse level,
the exactly eliminated intrinsics block, the cost and the points' share of
the predicted decrease are all-reduced; the camera state stays replicated,
the LM and PCG decisions are rank 0's, the points are gathered at the end
and every rank returns rank 0's result.

The JAX kernel's TPU forms are not copied (one-hot matmuls in place of
scatter, the 64-float row padding and fusion barrier, the `lax.scan`
chunked build, the closed-form inverse of the Schur-Jacobi blocks). The
blocks are inverted by pivoted LU: on the near-singular blocks of weakly
observed views (condition numbers to 1e9) the closed form `inv_small_spd`
errs by up to 1.8e-4 of the preconditioned residual, and at small damping
that error, not the problem, decided whether LM took a step. The Jacobians are forward-mode,
all directions of a slot in one pass of `torch.autograd.forward_ad` (not
`torch.func.jvp`, which gives f64 tangents for 0-dim f32 tensors).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from ..models.intrinsics import intrinsics_subset_mask
from ..parallel.sharding import mesh_axis
from .lm import (
    BundleAdjustmentOptions,
    OptimizeIntrinsicsType,
    TrackParametrizationType,
    _free_masks,
    _pcg,
    _point_tangent_basis4,
    _prior_cost,
    _prior_terms,
    _residual_at_point,
    inv_small_spd,
    run_lm,
)
from .losses import loss_rho, loss_weight

__all__ = ["bundle_adjust_iterative"]

# Slot count above which the JAX kernel builds its blocks in chunks of
# tracks; past it the coarse level is built from every 4th track. The port
# builds in one pass and keeps the threshold for the subsample.
_SCAN_SLOT_THRESHOLD = 1_100_000
_COARSE_TARGET = 160


# Small batched products as sums over the tiny contraction axis (the JAX
# kernel's forms; on the card they are a few elementwise kernels where
# cuBLAS would take one batched product of tiny matrices).
def _atb(a, b):
    """a^T b over the last two axes: einsum('...ri,...rx->...ix')."""
    return sum(a[..., k, :, None] * b[..., k, None, :] for k in range(a.shape[-2]))


def _ab(a, b):
    """einsum('...ij,...jk->...ik')."""
    return sum(a[..., :, k, None] * b[..., None, k, :] for k in range(a.shape[-1]))


def _abt(a, b):
    """einsum('...ik,...jk->...ij')."""
    return sum(a[..., :, None, c] * b[..., None, :, c] for c in range(a.shape[-1]))


def _av(a, x):
    """einsum('...ij,...j->...i')."""
    return torch.sum(a * x[..., None, :], dim=-1)


def _diag(a):
    return torch.diagonal(a, dim1=-2, dim2=-1)


class _Problem:
    """The loop-invariant part of one solve: sizes, masks, index maps."""

    def __init__(self, extrinsics, intrinsics, points, view_group, group_model_idx,
                 track_views, obs_uv, obs_sqrt_info, obs_mask, row_view, rc_src, rc_mask,
                 camera_free, point_free, intrinsics_free, present_models, num_views,
                 num_tracks, max_track_len, num_rows, row_chunk, num_groups, options, priors=None,
                 comm=None):
        self.priors = priors
        self.comm = comm
        tp = options.track_parametrization_type
        if tp == TrackParametrizationType.INVERSE_DEPTH:
            raise ValueError(
                "bundle_adjust_iterative does not support INVERSE_DEPTH; the JAX "
                "package routes it to the flat kernel (lm.bundle_adjust)"
            )
        self.options = options
        self.dtype = dtype = extrinsics.dtype
        self.device = device = extrinsics.device
        # T: the tracks this rank holds (all of them on one device); the
        # size gates read the whole problem's `num_tracks`.
        V, T, L, G = num_views, track_views.shape[0], max_track_len, num_groups
        self.V, self.T, self.L, self.G = V, T, L, G
        self.R, self.C = num_rows, row_chunk
        self.O = T * L
        self.P = P = intrinsics.shape[1]
        self.mm = torch.bfloat16 if options.use_mixed_precision_solves else dtype
        self.manifold = tp == TrackParametrizationType.XYZW_MANIFOLD
        self.present_models = present_models
        self.has_intr = options.intrinsics_to_optimize != OptimizeIntrinsicsType.NONE
        self.exact_elim = self.has_intr and G == 1
        self.joint_intr = self.has_intr and G > 1
        # The statically free intrinsics columns (one shared model: known
        # from the options); otherwise all P.
        free_cols = tuple(range(P))
        if self.exact_elim:
            mask = intrinsics_subset_mask(int(present_models[0]), options.intrinsics_to_optimize)
            free_cols = tuple(i for i in range(P) if i < len(mask) and bool(mask[i])) or free_cols
        self.cols = torch.tensor(free_cols, dtype=torch.long, device=device)
        self.Fi = len(free_cols)
        # Two-level preconditioner: gated, sized and subsampled from the
        # kernel's (padded) sizes, as in the JAX kernel.
        self.use_coarse = V >= 1024
        self.group = 16 * max(1, -(-V // (16 * _COARSE_TARGET)))
        self.Vc = -(-V // self.group)
        self.coarse_stride = 4 if num_tracks * L > _SCAN_SLOT_THRESHOLD else 1

        self.cam_free, self.pt_free = _free_masks(camera_free, point_free, options, V, dtype)
        intr_free = intrinsics_free.to(dtype)

        self.track_views = track_views.long()
        self.view_group = view_group.long()
        self.row_view = row_view.long()
        self.rc_src = rc_src.long()
        self.group_slot = self.view_group[self.track_views]  # [T, L]
        self.model_idx_slot = group_model_idx.long()[self.group_slot]
        if self.use_coarse:
            self.coarse_slot = self.track_views // self.group
            self.coarse_of_view = torch.arange(V, device=device) // self.group
        self.rc_m = rc_mask.to(dtype)
        self.maskf = obs_mask.to(dtype)
        self.obs_uv = obs_uv
        self.obs_sqrt_info = obs_sqrt_info
        self.cam_free_slot = self.cam_free[self.track_views][:, :, None, :]  # [T, L, 1, 6]
        self.pt_free_slot = self.pt_free[:, None, None, :]  # [T, 1, 1, 1]
        if self.has_intr:
            self.intr_freeF = intr_free[:, self.cols]  # [G, Fi]
            self.intr_free_slot = (
                self.intr_freeF[0][None, None, None, :] if G == 1
                else self.intr_freeF[self.group_slot][:, :, None, :]
            )
            self.intr_slot_const = None
        else:
            self.intr_slot_const = (
                intrinsics[0].expand(T, L, P) if G == 1 else intrinsics[self.group_slot]
            )
        self.loss = options.loss_function_type
        self.width = options.robust_loss_width

    # ----------------------------------------------------------- residuals

    def _intr_slot(self, intr_c):
        if not self.has_intr:
            return self.intr_slot_const
        return intr_c[0].expand(self.T, self.L, self.P) if self.G == 1 else intr_c[self.group_slot]

    def _residual_fn(self, pts):
        """f(e6 [.., T, L, 6], q [.., T, L, P], d3 [.., T, L, 3]) -> r
        [.., T, L, 2]: the slot residuals with the point stepped by d3 in
        its chart (tangent basis for manifold points)."""
        pm, uv, si, idx = self.present_models, self.obs_uv, self.obs_sqrt_info, self.model_idx_slot
        if self.manifold:
            basis = _point_tangent_basis4(pts)[:, None]  # [T, 1, 4, 3]
            x4 = pts[:, None, :]  # [T, 1, 4]

            def f(e6, q, d3):
                x4n = x4 + torch.sum(basis * d3[..., None, :], dim=-1)
                w = x4n[..., 3:]
                w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
                return _residual_at_point(e6, q, x4n[..., :3] / w, uv, si, pm, idx)
        else:
            p3 = pts[:, None, :]

            def f(e6, q, d3):
                return _residual_at_point(e6, q, p3 + d3, uv, si, pm, idx)
        return f

    def slot_residuals(self, ext, intr_c, pts, with_jac):
        """(r [T, L, 2], Jc [T, L, 2, 6], Ji [T, L, 2, Fi], Jp [T, L, 2, 3],
        s [T, L]) with the robust weights and the free masks applied; the
        Jacobians are None without `with_jac`."""
        T, L = self.T, self.L
        ext_slot = ext[self.track_views]
        intr_slot = self._intr_slot(intr_c)
        f = self._residual_fn(pts)
        d3 = torch.zeros((T, L, 3), dtype=self.dtype, device=self.device)
        if not with_jac:
            r = f(ext_slot, intr_slot, d3)
            Jc = Ji = Jp = None
        else:
            # Every direction of d(r)/d(e6, free q columns, d3) in one
            # forward-mode pass, the directions on a leading axis.
            Fi = self.Fi if self.has_intr else 0
            D = 6 + Fi + 3
            eye = torch.eye(D, dtype=self.dtype, device=self.device)[:, None, None, :]
            e6_t = eye[..., :6]
            d3_t = eye[..., 6 + Fi:]
            q_t = torch.zeros((D, 1, 1, self.P), dtype=self.dtype, device=self.device)
            if Fi:
                q_t[..., self.cols] = eye[..., 6:6 + Fi]
            def dual(primal, tangent, shape):
                return forward_ad.make_dual(primal.expand(shape).contiguous(),
                                            tangent.expand(shape).contiguous())

            with forward_ad.dual_level():
                out = f(dual(ext_slot, e6_t, (D, T, L, 6)),
                        dual(intr_slot, q_t, (D, T, L, self.P)),
                        dual(d3, d3_t, (D, T, L, 3)))
                r, J = forward_ad.unpack_dual(out)
            r = r[0]
            J = J.permute(1, 2, 3, 0)  # [T, L, 2, D]
            Jc, Ji, Jp = J[..., :6], J[..., 6:6 + Fi], J[..., 6 + Fi:]
        s = torch.sum(r * r, dim=-1)
        w = loss_weight(s, self.loss, self.width) * self.maskf
        sw = torch.sqrt(w)[..., None]
        r = r * sw
        if not with_jac:
            return r, None, None, None, s
        scale = sw[..., None]
        Jc = Jc * scale * self.cam_free_slot
        Jp = Jp * scale * self.pt_free_slot
        Ji = Ji * scale * self.intr_free_slot if self.has_intr else None
        return r, Jc, Ji, Jp, s

    def total(self, x):
        """A sum over this rank's tracks, all-reduced on a mesh."""
        return x if self.comm is None else self.comm.sum(x)

    def cost_of(self, state):
        _, _, _, _, s = self.slot_residuals(*state, with_jac=False)
        return (self.total(0.5 * torch.sum(loss_rho(s, self.loss, self.width) * self.maskf))
                + _prior_cost(state[0], self.priors))

    def apply_step(self, pts, dp):
        if self.manifold:
            new = pts + _av(_point_tangent_basis4(pts), dp)
            n = torch.linalg.norm(new, dim=-1, keepdim=True)
            return new / torch.clamp(n, min=1e-12)
        return pts + dp

    # ------------------------------------------------------------- sums

    def rows_to_views(self, vals_r):  # [R, F] -> [V, F]
        out = torch.zeros((self.V, vals_r.shape[-1]), dtype=vals_r.dtype, device=self.device)
        return self.total(out.index_add_(0, self.row_view, vals_r))

    def views_to_groups(self, vals_v):  # [V, F] -> [G, F]
        out = torch.zeros((self.G, vals_v.shape[-1]), dtype=vals_v.dtype, device=self.device)
        return out.index_add_(0, self.view_group, vals_v)

    def views_to_coarse(self, vals_v):  # [V, ...] -> [Vc, ...]
        out = torch.zeros((self.Vc, *vals_v.shape[1:]), dtype=vals_v.dtype, device=self.device)
        return out.index_add_(0, self.coarse_of_view, vals_v)

    # ------------------------------------------------------------ one step

    def lm_step(self, state, mu):
        """One LM proposal at damping mu: (new state, predicted decrease,
        all-finite flag, PCG steps), the first three tensors on the
        device."""
        dtype, dev = self.dtype, self.device
        V, T, L, G, R, C, O = self.V, self.T, self.L, self.G, self.R, self.C, self.O
        Fi, K = self.Fi, 3
        has_intr, exact_elim, joint_intr = self.has_intr, self.exact_elim, self.joint_intr
        ext_c, intr_c, pts_c = state
        r_t, Jc_t, Ji_t, Jp_t, _ = self.slot_residuals(ext_c, intr_c, pts_c, with_jac=True)
        r_pr, J_pr = _prior_terms(ext_c, self.priors, self.cam_free)
        eyeK = torch.eye(K, dtype=dtype, device=dev)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        eyeF = torch.eye(Fi, dtype=dtype, device=dev)

        # Block products, fused as in the JAX kernel:
        #   X = [Jc | Jp | r (| Ji)]  ->  Jc^T X = [U | W | a (| Jc^T Ji)]
        #                                 Jp^T X = [Vt | bp]   (summed over slots)
        #                                 Ji^T X = [Wi | ai | Ug]
        ops = [Jc_t, Jp_t, r_t[..., None]] + ([Ji_t] if has_intr else [])
        X = torch.cat(ops, dim=-1)  # [T, L, 2, 6 + K + 1 (+ Fi)]
        JcX = _atb(Jc_t, X)
        U_slot = JcX[..., :6]
        W = JcX[..., 6:6 + K]
        a_slot = JcX[..., 6 + K]
        d_slot = _diag(U_slot)
        JpZ = torch.sum(_atb(Jp_t, X[..., 6:6 + K + 1]), dim=1)
        Vt = JpZ[..., :K]
        bp = -JpZ[..., K]
        diagVt = _diag(Vt)
        Vt_d = Vt + mu * (eyeK * torch.clamp(diagVt, min=1e-6)[..., None, :]) + 1e-10 * eyeK
        Vinv = inv_small_spd(Vt_d, K)
        Y = _ab(W, Vinv[:, None])  # [T, L, 6, K]
        packs = [(U_slot - _abt(Y, W)).reshape(T, L, 36), a_slot, d_slot, _av(Y, bp[:, None])]
        if has_intr:
            JiX = _atb(Ji_t, X[..., 6:])
            Wi = JiX[..., :K]  # [T, L, Fi, K]
            ai_slot = JiX[..., K]
            Ug_slot = JiX[..., K + 1:]
        if exact_elim:
            # The shared intrinsics block couples every camera: eliminate it
            # exactly (bordered Schur) so that PCG runs on
            # S~ = S_cc - B Sq^-1 B^T. The point correction needs track-level
            # sums (W V^-1 couples every slot pair of a track).
            Wi_t = torch.sum(Wi, dim=1)  # [T, Fi, K]
            Yi_t = _ab(Wi_t, Vinv)
            ji_cross = JcX[..., 6 + K + 1:]  # [T, L, 6, Fi]
            packs.append((ji_cross - _abt(Y, Wi_t[:, None])).reshape(T, L, 6 * Fi))
            # One all-reduce on a mesh: Sq1, bi1, Di1 and gq1's track sum.
            Sq1 = torch.sum(Ug_slot, dim=(0, 1)) - torch.einsum("tik,tjk->ij", Yi_t, Wi_t)
            sums = self.total(torch.cat([
                Sq1.reshape(-1),
                -torch.sum(ai_slot, dim=(0, 1)),
                torch.sum(_diag(Ug_slot), dim=(0, 1)),
                -torch.einsum("tik,tk->i", Yi_t, bp),
            ]))
            Sq1 = sums[:Fi * Fi].reshape(Fi, Fi)
            bi1, Di1, gq1 = torch.split(sums[Fi * Fi:], Fi)
            Di1 = torch.clamp(Di1, min=1e-6)
            gq1 = bi1 + gq1
        elif joint_intr:
            Yi = _ab(Wi, Vinv[:, None])
            packs += [(Ug_slot - _abt(Yi, Wi)).reshape(T, L, Fi * Fi), ai_slot, _diag(Ug_slot),
                      _av(Yi, bp[:, None])]
        packs.append(Jc_t.reshape(T, L, 12))
        if joint_intr:
            packs.append(Ji_t.reshape(T, L, 2 * Fi))
        pack = torch.cat(packs, dim=-1)
        F = pack.shape[-1]
        Fred = F - 12 - (2 * Fi if joint_intr else 0)  # the columns summed into views
        pack_rc = pack.reshape(O, F)[self.rc_src] * self.rc_m[..., None]  # [R, C, F]
        red = self.rows_to_views(torch.sum(pack_rc[..., :Fred], dim=1))  # [V, Fred]

        Mv = red[:, :36].reshape(V, 6, 6)
        bc = -red[:, 36:42]
        Dc = red[:, 42:48]
        if J_pr is not None:
            pr_blocks = J_pr.mT @ J_pr
            bc = bc - torch.sum(J_pr * r_pr[..., None], dim=1)
            Dc = Dc + torch.sum(J_pr * J_pr, dim=1)
        Dc = torch.clamp(Dc, min=1e-6)
        gc = bc - red[:, 48:54]
        off = 54
        cam_frozen = (1.0 - self.cam_free)[..., None, :] * eye6
        # The exact extras of the diagonal blocks (also the coarse level's).
        extras_v = mu * (eye6 * Dc[..., None, :]) + cam_frozen + 1e-8 * eye6
        if J_pr is not None:
            extras_v = extras_v + pr_blocks
        Mv = Mv + extras_v

        if exact_elim:
            Bv = red[:, off:off + 6 * Fi].reshape(V, 6, Fi)
            Sq_d = (Sq1 + mu * (eyeF * Di1[None, :])
                    + eyeF * (1.0 - self.intr_freeF[0])[None, :] + 1e-8 * eyeF)
            Sq_inv1 = torch.linalg.inv_ex(Sq_d)[0]

            def intr_corr(xc):
                """B Sq^-1 B^T xc: the eliminated block's correction."""
                btx = torch.einsum("vip,vi->p", Bv, xc)
                return torch.einsum("vip,p->vi", Bv, Sq_inv1 @ btx)

            gc = gc - torch.einsum("vip,p->vi", Bv, Sq_inv1 @ gq1)
            Mv = Mv - torch.einsum("vip,pq,vjq->vij", Bv, Sq_inv1, Bv)
        elif joint_intr:
            gi = self.views_to_groups(red[:, off:])
            nF = Fi * Fi
            Mg = gi[:, :nF].reshape(G, Fi, Fi)
            bi = -gi[:, nF:nF + Fi]
            Di = torch.clamp(gi[:, nF + Fi:nF + 2 * Fi], min=1e-6)
            gint = bi - gi[:, nF + 2 * Fi:]
            Mg_d = (Mg + mu * (eyeF * Di[..., None, :])
                    + (1.0 - self.intr_freeF)[..., None, :] * eyeF + 1e-8 * eyeF)
            Mg_inv = torch.linalg.inv_ex(Mg_d)[0]

        Mv_inv = torch.linalg.inv_ex(Mv)[0]  # the Schur-Jacobi blocks, by pivoted LU

        if self.use_coarse:
            chol_c = self._coarse_factor(W, Y, U_slot, extras_v,
                                         (Bv, Sq_inv1) if exact_elim else None)

        # Matvec operands (rounded to bf16 under mixed precision; the
        # products and sums stay in the state's dtype).
        def rnd(x):
            return x.to(self.mm).to(dtype)

        Jc_mv, Jp_mv = rnd(Jc_t), rnd(Jp_t)
        Jc_rc = rnd(pack_rc[..., Fred:Fred + 12].reshape(R, C, 2, 6))
        if joint_intr:
            Ji_mv = rnd(Ji_t)
            Ji_rc = rnd(pack_rc[..., Fred + 12:Fred + 12 + 2 * Fi].reshape(R, C, 2, Fi))
        tv, gs = self.track_views, self.group_slot

        def S_mv(xs):
            xc = xs[0]
            y = torch.sum(Jc_mv * xc[tv][..., None, :], dim=-1)  # [T, L, 2]
            if joint_intr:
                y = y + torch.sum(Ji_mv * xs[1][gs][..., None, :], dim=-1)
            t_ = torch.sum(Jp_mv * y[..., None], dim=(1, 2))  # [T, K]
            z = _av(Vinv, t_)
            w = torch.sum(Jp_mv * z[:, None, None, :], dim=-1)  # [T, L, 2]
            u = rnd(y - w).reshape(O, 2)[self.rc_src]  # [R, C, 2]
            a = self.rows_to_views(torch.sum(Jc_rc * u[..., None], dim=(1, 2)))
            sc = a + mu * Dc * xc
            if J_pr is not None:
                sc = sc + _av(pr_blocks, xc)
            if exact_elim:
                sc = sc - intr_corr(xc)
            if joint_intr:
                ai = self.views_to_groups(
                    self.rows_to_views(torch.sum(Ji_rc * u[..., None], dim=(1, 2))))
                return (sc, ai + mu * Di * xs[1])
            return (sc,)

        def precond(xs):
            pc = _av(Mv_inv, xs[0])
            if self.use_coarse:
                rc = self.views_to_coarse(xs[0]).reshape(-1, 1)
                zc = torch.cholesky_solve(rc, chol_c).reshape(self.Vc, 6)
                pc = pc + zc[self.coarse_of_view]
            if joint_intr:
                return (pc, _av(Mg_inv, xs[1]))
            return (pc,)

        g = (gc, gint) if joint_intr else (gc,)
        dxs, n_pcg = _pcg(S_mv, precond, g, self.options, self.comm)
        dc = dxs[0] * self.cam_free
        if exact_elim:
            # The eliminated intrinsics step: dq = Sq^-1 (gq - B^T dc).
            dq = Sq_inv1 @ (gq1 - torch.einsum("vip,vi->p", Bv, dc))
            di_f = dq[None, :] * self.intr_freeF
        elif joint_intr:
            di_f = dxs[1] * self.intr_freeF
        else:
            di_f = torch.zeros((G, Fi), dtype=dtype, device=dev)
        di = torch.zeros_like(intr_c)
        di[:, self.cols] = di_f  # the compressed step back into [G, P]

        # Back-substitute the points (full precision).
        y = torch.sum(Jc_t * dc[tv][..., None, :], dim=-1)
        if has_intr:
            y = y + torch.sum(Ji_t * di_f[gs][..., None, :], dim=-1)
        t_ = torch.sum(Jp_t * y[..., None], dim=(1, 2))
        dp = _av(Vinv, bp - t_) * self.pt_free

        new_state = (ext_c + dc, intr_c + di, self.apply_step(pts_c, dp))
        pred = 0.5 * (
            torch.sum(dc * (mu * Dc * dc + bc))
            + self.total(torch.sum(dp * (mu * torch.clamp(diagVt, min=1e-6) * dp + bp)))
        )
        if exact_elim:
            pred = pred + 0.5 * torch.sum(di_f * (mu * Di1[None, :] * di_f + bi1[None, :]))
        elif joint_intr:
            pred = pred + 0.5 * torch.sum(di_f * (mu * Di * di_f + bi))
        ok = (torch.all(torch.isfinite(dc))
              & (self.total(torch.sum(~torch.isfinite(dp), dtype=dtype)) == 0)
              & torch.all(torch.isfinite(di)))
        return new_state, pred, ok, n_pcg

    def _coarse_factor(self, W, Y, U_slot, extras_v, elim):
        """Cholesky factor of the coarse Schur complement R^T S~ R over
        aggregates of `group` consecutive views: the exact extras and the
        (subsampled, scaled) per-track Schur complements, whose off-diagonal
        part -(R^T W) V^-1 (W^T R) adds every slot pair of a track into its
        pair of aggregates. A failed factorization gives NaN, as in JAX."""
        Vc, L, dtype, dev = self.Vc, self.L, self.dtype, self.device
        cs = self.coarse_stride
        cslot = self.coarse_slot[::cs]
        Ys, Ws = Y[::cs], W[::cs]
        prod = _abt(Ys[:, :, None], Ws[:, None])  # [Ts, L, L, 6, 6]
        pair = (cslot[:, :, None] * Vc + cslot[:, None, :]).reshape(-1)
        off = torch.zeros((Vc * Vc, 6, 6), dtype=dtype, device=dev)
        off.index_add_(0, pair, prod.reshape(-1, 6, 6))
        off = self.total(off)
        Sc_off = float(cs) * off.reshape(Vc, Vc, 6, 6).permute(0, 2, 1, 3)
        Uc = torch.zeros((Vc, 36), dtype=dtype, device=dev)
        Uc = self.total(Uc.index_add_(0, cslot.reshape(-1), U_slot[::cs].reshape(-1, 36)))
        Sc4 = self.views_to_coarse(extras_v) + float(cs) * Uc.reshape(Vc, 6, 6)
        Sc = torch.zeros((Vc, 6, Vc, 6), dtype=dtype, device=dev)
        arc = torch.arange(Vc, device=dev)
        Sc[arc, :, arc, :] = Sc4
        Sc = Sc - Sc_off
        if elim is not None:
            Bv, Sq_inv1 = elim
            Bc = self.views_to_coarse(Bv)  # [Vc, 6, Fi]
            Sc = Sc - torch.einsum("cip,pq,djq->cidj", Bc, Sq_inv1, Bc)
        Nc = 6 * Vc
        Sc = Sc.reshape(Nc, Nc)
        Sc = 0.5 * (Sc + Sc.T) + 1e-7 * torch.eye(Nc, dtype=dtype, device=dev)
        chol, info = torch.linalg.cholesky_ex(Sc)
        return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def bundle_adjust_iterative(
    extrinsics, intrinsics, points, view_group, group_model_idx, track_views, obs_uv,
    obs_sqrt_info, obs_mask, row_view, rc_src, rc_mask, camera_free, point_free,
    intrinsics_free, present_models: tuple, num_views: int, num_tracks: int,
    max_track_len: int, num_rows: int, row_chunk: int, num_groups: int,
    options: BundleAdjustmentOptions, priors=None, mesh=None,
):
    """LM to convergence with the rowchunk iterative-Schur kernel on the
    device of the input tensors (the LM loop: `lm.run_lm`). Returns
    (extrinsics, intrinsics, points, summary). `priors`: the entry's 9-tuple
    of per-view prior arrays, or None.

    With `mesh`, the track-slot arrays, `points` and `point_free` are this
    rank's block of the `num_tracks` tracks (`num_tracks / mesh size` of
    them), and the rowchunk arrays (`num_rows` x `row_chunk`) lay out this
    rank's slots; the returned points are every rank's, gathered."""
    comm = mesh_axis(mesh)
    prob = _Problem(
        extrinsics, intrinsics, points, view_group, group_model_idx, track_views, obs_uv,
        obs_sqrt_info, obs_mask, row_view, rc_src, rc_mask, camera_free, point_free,
        intrinsics_free, present_models, num_views, num_tracks, max_track_len, num_rows,
        row_chunk, num_groups, options, priors, comm,
    )
    state, summary = run_lm(prob.cost_of, prob.lm_step, (extrinsics, intrinsics, points),
                            options, "iterative", comm)
    if comm is not None:
        ext, intr, pts = state
        state = (comm.broadcast(ext), comm.broadcast(intr), comm.gather(pts))
    summary.size_gates = dict(V=prob.V, T=num_tracks, L=prob.L, use_coarse=prob.use_coarse,
                              group=prob.group, Vc=prob.Vc, coarse_stride=prob.coarse_stride)
    return (*state, summary)
