"""Levenberg-Marquardt bundle adjustment: the shared pieces and the flat
implicit-PCG kernel.

Counterpart of the JAX package's `ba/lm.py` (the reference's Ceres-based
`bundle_adjuster.{h,cc}`, `bundle_adjustment.{h,cc}`): the options, summary
and enums; the reprojection residual of one observation
(`_residual_at_point`, parity with `theia::ReprojectionError`); the
homogeneous-point tangent bases; the closed-form small inverses; `_Problem`,
which forms the residuals and Jacobians over a flat observation table (XYZW,
XYZW_MANIFOLD and INVERSE_DEPTH tracks; the dense Schur shares it); the
view priors; the Hessian blocks of the covariance entries; the PCG and the
LM loop that every kernel runs; and the flat kernel `bundle_adjust`, which
the entry takes for INVERSE_DEPTH tracks and for problems without a usable
slot layout.

Parameter blocks: extrinsics [V, 6] ([position, angle-axis]), intrinsics
[G, P] per shared intrinsics group, points [T, 3] (XYZW, dehomogenised),
[T, 4] (XYZW_MANIFOLD, a unit 4-vector stepped in a 3-D tangent chart) or
[T, 1] (INVERSE_DEPTH: the inverse depth along a stored bearing of the
track's reference view).

The flat kernel solves the camera system matrix-free, observation by
observation (segment sums by `index_add_`):

    y   = Jc xc[v(o)] + Jr xc[ref(t(o))] + Ji xi[g(o)]
    S x = Jcam^T y - Jcam^T Jp V^-1 Jp^T y + mu D x

by PCG with the Schur-Jacobi preconditioner, and back-substitutes the
points track by track. Its loop control is the JAX kernel's; the PCG
tolerance exit and the LM stop are read on the host once a step, so both
loops run the iterations the JAX `while_loop`s run. The Schur-Jacobi 6x6
blocks are inverted by pivoted LU, as in `ba/iterative_schur.py` (the JAX
kernel's closed form errs on near-singular blocks). Jacobians are
forward-mode, every direction of an observation in one pass of
`torch.autograd.forward_ad`.
"""

from __future__ import annotations

import dataclasses
import enum

import torch
from torch.autograd import forward_ad

from ..models import intrinsics as intr
from ..models.intrinsics import OptimizeIntrinsicsType
from ..ops import rotation as rotops
from ..ops.segment import segment_sum
from ..ops.segment import segment_sum as _segment_sum
from ..parallel.sharding import local_shard, mesh_axis
from .losses import LossFunctionType, loss_rho, loss_weight

__all__ = [
    "BundleAdjustmentOptions",
    "BundleAdjustmentSummary",
    "TrackParametrizationType",
    "LinearSolverType",
    "OptimizeIntrinsicsType",
    "bundle_adjust",
    "hessian_blocks",
    "inv3x3",
    "inv_small_spd",
]


class TrackParametrizationType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:93-95`."""

    XYZW = 0
    XYZW_MANIFOLD = 1
    INVERSE_DEPTH = 2


class LinearSolverType(enum.IntEnum):
    """Camera-system solver selection (parity with the reference's Ceres
    configuration, `reconstruction_estimator_options.h:291-300`): AUTO takes
    the dense Schur at up to `dense_schur.DENSE_SCHUR_MAX_CAMERAS` cameras
    with frozen intrinsics, the iterative Schur otherwise."""

    AUTO = 0
    DENSE_SCHUR = 1
    ITERATIVE_SCHUR = 2


@dataclasses.dataclass(frozen=True)
class BundleAdjustmentOptions:
    """Parity: `theia::BundleAdjustmentOptions` (`bundle_adjustment.h:87-167`),
    every field of the JAX package's options with its default."""

    loss_function_type: LossFunctionType = LossFunctionType.TRIVIAL
    robust_loss_width: float = 2.0
    max_num_iterations: int = 100
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    linear_solver_type: LinearSolverType = LinearSolverType.AUTO
    # bf16 operands with f32 accumulation: the dense Schur's block products
    # and the iterative kernel's PCG matvec, parity:
    # `use_mixed_precision_solves` (`bundle_adjustment.h:111`).
    use_mixed_precision_solves: bool = False
    # PCG controls (ITERATIVE_SCHUR + SCHUR_JACOBI); the tolerance is Ceres's
    # forcing tolerance eta = 0.1.
    linear_solver_iterations: int = 40
    linear_solver_tolerance: float = 0.1
    initial_trust_region_radius: float = 1e4
    # LM iterations a device launch in the JAX package (a TPU watchdog
    # limit; its chunks compute what one loop computes). The port runs one
    # loop; the field is kept for parity and has no effect.
    max_iterations_per_launch: int = 25
    optimize_cameras: bool = True
    optimize_points: bool = True
    intrinsics_to_optimize: OptimizeIntrinsicsType = OptimizeIntrinsicsType.NONE
    track_parametrization_type: TrackParametrizationType = TrackParametrizationType.XYZW
    # View priors (`bundle_adjustment.h:154-166`).
    use_position_priors: bool = False
    use_orientation_priors: bool = False
    use_gravity_priors: bool = False
    verbose: bool = False
    # Device mesh for bundle adjustment over several ranks (a
    # `torch.distributed` `DeviceMesh`, `parallel.make_mesh`; every rank
    # calls the same entry with the same inputs). Through the entry, the
    # dense Schur sums its off-diagonal Schur product track-sharded with one
    # `all_reduce` (`dense_schur.py`), and the iterative Schur shards its
    # slot and rowchunk arrays by tracks and all-reduces every sum into
    # views, groups and the coarse level; the flat kernel, called directly
    # with a mesh, shards its observations. None = one device.
    mesh: object = None


@dataclasses.dataclass
class BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustmentSummary` (`bundle_adjustment.h:170`).
    Plain Python values. `final_mu` is the LM damping at the end;
    `converged` says the function tolerance stopped the loop. The port's
    own: `num_linear_solver_iterations` counts the PCG steps of all LM
    iterations (0 for the direct solve), `linear_solver` names the kernel
    that ran ("dense", "iterative" or "flat"), `size_gates` holds the
    iterative kernel's size gates as it took them (padded `V`, `T`, `L`,
    `use_coarse`, `group`, `Vc`, `coarse_stride`; None for the others)."""

    success: bool
    initial_cost: float
    final_cost: float
    num_iterations: int
    final_mu: float | None = None
    converged: bool | None = None
    num_linear_solver_iterations: int | None = None
    linear_solver: str | None = None
    size_gates: dict | None = None


# ---------------------------------------------------------------------------
# Residuals.
# ---------------------------------------------------------------------------


def _pixel_of(params, p_cam, present_models, model_idx):
    """Project camera-frame points [.., 3] through each row's camera model:
    intrinsics `params` [.., P] and `model_idx` (an index into
    `present_models`, shaped like the rows: the trailing batch axes) broadcast
    against the points.

    With one model present the call is static. With several, the rows are
    partitioned by model and each model sees only its own rows, so one
    model's guards (FISHEYE's atan2, DOUBLE_SPHERE's square roots) never
    meet another model's points or parameters (the JAX package's
    `lax.switch` evaluates every branch on every row and selects). An index
    out of range is clamped, as `lax.switch` clamps it. One host read a
    call: the rows of each model."""
    if len(present_models) == 1:
        return intr.camera_to_pixel(params, p_cam, present_models[0])
    batch = torch.broadcast_shapes(params.shape[:-1], p_cam.shape[:-1])
    lead = batch[:len(batch) - model_idx.dim()]
    n, P = model_idx.numel(), params.shape[-1]
    q = params.expand(*batch, P).reshape(*lead, n, P)
    x = p_cam.expand(*batch, 3).reshape(*lead, n, 3)
    flat = model_idx.reshape(-1).long().clamp(0, len(present_models) - 1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=len(present_models)).tolist()
    parts = []
    for rows, m in zip(torch.split(order, counts), present_models):
        if len(rows):
            parts.append(intr.camera_to_pixel(q.index_select(-2, rows),
                                              x.index_select(-2, rows), m))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n, device=order.device)
    return torch.cat(parts, dim=-2).index_select(-2, inverse).reshape(*batch, 2)


def _residual_at_point(e6, params, p_world, uv, sqrt_info, present_models, model_idx):
    """Weighted reprojection residuals [.., 2] of world points [.., 3].

    Mirrors `theia::ReprojectionError` (`camera/reprojection_error.h:50-115`):
    translate, freeze the residual of a point within 1e-4 of the camera
    centre, rotate, project through the camera model, weight by the sqrt
    information of the feature covariance.
    """
    adjusted = p_world - e6[..., :3]
    too_close = torch.sum(adjusted * adjusted, dim=-1, keepdim=True) < 1e-8
    p_cam = rotops.angle_axis_rotate_point(e6[..., 3:], adjusted)
    pixel = _pixel_of(params, p_cam, present_models, model_idx)
    r = sqrt_info * (pixel - uv)
    return torch.where(too_close, torch.zeros((), dtype=r.dtype, device=r.device), r)


def _tangent_basis4(x4):
    """Orthonormal basis [.., 4, 3] of the tangent space at unit 4-vectors
    x4 [.., 4] (Householder construction: the homogeneous-point manifold of
    `SetHomogeneousPointParametrization`, bundle_adjuster.h:121)."""
    n = torch.linalg.norm(x4, dim=-1, keepdim=True)
    xh = x4 / torch.clamp(n, min=1e-12)
    one = torch.ones((), dtype=x4.dtype, device=x4.device)
    sign = torch.where(xh[..., 3] >= 0, one, -one)
    v = torch.cat([xh[..., :3], xh[..., 3:] + sign[..., None]], dim=-1)
    vv = torch.clamp(torch.sum(v * v, dim=-1), min=1e-12)
    eye = torch.eye(4, dtype=x4.dtype, device=x4.device)
    H = eye - 2.0 * v[..., :, None] * v[..., None, :] / vv[..., None, None]
    return H[..., :, :3]


def _point_tangent_basis4(x4):
    """Well-conditioned projective tangent basis [.., 4, 3] at unit
    4-vectors x4 [.., 4].

    Solves (dp/dx4) B = I_3 on the chart p = xyz / w: B = w B_s inv(M3) with
    M3 = [I | -p] B_s, so the point block is conditioned as in the
    Euclidean parametrization. The orthonormal sphere basis instead carries
    a factor ~1/w a unit step and stalled f32 LM at 0.21 m on the 2152-view
    ring (the JAX package's `ba/lm.py:231-264`). Where |w| <= 1e-3 (points
    near infinity) it falls back to the sphere basis."""
    n = torch.linalg.norm(x4, dim=-1, keepdim=True)
    xh = x4 / torch.clamp(n, min=1e-12)
    Bs = _tangent_basis4(x4)
    w = xh[..., 3]
    safe = torch.abs(w) > 1e-3
    wsafe = torch.where(safe, w, torch.ones_like(w))
    p = xh[..., :3] / wsafe[..., None]
    M3 = Bs[..., :3, :] - p[..., :, None] * Bs[..., 3:4, :]
    Bc = wsafe[..., None, None] * (Bs @ inv3x3(M3))
    return torch.where(safe[..., None, None], Bc, Bs)


def _invdepth_world_point(rho, ref_e6, bearing):
    """World point of an inverse-depth track, X = c_ref + R_ref^T (b / rho)
    (the inverse-depth reprojection functor of the reference, track.h:80-88);
    |rho| is floored at 1e-12."""
    rho = torch.where(torch.abs(rho) < 1e-12, torch.full_like(rho, 1e-12), rho)
    p_ref = bearing * (1.0 / rho)[..., None]
    return ref_e6[..., :3] + rotops.angle_axis_rotate_point(-ref_e6[..., 3:], p_ref)


def _forward_jacobians(f, primals, wants):
    """f(*primals) and its Jacobian [.., R, k] with respect to each primal
    [.., k] whose `wants` is set (None for the others): every direction in
    one forward-mode pass, the directions on a leading axis of the duals
    (which must be contiguous)."""
    widths = [p.shape[-1] if want else 0 for p, want in zip(primals, wants)]
    D = sum(widths)
    ref = primals[0]
    eye = torch.eye(D, dtype=ref.dtype, device=ref.device)
    with forward_ad.dual_level():
        duals, off = [], 0
        for p, k in zip(primals, widths):
            if not k:
                duals.append(p)
                continue
            shape = (D, *p.shape)
            t = eye[:, off:off + k].reshape(D, *([1] * (p.dim() - 1)), k)
            off += k
            duals.append(forward_ad.make_dual(p.expand(shape).contiguous(),
                                              t.expand(shape).contiguous()))
        r, J = forward_ad.unpack_dual(f(*duals))
    J = J.movedim(0, -1)  # [.., R, D]
    out, off = [], 0
    for k in widths:
        out.append(J[..., off:off + k] if k else None)
        off += k
    return r[0], out


class _Problem:
    """The flat observation table of one problem; forms its residuals and
    Jacobians (the JAX package's `ba/lm._Problem`)."""

    def __init__(self, obs, view_group, track_ref_view, track_bearing, present_models,
                 group_model_idx, track_param, loss, loss_width, dtype):
        obs_view, obs_track, self.obs_uv, self.obs_info, obs_mask = obs
        self.obs_view, self.obs_track = obs_view.long(), obs_track.long()
        self.view_group = view_group.long()
        self.obs_group = self.view_group[self.obs_view]
        self.track_ref_view = track_ref_view.long()
        self.track_bearing = track_bearing
        self.present_models = present_models
        self.model_idx_o = group_model_idx.long()[self.obs_group]
        self.track_param = track_param
        self.loss = loss
        self.loss_width = loss_width
        self.dtype = dtype
        self.maskf = obs_mask.to(dtype)
        self.invdepth = track_param == TrackParametrizationType.INVERSE_DEPTH
        self.manifold = track_param == TrackParametrizationType.XYZW_MANIFOLD
        self.K = 1 if self.invdepth else 3
        self.ref_o = self.track_ref_view[self.obs_track] if self.invdepth else None

    def residuals(self, extrinsics, intrinsics, points, with_jac, want_intr_jac=True,
                  intr_rows=None):
        """Robust-weighted residuals r [O, 2] and squared norms s [O]; with
        `with_jac` also Jc [O, 2, 6], Jr [O, 2, 6] (the reference camera of
        an INVERSE_DEPTH track, else None), Ji [O, 2, P] (None unless
        `want_intr_jac`: the frozen-intrinsics specialization) and
        Jp [O, 2, K]. `intr_rows` [O, P]: the observations' intrinsics,
        gathered once by a caller whose intrinsics are constant."""
        ov, ot = self.obs_view, self.obs_track
        ext_o = extrinsics[ov]
        intr_o = intrinsics[self.obs_group] if intr_rows is None else intr_rows
        pm, mi, uv, si = self.present_models, self.model_idx_o, self.obs_uv, self.obs_info
        if self.invdepth:
            bearing_o = self.track_bearing[ot]

            def f(e6, q, rho, re6):
                p_w = _invdepth_world_point(rho[..., 0], re6, bearing_o)
                return _residual_at_point(e6, q, p_w, uv, si, pm, mi)

            primals = [ext_o, intr_o, points[ot], extrinsics[self.ref_o]]
        elif self.manifold:
            x4_o = points[ot]
            basis_o = _point_tangent_basis4(points)[ot]  # [O, 4, 3]

            def f(e6, q, d3):
                x4n = x4_o + torch.sum(basis_o * d3[..., None, :], dim=-1)
                w = x4n[..., 3:]
                w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
                return _residual_at_point(e6, q, x4n[..., :3] / w, uv, si, pm, mi)

            primals = [ext_o, intr_o, torch.zeros_like(ext_o[:, :3])]
        else:
            def f(e6, q, p3):
                return _residual_at_point(e6, q, p3, uv, si, pm, mi)

            primals = [ext_o, intr_o, points[ot]]
        if with_jac:
            wants = [True, want_intr_jac, True, True][:len(primals)]
            r, (Jc, Ji, Jp, *Jr) = _forward_jacobians(f, primals, wants)
            Jr = Jr[0] if Jr else None
        else:
            r = f(*primals)
        # Robust IRLS weights on the squared norm.
        s = torch.sum(r * r, dim=-1)
        sw = torch.sqrt(loss_weight(s, self.loss, self.loss_width) * self.maskf)[..., None]
        if not with_jac:
            return r * sw, s
        scale = sw[..., None]
        return (r * sw, Jc * scale, Jr * scale if self.invdepth else None,
                Ji * scale if want_intr_jac else None, Jp * scale, s)

    def cost(self, extrinsics, intrinsics, points, intr_rows=None):
        _, s = self.residuals(extrinsics, intrinsics, points, with_jac=False,
                              intr_rows=intr_rows)
        return 0.5 * torch.sum(loss_rho(s, self.loss, self.loss_width) * self.maskf)

    def apply_step(self, points, dp):
        """Apply the point update in the parametrization's chart."""
        if self.manifold:
            new = points + torch.sum(_point_tangent_basis4(points) * dp[..., None, :], dim=-1)
            n = torch.linalg.norm(new, dim=-1, keepdim=True)
            return new / torch.clamp(n, min=1e-12)
        return points + dp


# ---------------------------------------------------------------------------
# Small inverses.
# ---------------------------------------------------------------------------


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate over determinant, the
    determinant floored at 1e-30 in magnitude as the JAX package does)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def inv_small_spd(A, K: int):
    """Batched small SPD inverse without a LAPACK loop: closed form for
    K in {1, 3}, a 3+3 block Schur on `inv3x3` for K = 6, `torch.linalg.inv`
    otherwise."""
    if K == 1:
        return 1.0 / torch.where(torch.abs(A) < 1e-30, torch.full_like(A, 1e-30), A)
    if K == 3:
        return inv3x3(A)
    if K == 6:
        A11 = A[..., :3, :3]
        A12 = A[..., :3, 3:]
        A22 = A[..., 3:, 3:]
        A11i = inv3x3(A11)
        S = A22 - A12.mT @ A11i @ A12
        Si = inv3x3(S)
        X = A11i @ A12
        B12 = -(X @ Si)
        B11 = A11i - B12 @ X.mT
        top = torch.cat([B11, B12], dim=-1)
        bot = torch.cat([B12.mT, Si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    return torch.linalg.inv(A)


# ---------------------------------------------------------------------------
# View priors (position / orientation / gravity), camera blocks only.
# ---------------------------------------------------------------------------


def _prior_residual(e6, priors):
    """Prior residuals [.., 9] = [position(3), orientation(3), gravity(3)] of
    extrinsics e6 [.., 6]; `priors` is the entry's 9-tuple of per-view
    arrays (pp, psi, pm, op, osi, om, gp, gsi, gm), the masks zeroing unset
    priors. Parity: `position_error.h` (sqrt_info (p - p_prior)),
    `orientation_error.h` (sqrt_info log(R R_prior^T)), `gravity_error.h`
    (sqrt_info (R (0, 0, -1) - g_prior))."""
    pp, psi, pm, op, osi, om, gp, gsi, gm = (a.to(e6.dtype) for a in priors)

    def mv(m, x):
        return torch.sum(m * x[..., None, :], dim=-1)

    r_pos = mv(psi, e6[..., :3] - pp) * pm[..., None]
    R = rotops.angle_axis_to_rotation_matrix(e6[..., 3:])
    Rp = rotops.angle_axis_to_rotation_matrix(op)
    r_ori = mv(osi, rotops.rotation_matrix_to_angle_axis(R @ Rp.mT)) * om[..., None]
    g_cam = -R[..., :, 2]  # R (0, 0, -1)
    r_grav = mv(gsi, g_cam - gp) * gm[..., None]
    return torch.cat([r_pos, r_ori, r_grav], dim=-1)


def _prior_blocks(extrinsics, priors):
    """Residuals and Jacobians of all view priors: ([V, 9], [V, 9, 6])."""
    r, (J,) = _forward_jacobians(lambda e: _prior_residual(e, priors), [extrinsics], [True])
    return r, J


def _prior_terms(extrinsics, priors, cam_free):
    """(r [V, 9], J [V, 9, 6] with the frozen DOFs' columns zeroed), or
    (None, None) without priors."""
    if priors is None:
        return None, None
    r, J = _prior_blocks(extrinsics, priors)
    return r, J * cam_free[:, None, :]


def _prior_cost(extrinsics, priors):
    if priors is None:
        return 0.0
    r = _prior_residual(extrinsics, priors)
    return 0.5 * torch.sum(r * r)


# ---------------------------------------------------------------------------
# Covariance support blocks (used by the *_with_cov entries).
# ---------------------------------------------------------------------------


def hessian_blocks(extrinsics, points, intrinsics_rows, obs_view, obs_track, obs_uv,
                   obs_sqrt_info, obs_mask, model: int, num_views: int, num_tracks: int,
                   options: BundleAdjustmentOptions):
    """Per-view [V, 6, 6] and per-track [T, 3, 3] Gauss-Newton Hessian
    blocks, the total robust cost and the count of observations.

    These are what `ceres::Covariance` inverts when the other parameter
    group is held constant (`bundle_adjuster.cc:660-744`): for
    BundleAdjustView(s)WithCov / BundleAdjustTrack(s)WithCov the problem is
    block-diagonal, so cov(view) = sigma^2 U_v^-1 exactly."""
    dtype = extrinsics.dtype
    loss, width = options.loss_function_type, options.robust_loss_width
    ov, ot = obs_view.long(), obs_track.long()

    def f(e6, p3):
        return _residual_at_point(e6, intrinsics_rows, p3, obs_uv, obs_sqrt_info, (model,), 0)

    r, (Jc, Jp) = _forward_jacobians(f, [extrinsics[ov], points[ot]], [True, True])
    s = torch.sum(r * r, dim=-1)
    maskf = obs_mask.to(dtype)
    sw = torch.sqrt(loss_weight(s, loss, width) * maskf)[..., None, None]
    Jc, Jp = Jc * sw, Jp * sw
    U = segment_sum(Jc.mT @ Jc, ov, num_views)
    Vt = segment_sum(Jp.mT @ Jp, ot, num_tracks)
    cost = torch.sum(loss_rho(s, loss, width) * maskf)
    return U, Vt, cost, torch.sum(obs_mask)


# ---------------------------------------------------------------------------
# PCG and the LM loop (every kernel's).
# ---------------------------------------------------------------------------


def _dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _pcg(S_mv, precond, g, options, comm=None):
    """Preconditioned CG from 0 on S x = g, x and g tuples of blocks: stops
    after `linear_solver_iterations` or when |r|^2 <= tol^2 |g|^2 (read on
    the host before each iteration, as the JAX `while_loop` tests it).
    Returns (x, the iterations run).

    On a mesh (`comm`, a `parallel.sharding.MeshAxis`) the camera-side
    vectors are replicated, every sum into them all-reduced inside `S_mv`,
    so their dot products are whole on every rank; the stopping test is
    rank 0's, broadcast."""
    tol2 = (options.linear_solver_tolerance ** 2) * _dot(g, g)
    x = tuple(torch.zeros_like(v) for v in g)
    rres = g
    z = precond(g)
    p = z
    rz = _dot(g, z)
    one = torch.ones((), dtype=rz.dtype, device=rz.device)
    it = 0
    while it < options.linear_solver_iterations and _decide(_dot(rres, rres) > tol2, comm):
        Sp = S_mv(p)
        pSp = _dot(p, Sp)
        alpha = rz / torch.where(pSp == 0, one, pSp)
        x = tuple(a + alpha * b for a, b in zip(x, p))
        rres = tuple(a - alpha * b for a, b in zip(rres, Sp))
        z = precond(rres)
        rz_new = _dot(rres, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = tuple(a + beta * b for a, b in zip(z, p))
        rz = rz_new
        it += 1
    return x, it


def _decide(flag, comm) -> bool:
    return bool(flag) if comm is None else comm.decide(flag)


def run_lm(cost_of, lm_step, state, options: BundleAdjustmentOptions, solver: str,
           comm=None):
    """LM to convergence from `state` (a tuple of tensors): `lm_step(state,
    mu)` proposes (new state, predicted decrease, all-finite flag, linear
    solver iterations). Returns (state, summary).

    The JAX kernels' loop control: a step that lowers a finite cost (and is
    finite) is accepted, the damping follows the gain ratio (x4 on a
    rejection), and the loop stops when a step, accepted or not, changes the
    cost by less than `function_tolerance` relative (Ceres semantics), read
    on the host once an iteration. The costs that decide are evaluated in
    f64 whatever the state's dtype (the JAX kernels evaluate them in the
    state's dtype): an f32 cost of a few 100k residuals of pixels near 1000
    carries rounding noise of about 1e-6 of it, the function tolerance, so
    in f32 whether LM takes its last step, and where it stops, fell on that
    noise (ROADMAP.md section 3). The JAX package runs the loop in launches
    of `max_iterations_per_launch` iterations (a TPU watchdog limit),
    carrying the damping, summing the iterations, taking `initial_cost` from
    the first launch and stopping on convergence, which computes what one
    loop computes. A zero-iteration budget returns the state unchanged with
    zero costs, as there.

    On a mesh (`comm`) `cost_of` and `lm_step` return whole (all-reduced)
    costs and decreases, and whether a step is taken and whether the loop
    stops are rank 0's decisions, broadcast."""
    if options.max_num_iterations <= 0:
        return state, BundleAdjustmentSummary(
            success=True, initial_cost=0.0, final_cost=0.0, num_iterations=0,
            final_mu=1.0 / options.initial_trust_region_radius, linear_solver=solver,
        )
    from ..utils import counters

    counters.bump("ba_launch")

    def cost64(st):
        return cost_of(tuple(x.double() for x in st))

    cost = cost64(state)
    initial_cost = cost
    mu = torch.tensor(1.0 / options.initial_trust_region_radius, dtype=state[0].dtype,
                      device=cost.device)
    it, done, linear = 0, False, 0
    while not done and it < options.max_num_iterations:
        new_state, pred, ok, n = lm_step(state, mu)
        linear += n
        new_cost = cost64(new_state)
        actual = cost - new_cost
        accept = ok & (actual > 0) & torch.isfinite(new_cost)
        stop = torch.isfinite(new_cost) & (torch.abs(actual) / torch.clamp(cost, min=1e-30)
                                           < options.function_tolerance)
        if comm is not None:
            accept, stop = comm.broadcast(torch.stack([accept, stop]))
        gain = actual / torch.clamp(pred, min=1e-30)
        shrink = torch.clamp(1.0 - (2.0 * torch.clamp(gain, 0.0, 1.0) - 1.0) ** 3, min=1.0 / 3.0)
        mu = torch.clamp(torch.where(accept, mu * shrink, mu * 4.0), 1e-12, 1e10).to(mu.dtype)
        state = tuple(torch.where(accept, n_, o) for n_, o in zip(new_state, state))
        cost = torch.where(accept, new_cost, cost)
        it += 1
        done = bool(stop)
    if comm is not None:  # rank 0's costs and damping in every rank's summary
        initial_cost, cost, mu = comm.broadcast(
            torch.stack([initial_cost, cost, mu.to(cost.dtype)]))
    initial, final = float(initial_cost), float(cost)
    return state, BundleAdjustmentSummary(
        success=bool(torch.isfinite(cost)) and final <= initial,
        initial_cost=initial,
        final_cost=final,
        num_iterations=it,
        final_mu=float(mu),
        converged=done,
        num_linear_solver_iterations=linear,
        linear_solver=solver,
    )


def _free_masks(camera_free, point_free, options, num_views, dtype):
    """(camera DOFs [V, 6], points [T, 1]) allowed to move, as 0/1 floats;
    camera_free may be [V] (whole cameras) or [V, 6] (per DOF)."""
    if camera_free.ndim == 1:
        camera_free = camera_free[..., None]
    cam_free = (camera_free & options.optimize_cameras).to(dtype).expand(num_views, 6)
    pt_free = (point_free & options.optimize_points)[..., None].to(dtype)
    return cam_free, pt_free


# ---------------------------------------------------------------------------
# The flat implicit-PCG kernel.
# ---------------------------------------------------------------------------


def bundle_adjust(extrinsics, intrinsics, points, view_group, group_model_idx, obs_view,
                  obs_track, obs_uv, obs_sqrt_info, obs_mask, camera_free, point_free,
                  intrinsics_free, track_ref_view, track_bearing, present_models: tuple,
                  num_views: int, num_tracks: int, num_groups: int,
                  options: BundleAdjustmentOptions, priors=None):
    """LM to convergence with the flat implicit-PCG kernel (the JAX
    package's `bundle_adjust` / `_bundle_adjust_impl`) on the device of the
    input tensors. Returns (extrinsics, intrinsics, points, summary).

    extrinsics [V, 6], intrinsics [G, P], points [T, K] (see the module
    doc), view_group [V], group_model_idx [G], the observation table
    (obs_view, obs_track [O], obs_uv, obs_sqrt_info [O, 2], obs_mask [O]),
    camera_free [V] or [V, 6], point_free [T], intrinsics_free [G, P], and
    for INVERSE_DEPTH each track's reference view [T] and bearing [T, 3].
    `priors`: the entry's 9-tuple of per-view prior arrays, or None.

    With `options.mesh` every rank passes the whole problem and keeps its
    block of the observations (the table padded with masked rows to a
    multiple of the mesh size): the JAX package's kernel under a jit over
    observation-sharded inputs. Every segment sum over observations (and
    the cost) is all-reduced; the parameters stay replicated, and every
    rank returns rank 0's."""
    dtype, dev = extrinsics.dtype, extrinsics.device
    V, T, G = num_views, num_tracks, num_groups
    P = intrinsics.shape[1]
    comm = mesh_axis(options.mesh)
    obs = (obs_view, obs_track, obs_uv, obs_sqrt_info, obs_mask)
    if comm is not None:
        obs = tuple(local_shard(a, comm) for a in obs)

    def segment_sum(data, ids, n):  # over this rank's observations, all-reduced
        out = _segment_sum(data, ids, n)
        return out if comm is None else comm.sum(out)

    prob = _Problem(obs, view_group,
                    track_ref_view, track_bearing, present_models, group_model_idx,
                    options.track_parametrization_type, options.loss_function_type,
                    options.robust_loss_width, dtype)
    K, invdepth = prob.K, prob.invdepth
    ov, ot, og, ref_o = prob.obs_view, prob.obs_track, prob.obs_group, prob.ref_o
    cam_free, pt_free = _free_masks(camera_free, point_free, options, V, dtype)
    intr_free = intrinsics_free.to(dtype)
    # With `intrinsics_to_optimize == NONE` there are no intrinsics
    # parameter blocks: no Ji, no intrinsics preconditioner, no intrinsics
    # half of the PCG state, and the observations' intrinsics are gathered
    # once.
    has_intr = options.intrinsics_to_optimize != OptimizeIntrinsicsType.NONE
    intr_rows = None if has_intr else intrinsics[prob.obs_group]
    eyeK = torch.eye(K, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eyeP = torch.eye(P, dtype=dtype, device=dev)

    def cost_of(state):
        ext, q, pts = state
        cost = prob.cost(ext, q, pts, intr_rows=intr_rows)
        return (cost if comm is None else comm.sum(cost)) + _prior_cost(ext, priors)

    def lm_step(state, mu):
        ext_c, intr_c, pts_c = state
        r, Jc, Jr, Ji, Jp, _ = prob.residuals(ext_c, intr_c, pts_c, with_jac=True,
                                              want_intr_jac=has_intr, intr_rows=intr_rows)
        # Freeze constant parameters by zeroing their Jacobian columns.
        Jc = Jc * cam_free[ov][:, None, :]
        Jp = Jp * pt_free[ot][:, None, :]
        if has_intr:
            Ji = Ji * intr_free[og][:, None, :]
        if invdepth:
            Jr = Jr * cam_free[ref_o][:, None, :]
        r_pr, J_pr = _prior_terms(ext_c, priors, cam_free)

        def jt_r(J, y):  # einsum('ori,or->oi')
            return torch.sum(J * y[..., None], dim=-2)

        def jtj_diag(J):  # einsum('ori,ori->oi')
            return torch.sum(J * J, dim=-2)

        # Gradients (RHS), b = -J^T r per block, and the damping diagonals.
        bc = -segment_sum(jt_r(Jc, r), ov, V)
        Dc = segment_sum(jtj_diag(Jc), ov, V)
        Uv = segment_sum(Jc.mT @ Jc, ov, V)
        if invdepth:
            bc = bc - segment_sum(jt_r(Jr, r), ref_o, V)
            Dc = Dc + segment_sum(jtj_diag(Jr), ref_o, V)
            Uv = Uv + segment_sum(Jr.mT @ Jr, ref_o, V)
        if J_pr is not None:
            bc = bc - jt_r(J_pr, r_pr)
            Dc = Dc + jtj_diag(J_pr)
            pr_blocks = J_pr.mT @ J_pr
            Uv = Uv + pr_blocks
        Dc = torch.clamp(Dc, min=1e-6)
        bp = -segment_sum(jt_r(Jp, r), ot, T)
        if has_intr:
            bi = -segment_sum(jt_r(Ji, r), og, G)
            Di = torch.clamp(segment_sum(jtj_diag(Ji), og, G), min=1e-6)

        # Point blocks, damped and inverted ([T, K, K], K in {1, 3}).
        Vt = segment_sum(Jp.mT @ Jp, ot, T)
        diagVt = torch.diagonal(Vt, dim1=-2, dim2=-1)
        Vt_d = Vt + mu * (eyeK * torch.clamp(diagVt, min=1e-6)[..., None, :]) + 1e-10 * eyeK
        Vinv = inv_small_spd(Vt_d, K)

        # The camera-side operator, observation-wise (never materialized).
        # Camera-side vectors are (cams,) or (cams, intrinsics).
        def jcam_apply(xs):
            y = torch.sum(Jc * xs[0][ov][:, None, :], dim=-1)
            if invdepth:
                y = y + torch.sum(Jr * xs[0][ref_o][:, None, :], dim=-1)
            if has_intr:
                y = y + torch.sum(Ji * xs[1][og][:, None, :], dim=-1)
            return y

        def jcam_adjoint(y):
            gc = segment_sum(jt_r(Jc, y), ov, V)
            if invdepth:
                gc = gc + segment_sum(jt_r(Jr, y), ref_o, V)
            if has_intr:
                return (gc, segment_sum(jt_r(Ji, y), og, G))
            return (gc,)

        def points_apply(z):  # einsum('ori,oi->or', Jp, z[obs_track])
            return torch.sum(Jp * z[ot][:, None, :], dim=-1)

        def S_mv(xs):
            y = jcam_apply(xs)
            a = jcam_adjoint(y)
            t = segment_sum(jt_r(Jp, y), ot, T)
            b = jcam_adjoint(points_apply(torch.sum(Vinv * t[:, None, :], dim=-1)))
            sc = a[0] - b[0] + mu * Dc * xs[0]
            if J_pr is not None:
                sc = sc + torch.sum(pr_blocks * xs[0][:, None, :], dim=-1)
            if has_intr:
                return (sc, a[1] - b[1] + mu * Di * xs[1])
            return (sc,)

        # Reduced RHS: g = b_cam - Jcam^T Jp V^-1 bp.
        Vinv_bp = torch.sum(Vinv * bp[:, None, :], dim=-1)
        corr = jcam_adjoint(points_apply(Vinv_bp))
        g = (bc - corr[0], bi - corr[1]) if has_intr else (bc - corr[0],)

        # Schur-Jacobi preconditioner: the diagonal blocks of S, by
        # pivoted LU.
        Wc = Jc.mT @ Jp  # [O, 6, K]
        corr_v = segment_sum(Wc @ Vinv[ot] @ Wc.mT, ov, V)
        Mv = Uv - corr_v + mu * (eye6 * Dc[..., None, :])
        Mv = Mv + (1.0 - cam_free)[..., None, :] * eye6 + 1e-8 * eye6
        Mv_inv = torch.linalg.inv_ex(Mv)[0]
        if has_intr:
            Ug = segment_sum(Ji.mT @ Ji, og, G)
            Wi = Ji.mT @ Jp  # [O, P, K]
            corr_g = segment_sum(Wi @ Vinv[ot] @ Wi.mT, og, G)
            Mg = Ug - corr_g + mu * (eyeP * Di[..., None, :])
            Mg = Mg + (1.0 - intr_free)[..., None, :] * eyeP + 1e-8 * eyeP
            Mg_inv = torch.linalg.inv_ex(Mg)[0]

        def precond(xs):
            pc = torch.sum(Mv_inv * xs[0][:, None, :], dim=-1)
            if has_intr:
                return (pc, torch.sum(Mg_inv * xs[1][:, None, :], dim=-1))
            return (pc,)

        dxs, n_pcg = _pcg(S_mv, precond, g, options, comm)
        dc = dxs[0] * cam_free
        di = dxs[1] * intr_free if has_intr else torch.zeros_like(intr_c)

        # Back-substitute the points: dp = V^-1 (bp - Jp^T Jcam dx).
        t = segment_sum(jt_r(Jp, jcam_apply(dxs)), ot, T)
        dp = torch.sum(Vinv * (bp - t)[:, None, :], dim=-1) * pt_free
        new_state = (ext_c + dc, intr_c + di, prob.apply_step(pts_c, dp))
        # Predicted reduction for the gain ratio: 0.5 dx^T (mu D dx + b).
        pred = 0.5 * (torch.sum(dc * (mu * Dc * dc + bc))
                      + torch.sum(dp * (mu * torch.clamp(diagVt, min=1e-6) * dp + bp)))
        if has_intr:
            pred = pred + 0.5 * torch.sum(di * (mu * Di * di + bi))
        ok = (torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
              & torch.all(torch.isfinite(di)))
        return new_state, pred, ok, n_pcg

    state, summary = run_lm(cost_of, lm_step, (extrinsics, intrinsics, points), options, "flat",
                            comm)
    if comm is not None:
        state = tuple(comm.broadcast(x) for x in state)
    return (*state, summary)
