"""Two-view bundle adjustment and epipolar refinement.

Counterpart of the JAX package's `ba/two_view.py`
(`theia/sfm/bundle_adjustment/bundle_adjust_two_views.h`):
  - ``bundle_adjust_two_views``          (`:64`, joint pose + points)
  - ``bundle_adjust_two_views_angular``  (`:79`, angular epipolar error)
  - ``optimize_fundamental_matrix``      (`:88`, F on its 7-DOF manifold)
  - ``optimize_homography``              (`:94`, transfer error)

All four are fixed-iteration damped Gauss-Newton over batched
correspondence tensors with leading pair axes. The Jacobian is forward-mode,
one Jacobian-vector product per parameter, as the JAX package's `jax.jvp`
loop. The products use the dual tensors of `torch.autograd.forward_ad`:
`torch.func.jvp` gives the tangent of a 0-dim f32 tensor divided by a Python
float as f64 (torch 2.11.0+cu128 on CUDA and on the CPU, torch 2.13.0 on the
CPU), which breaks single-pair f32 problems.

Masked rows (padding, gated-out points) are zeroed with `torch.where`, not
by multiplying with the mask as the JAX package does: the forward-mode
tangent of `where` selects, so a NaN or inf tangent of a masked row (the
`eigh` inside the triangulation has them on degenerate rows) never reaches
JTJ, and unmasked rows compute exactly what they compute in JAX.

Convention: camera 1 is the gauge (identity); the relative pose maps points
from the camera-1 frame to the camera-2 frame: x2 = R x1 + t, with `position`
the camera-2 center in camera 1 (t = -R position).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from ..ops import triangulation as tri
from ..ops.rotation import angle_axis_rotate_point, angle_axis_to_rotation_matrix
from .losses import LossFunctionType, loss_weight

__all__ = [
    "bundle_adjust_two_views",
    "bundle_adjust_two_views_angular",
    "optimize_fundamental_matrix",
    "optimize_homography",
]


def _jvp(fn, p, tangent):
    """(fn(p), d fn(p) . tangent) by forward-mode AD."""
    with forward_ad.dual_level():
        primal, out = forward_ad.unpack_dual(fn(forward_ad.make_dual(p, tangent)))
    return primal, torch.zeros_like(primal) if out is None else out


def _gn(residual_fn, params, iters, damp0=1e-6):
    """Damped Gauss-Newton with a monotone fallback, batch-safe: params
    [.., P], residual_fn [.., P] -> [.., R]. Returns (params, cost)."""
    n = params.shape[-1]
    eye = torch.eye(n, dtype=params.dtype, device=params.device)
    basis = [eye[i].expand(params.shape) for i in range(n)]

    def cost(r):
        return torch.sum(r * r, dim=-1)

    p = params
    mu = torch.full(params.shape[:-1], damp0, dtype=params.dtype, device=params.device)
    cost_p = cost(residual_fn(p))
    for _ in range(iters):
        cols = []
        for b in basis:
            r, col = _jvp(residual_fn, p, b)
            cols.append(col)
        J = torch.stack(cols, dim=-1)  # [.., R, P]
        JTJ = J.mT @ J
        JTr = (J.mT @ r[..., None])[..., 0]
        # solve_ex: no host sync and no raise; a singular system gives a
        # non-finite step, which the cost test below rejects (as in JAX).
        delta = torch.linalg.solve_ex(JTJ + mu[..., None, None] * eye, -JTr[..., None])[0][..., 0]
        p_new = p + delta
        cost_new = cost(residual_fn(p_new))
        better = cost_new < cost_p
        p = torch.where(better[..., None], p_new, p)
        cost_p = torch.where(better, cost_new, cost_p)
        mu = torch.clamp(torch.where(better, mu * 0.3, mu * 8.0), 1e-12, 1e6)
    return p, cost_p


def _masked(r, mask):
    """Residual rows [.., N, k] with masked rows set to 0, flattened."""
    r = torch.where(mask[..., None], r, torch.zeros((), dtype=r.dtype, device=r.device))
    return r.reshape(*r.shape[:-2], -1)


def _safe_div(z):
    """z with |z| < 1e-12 replaced by 1e-12 (the JAX package's guard)."""
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _two_view_poses(aa, pos):
    """([I|0] [3, 4], [R|-R pos] [.., 1, 3, 4]): one pose per pair, which
    broadcasts against the pair's N points (the JAX package expands it)."""
    R2 = angle_axis_to_rotation_matrix(aa)
    pose1 = torch.eye(3, 4, dtype=aa.dtype, device=aa.device)
    t2 = -(R2 @ pos[..., None])
    return pose1, torch.cat([R2, t2], dim=-1)[..., None, :, :]


def triangulate_two_views(aa, pos, points1, points2):
    """Euclidean points [.., N, 3] of normalized correspondences under
    ([I|0], (R(aa), pos)): optimal triangulation, then de-homogenised with
    the JAX package's 1e-12 guard."""
    pose1, pose2 = _two_view_poses(aa, pos)
    X4 = tri.triangulate(pose1, pose2, points1, points2)
    return X4[..., :3] / _safe_div(X4[..., 3:4])


def bundle_adjust_two_views(
    rotation_aa,
    position,
    points1,
    points2,
    mask=None,
    iters: int = 15,
    loss: LossFunctionType = LossFunctionType.TRIVIAL,
    loss_width: float = 1e-2,
):
    """Joint two-view BA: refine (R, t) and triangulated points.

    Parity: `BundleAdjustTwoViews` (`bundle_adjust_two_views.h:64`). Points
    are re-triangulated in closed form each GN step (variable projection),
    so the GN state is the 6-DOF relative pose; |position| is held at its
    input norm. points1/points2 are normalized (calibrated) image points.

    Args:
      rotation_aa [.., 3]; position [.., 3] (camera-2 position in camera-1
      frame); points1/points2 [.., N, 2]; mask [.., N] bool.

    Returns:
      (rotation_aa, position, points3d [.., N, 3], cost [..]).
    """
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    norm_pos = torch.linalg.norm(position, dim=-1, keepdim=True)

    def residuals(p):
        aa, pos = p[..., :3], _unit(p[..., 3:6]) * norm_pos
        X = triangulate_two_views(aa, pos, points1, points2)
        r1 = X[..., :2] / _safe_div(X[..., 2])[..., None] - points1
        Xc = angle_axis_rotate_point(aa[..., None, :], X - pos[..., None, :])
        r2 = Xc[..., :2] / _safe_div(Xc[..., 2])[..., None] - points2
        r = torch.cat([r1, r2], dim=-1)
        if loss != LossFunctionType.TRIVIAL:
            s = torch.sum(r * r, dim=-1)
            r = r * torch.sqrt(loss_weight(s, loss, loss_width))[..., None]
        return _masked(r, mask)

    p, cost = _gn(residuals, torch.cat([rotation_aa, position], dim=-1), iters)
    aa, pos = p[..., :3], _unit(p[..., 3:6]) * norm_pos
    return aa, pos, triangulate_two_views(aa, pos, points1, points2), cost


def bundle_adjust_two_views_angular(
    rotation_aa, position, points1, points2, mask=None, iters: int = 15
):
    """Refine the relative pose with the angular epipolar error, no points.

    Parity: `BundleAdjustTwoViewsAngular` (`bundle_adjust_two_views.h:79`,
    `angular_epipolar_error.h`): r = f2^T E f1 on unit bearings, normalized
    by the epipolar line norms. The translation lives on the unit sphere.
    Returns (rotation_aa, unit position, cost).
    """
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    ones = torch.ones_like(points1[..., :1])
    f1 = _unit(torch.cat([points1, ones], dim=-1))
    f2 = _unit(torch.cat([points2, ones], dim=-1))
    zero = torch.zeros((), dtype=points1.dtype, device=points1.device)

    def residuals(p):
        aa, t_unit = p[..., :3], _unit(p[..., 3:6])
        R = angle_axis_to_rotation_matrix(aa)
        t = -(R @ t_unit[..., None])[..., 0]
        z = torch.zeros_like(t[..., 0])
        tx = torch.stack(
            [
                torch.stack([z, -t[..., 2], t[..., 1]], -1),
                torch.stack([t[..., 2], z, -t[..., 0]], -1),
                torch.stack([-t[..., 1], t[..., 0], z], -1),
            ],
            -2,
        )
        E = tx @ R
        Ef1 = f1 @ E.mT  # [.., N, 3]: E f1 per row
        Etf2 = f2 @ E  # E^T f2 per row
        num = torch.sum(f2 * Ef1, dim=-1)
        den = torch.sqrt(
            torch.sum(Ef1[..., :2] ** 2, -1) + torch.sum(Etf2[..., :2] ** 2, -1) + 1e-20
        )
        return torch.where(mask, num / den, zero)

    p, cost = _gn(residuals, torch.cat([rotation_aa, position], dim=-1), iters)
    return p[..., :3], _unit(p[..., 3:6]), cost


def _hartley(points):
    """(centroid [.., 2], scale [..]) of the isotropic normalization over all
    points, masked or not, as the JAX package computes it."""
    c = torch.mean(points, dim=-2, keepdim=True)
    s = torch.mean(torch.linalg.norm(points - c, dim=-1), dim=-1)
    return c[..., 0, :], (2.0**0.5) / torch.clamp(s, min=1e-12)


def _normalizing_transform(c, s):
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, z, -s * c[..., 0]], -1),
            torch.stack([z, s, -s * c[..., 1]], -1),
            torch.stack([z, z, o], -1),
        ],
        -2,
    )


def optimize_fundamental_matrix(F, points1, points2, mask=None, iters: int = 60):
    """Refine F on its 7-DOF manifold minimizing the Sampson distance.

    Parity: `OptimizeFundamentalMatrix` (`bundle_adjust_two_views.h:88`,
    `fundamental_matrix_parameterization.h`): Hartley-normalized points,
    F = U0 R(du) diag(1, s, 0) R(dv) V0^T with the parameters (du, dv,
    log singular-value ratio), rank 2 exactly. Points are pixels; F maps
    1 -> 2 (x2^T F x1 = 0). Returns (F with unit Frobenius norm, cost).
    """
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    c1, s1 = _hartley(points1)
    c2, s2 = _hartley(points2)
    points1 = (points1 - c1[..., None, :]) * s1[..., None, None]
    points2 = (points2 - c2[..., None, :]) * s2[..., None, None]
    T1 = _normalizing_transform(c1, s1)
    T2 = _normalizing_transform(c2, s2)
    # x2^T F x1 = (T2 x2)^T F_n (T1 x1) with F_n = T2^-T F T1^-1.
    F = torch.linalg.inv(T2).mT @ F @ torch.linalg.inv(T1)

    U0, s0, Vt0 = torch.linalg.svd(F)
    ratio0 = torch.log(
        torch.clamp(s0[..., 1] / torch.clamp(s0[..., 0], min=1e-20), min=1e-8)
    )

    def build_F(p):
        du, dv, lr = p[..., 0:3], p[..., 3:6], p[..., 6]
        U = U0 @ angle_axis_to_rotation_matrix(du)
        Vt = angle_axis_to_rotation_matrix(dv) @ Vt0
        s = torch.stack([torch.ones_like(lr), torch.exp(ratio0 + lr), torch.zeros_like(lr)], -1)
        return (U * s[..., None, :]) @ Vt

    ones = torch.ones_like(points1[..., :1])
    x1 = torch.cat([points1, ones], -1)
    x2 = torch.cat([points2, ones], -1)
    zero = torch.zeros((), dtype=points1.dtype, device=points1.device)

    def residuals(p):
        Fm = build_F(p)
        Fx1 = x1 @ Fm.mT
        Ftx2 = x2 @ Fm
        num = torch.sum(x2 * Fx1, dim=-1)
        den = torch.sqrt(
            torch.sum(Fx1[..., :2] ** 2, -1) + torch.sum(Ftx2[..., :2] ** 2, -1) + 1e-20
        )
        return torch.where(mask, num / den, zero)

    p0 = torch.zeros(F.shape[:-2] + (7,), dtype=F.dtype, device=F.device)
    p, cost = _gn(residuals, p0, iters)
    # Denormalize: F = T2^T F_n T1, then |F| = 1.
    F_out = T2.mT @ build_F(p) @ T1
    F_out = F_out / torch.clamp(
        torch.linalg.norm(F_out, dim=(-2, -1), keepdim=True), min=1e-20
    )
    return F_out, cost


def optimize_homography(H, points1, points2, mask=None, iters: int = 15):
    """Refine a homography minimizing the transfer error in image 2.

    Parity: `OptimizeHomography` (`bundle_adjust_two_views.h:94`,
    `homography_error.h`). H maps 1 -> 2. All nine entries move; the result
    is renormalized to h33 = 1. Returns (H, cost).
    """
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    H0 = H / _safe_div(H[..., 2:3, 2:3])
    x1 = torch.cat([points1, torch.ones_like(points1[..., :1])], -1)

    def residuals(p):
        Hm = H0 + p.reshape(*p.shape[:-1], 3, 3)
        Hx1 = x1 @ Hm.mT
        fwd = Hx1[..., :2] / _safe_div(Hx1[..., 2:3]) - points2
        return _masked(fwd, mask)

    p0 = torch.zeros(H.shape[:-2] + (9,), dtype=H.dtype, device=H.device)
    p, cost = _gn(residuals, p0, iters)
    H_out = H0 + p.reshape(*p.shape[:-1], 3, 3)
    return H_out / _safe_div(H_out[..., 2:3, 2:3]), cost
