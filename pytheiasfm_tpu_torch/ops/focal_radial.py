"""Absolute pose with an unknown focal length (and radial distortion).

Counterpart of the JAX package's `ops/focal_radial.py`
(`theia/sfm/pose/four_point_focal_length.h`,
`five_point_focal_length_radial_distortion.h`,
`four_point_focal_length_radial_distortion.h`): P4Pf, P5Pfr (one or two
division-model parameters) and P4Pfr with bounds. As in the JAX package,
each is a candidate grid plus a Gauss-Newton polish, not the reference's
Groebner eliminations:

  1. a fixed grid of focal candidates (times the observed pixel spread)
     and of distortion seeds, focal outer and distortion inner;
  2. P3P on the first three points of each candidate's undistorted,
     normalized features, the solution that best reprojects all points;
  3. 10 Gauss-Newton steps on (angle-axis, t, log f[, k...]) of every
     candidate, each step kept only where it lowers the cost; the
     Jacobian analytic (the JAX package's `jvp`s, to rounding);
  4. a stable sort of the candidates by final error, the first four kept.

Distortion is the division model (`DIVISION_UNDISTORTION`): undistorted =
distorted / (1 + k1 r^2 [+ k2 r^4]) on normalized (focal-divided) points,
so k is in normalized units. Batched over any leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import p3p as p3p_mod
from .rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
    hat,
    rotation_matrix_to_angle_axis,
)

__all__ = [
    "four_point_pose_and_focal_length",
    "five_point_focal_length_radial_distortion",
    "four_point_pose_focal_length_radial_distortion",
]

# Multipliers of the observed pixel spread used as focal seeds.
_FOCAL_GRID = np.array([0.4, 0.7, 1.0, 1.5, 2.2, 3.5, 6.0], np.float64)


def _pixel_scale(features):
    """Robust pixel spread: mean |p| over the sample (pp-centred pixels)."""
    return torch.clamp(torch.mean(torch.linalg.norm(features, dim=-1), dim=-1), min=1e-8)


def _undistort_div(d, ks):
    """Division-model undistort: d [.., 2], ks [.., K] -> [.., 2]."""
    r2 = torch.sum(d * d, dim=-1, keepdim=True)
    denom = 1.0 + ks[..., 0:1] * r2
    if ks.shape[-1] > 1:
        denom = denom + ks[..., 1:2] * r2 * r2
    return d / denom


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _p3p_best_pose(norm_feats, world_pts, score_feats, score_pts):
    """P3P on the first three points, the candidate that best reprojects the
    scoring points. norm_feats [.., 3, 2]; returns (aa [.., 3], t [.., 3],
    score [..])."""
    R, t, valid = p3p_mod.pose_from_three_points(norm_feats, world_pts)
    pc = R[..., None, :, :] @ score_pts[..., None, :, :, None]  # [.., 4, N, 3, 1]
    pc = pc[..., 0] + t[..., :, None, :]
    z = _safe_z(pc[..., 2])
    proj = pc[..., :2] / z[..., None]
    err = torch.sum((proj - score_feats[..., None, :, :]) ** 2, dim=(-1, -2))
    err = torch.where(valid & torch.all(z > 0, dim=-1), err, torch.inf)
    best = torch.argmin(err, dim=-1)
    R_b = torch.take_along_dim(R, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t_b = torch.take_along_dim(t, best[..., None, None], dim=-2)[..., 0, :]
    return rotation_matrix_to_angle_axis(R_b), t_b, torch.amin(err, dim=-1)


def _gn_refine(params, features, world_pts, num_k, iters=8):
    """Joint Gauss-Newton on params = [aa(3), t(3), log_f, k...] [.., P]
    minimizing pixel reprojection with the division model; features
    [.., N, 2] and world_pts [.., N, 3] broadcast against params' leading
    axes. Returns (params, final squared error [..]).

    The Jacobian is analytic (the JAX package takes one `jvp` a parameter):
    d(R X)/d aa = -[R X]_x J_l(aa) with J_l the left Jacobian of SO(3)
    (-[X]_x on the first-order branch at small angles), the chain through
    the projection, log f and the division model written out; the same
    numbers to rounding, at a fraction of the forward-mode cost."""

    def terms(p):
        aa, t = p[..., 0:3], p[..., 3:6]
        f = torch.exp(p[..., 6])[..., None, None]
        rx = angle_axis_rotate_point(aa[..., None, :], world_pts)
        pc = rx + t[..., None, :]
        z = _safe_z(pc[..., 2])
        u = pc[..., :2] / z[..., None]  # undistorted normalized
        d = features / f  # distorted normalized
        r2 = torch.sum(d * d, dim=-1, keepdim=True)
        denom = 1.0 + p[..., 7:8, None] * r2 if num_k else torch.ones_like(r2)
        if num_k > 1:
            denom = denom + p[..., 8:9, None] * r2 * r2
        ud = d / denom
        return f, rx, z, u, d, r2, denom, ud

    def residuals(p):
        f, _, _, u, _, _, _, ud = terms(p)
        return ((ud - u) * f).flatten(-2)

    def residuals_and_jacobian(p):
        f, rx, z, u, d, r2, denom, ud = terms(p)
        fz = f[..., None]  # [.., 1, 1, 1]
        inv_z = (1.0 / z)[..., None, None]
        zero = torch.zeros_like(inv_z)
        # du/dpc [.., N, 2, 3].
        Pj = torch.cat([
            torch.cat([inv_z, zero, -u[..., 0, None, None] * inv_z], dim=-1),
            torch.cat([zero, inv_z, -u[..., 1, None, None] * inv_z], dim=-1),
        ], dim=-2)
        aa = p[..., 0:3]
        theta_sq = torch.sum(aa * aa, dim=-1)
        small = theta_sq < 1e-8
        theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
        a1 = (1.0 - torch.cos(theta)) / (theta * theta)
        a2 = (theta - torch.sin(theta)) / (theta * theta * theta)
        W = hat(aa)
        Jl = (torch.eye(3, dtype=p.dtype, device=p.device) + a1[..., None, None] * W
              + a2[..., None, None] * (W @ W))
        drx = torch.where(small[..., None, None, None],
                          -hat(world_pts).expand(rx.shape + (3,)),
                          -hat(rx) @ Jl[..., None, :, :])  # [.., N, 3, 3]
        J_aa = -fz * (Pj @ drx)
        J_t = -fz * Pj
        dud_logf = -d * (denom - 2.0 * (p[..., 7:8, None] if num_k else 0.0) * r2
                         - (4.0 * p[..., 8:9, None] * r2 * r2 if num_k > 1 else 0.0)) / (
                             denom * denom)
        cols = [J_aa, J_t, (f * (dud_logf + ud - u))[..., None]]
        dud_k = -d / (denom * denom)
        if num_k:
            cols.append((f * dud_k * r2)[..., None])
        if num_k > 1:
            cols.append((f * dud_k * r2 * r2)[..., None])
        J = torch.cat(cols, dim=-1)  # [.., N, 2, P]
        return ((ud - u) * f).flatten(-2), J.flatten(-3, -2)

    eye = torch.eye(params.shape[-1], dtype=params.dtype, device=params.device)
    p = params
    for _ in range(iters):
        r, J = residuals_and_jacobian(p)
        JTJ = J.mT @ J
        JTr = (J.mT @ r[..., None])[..., 0]
        damp = 1e-9 * torch.diagonal(JTJ, dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye
        delta = torch.linalg.solve_ex(JTJ + damp, -JTr[..., None])[0][..., 0]
        p_new = p + delta
        better = torch.sum(residuals(p_new) ** 2, -1) < torch.sum(r * r, -1)
        p = torch.where(better[..., None], p_new, p)
    return p, torch.sum(residuals(p) ** 2, dim=-1)


def _grid_solve(features, world_pts, num_k, k_grid, iters, max_solutions):
    """The shared machinery: focal (x distortion) candidate grid -> P3P ->
    Gauss-Newton. features [.., N, 2] (principal-point-centred pixels),
    world [.., N, 3]. Returns params [.., S, 7 + num_k] and err [.., S],
    ascending (a stable sort: ties keep the candidate order)."""
    dtype, device = features.dtype, features.device
    # Unit-scale pixels: in f32 the normal equations are otherwise dominated
    # by the focal column; log f is shifted back at the end.
    scale = _pixel_scale(features)  # [..]
    features = features / scale[..., None, None]
    if k_grid is None:
        k_grid = np.zeros((1, max(num_k, 1)))
    F, K = _FOCAL_GRID.shape[0], k_grid.shape[0]
    # Candidates focal outer, distortion inner: c = fi * K + ki.
    f_c = torch.as_tensor(np.repeat(_FOCAL_GRID, K), dtype=dtype, device=device)  # [C]
    k_c = torch.as_tensor(np.tile(k_grid, (F, 1)), dtype=dtype, device=device)  # [C, nk]
    batch = features.shape[:-2]
    C = F * K

    d = features[..., None, :, :] / f_c[:, None, None]  # [.., C, N, 2]
    ud = _undistort_div(d, k_c[:, None, :].expand(d.shape[:-1] + (k_c.shape[-1],)))
    world_c = world_pts[..., None, :, :].expand(ud.shape[:-1] + (3,))
    aa, t, _ = _p3p_best_pose(ud[..., :3, :], world_c[..., :3, :], ud, world_c)
    parts = [aa, t, torch.log(f_c).expand(batch + (C,))[..., None]]
    if num_k:
        parts.append(k_c[:, :num_k].expand(batch + (C, num_k)))
    params0 = torch.cat(parts, dim=-1)  # [.., C, P]

    params, err = _gn_refine(params0, features[..., None, :, :], world_pts[..., None, :, :],
                             num_k, iters)
    order = torch.sort(err, dim=-1, stable=True).indices[..., :max_solutions]
    params = torch.take_along_dim(params, order[..., None], dim=-2)
    err = torch.take_along_dim(err, order, dim=-1)
    # Undo the pixel normalization: f = exp(log_f_normalized) * scale.
    log_f = params[..., 6:7] + torch.log(scale)[..., None, None]
    params = torch.cat([params[..., :6], log_f, params[..., 7:]], dim=-1)
    return params, err


def _params_to_pose(params, num_k):
    R = angle_axis_to_rotation_matrix(params[..., 0:3])
    f = torch.exp(params[..., 6])
    ks = params[..., 7:7 + num_k] if num_k else None
    return R, params[..., 3:6], f, ks


def _tol(dtype):
    return 1e-3 if dtype == torch.float32 else 1e-8


def _projection(R, t, f):
    """P = diag(f, f, 1) [R | t]."""
    P = torch.cat([R, t[..., None]], dim=-1)
    Kf = torch.stack([f, f, torch.ones_like(f)], dim=-1)
    return Kf[..., None] * P


def four_point_pose_and_focal_length(features, world_points, iters: int = 10):
    """P4Pf: absolute pose + focal length from four 2D-3D correspondences.

    Parity: `FourPointPoseAndFocalLength` (`pose/four_point_focal_length.h:56`).
    features [.., 4, 2] pixels with the principal point subtracted,
    world_points [.., 4, 3]. Returns (projection_matrices [.., 4, 3, 4] =
    diag(f, f, 1) [R | t], focal_lengths [.., 4], valid [.., 4]).
    """
    params, err = _grid_solve(features, world_points, num_k=0, k_grid=None, iters=iters,
                              max_solutions=4)
    R, t, f, _ = _params_to_pose(params, 0)
    return _projection(R, t, f), f, err < _tol(features.dtype)


def five_point_focal_length_radial_distortion(
    features, world_points, num_radial_distortion_params: int = 1, iters: int = 10
):
    """P5Pfr: pose + focal + radial distortion from five correspondences.

    Parity: `FivePointFocalLengthRadialDistortion`
    (`pose/five_point_focal_length_radial_distortion.h:77`). features
    [.., 5, 2] (pp-centred pixels), world_points [.., 5, 3];
    num_radial_distortion_params 1 or 2. Returns (projection_matrices
    [.., 4, 3, 4], focal_lengths [.., 4], radial_distortions [.., 4, num_k],
    valid [.., 4]).
    """
    num_k = int(num_radial_distortion_params)
    k_seeds = np.array([[0.0], [-0.1], [-0.3]], np.float64)
    if num_k == 2:
        k_seeds = np.concatenate([k_seeds, np.zeros_like(k_seeds)], axis=1)
    params, err = _grid_solve(features, world_points, num_k=num_k, k_grid=k_seeds,
                              iters=iters, max_solutions=4)
    R, t, f, ks = _params_to_pose(params, num_k)
    return _projection(R, t, f), f, ks, err < _tol(features.dtype)


def four_point_pose_focal_length_radial_distortion(
    features,
    world_points,
    min_focal_length: float = 0.0,
    max_focal_length: float = np.inf,
    min_distortion: float = -np.inf,
    max_distortion: float = 0.0,
    iters: int = 10,
):
    """P4Pfr: pose + focal + one radial distortion from four correspondences,
    the bounds used as validity filters.

    Parity: `FourPointsPoseFocalLengthRadialDistortion`
    (`pose/four_point_focal_length_radial_distortion.h:56`). Returns
    (rotations [.., 4, 3, 3], translations [.., 4, 3], radial_distortions
    [.., 4], focal_lengths [.., 4], valid [.., 4]).
    """
    k_seeds = np.array([[0.0], [-0.05], [-0.15], [-0.35]], np.float64)
    params, err = _grid_solve(features, world_points, num_k=1, k_grid=k_seeds, iters=iters,
                              max_solutions=4)
    R, t, f, ks = _params_to_pose(params, 1)
    k1 = ks[..., 0]
    valid = (
        (err < _tol(features.dtype))
        & (f >= min_focal_length)
        & (f <= max_focal_length)
        & (k1 >= min_distortion)
        & (k1 <= max_distortion)
    )
    return R, t, k1, f, valid
