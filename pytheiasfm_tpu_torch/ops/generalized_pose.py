"""Generalized-camera and maximum-likelihood absolute pose.

Counterpart of the JAX package's `ops/generalized_pose.py`
(`theia/sfm/pose/upnp.h`, `mlpnp.h`, `gdls_similarity_transform.h`). As
there, each solver minimizes the reference's cost by variable projection
over the rotation alone, batched over 16 rotation seeds: the translation
(and the scale for gDLS) is linear given the rotation and is solved
exactly at every evaluation. Each seed first takes 12 alternation steps
(the current transform projected onto the rays, then a weighted Umeyama
rotation by the chunked batched 3x3 SVD of `ops/triangulation`), then 12
Gauss-Newton steps on the angle-axis (the Jacobian by forward-mode AD, all
three directions in one pass); a step is kept only where it lowers the
cost, and the seed with the lowest final cost wins.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad

from .rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
    rotation_matrix_to_angle_axis,
)
from .triangulation import _det3, _eigh, _svd

__all__ = ["upnp", "mlpnp", "gdls_similarity_transform"]


def _rotation_seeds() -> np.ndarray:
    """16 seeds: the identity, quarter and half turns about each axis, and
    six 120-degree turns about diagonals (the JAX package's)."""
    seeds = [np.zeros(3)]
    for ax in np.eye(3):
        for ang in (np.pi / 2, np.pi, -np.pi / 2):
            seeds.append(ax * ang)
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            aa = np.array([sx, sy, 0.0])
            seeds.append(aa / np.linalg.norm(aa) * (2 * np.pi / 3))
    for sz in (-1.0, 1.0):
        aa = np.array([0.0, 1.0, sz])
        seeds.append(aa / np.linalg.norm(aa) * (2 * np.pi / 3))
    return np.stack(seeds)  # [16, 3]


_SEEDS = _rotation_seeds()


def _forward_jacobian(fn, p):
    """fn(p) [.., R] and its Jacobian [.., R, D] with respect to p [.., D]:
    every direction in one forward-mode pass, the directions on a leading
    axis of the dual (the JAX package takes one `jvp` a direction)."""
    D = p.shape[-1]
    shape = (D, *p.shape)
    tangent = torch.eye(D, dtype=p.dtype, device=p.device).reshape(
        D, *([1] * (p.dim() - 1)), D)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(p.expand(shape).contiguous(),
                                    tangent.expand(shape).contiguous())
        r, J = forward_ad.unpack_dual(fn(dual))
    return r[0], J.movedim(0, -1)


def _qmat(d):
    """Q_i = I - d_i d_i^T (the projector orthogonal to a ray)."""
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    return eye - d[..., :, None] * d[..., None, :]


def _mv(M, v):
    """M [.., 3, 3] times v [.., 3]."""
    return (M @ v[..., None])[..., 0]


def _vp_gn(aa0, cost_terms, with_scale, iters):
    """Variable-projection Gauss-Newton over the angle-axis aa0 [.., 3], with
    (t[, s]) eliminated. cost_terms = (Q [.., N, 3, 3], X [.., N, 3],
    o [.., N, 3]) broadcast against aa0's leading axes: minimize
    sum_i ||Q_i (s R X_i + t - o_i)||^2 (s = 1 unless with_scale).
    Returns (aa, t, s, cost)."""
    Q, X, o = cost_terms
    dtype, device = aa0.dtype, aa0.device
    Qsum = torch.sum(Q, dim=-3)  # [.., 3, 3]
    Qo_n = _mv(Q, o)  # [.., N, 3]
    Qo = torch.sum(Qo_n, dim=-2)

    def solve_linear(aa):
        RX = angle_axis_rotate_point(aa[..., None, :], X)  # [.., N, 3]
        QRXn = _mv(Q, RX)
        QRX = torch.sum(QRXn, dim=-2)
        if with_scale:
            # Unknowns y = [t(3), s]: the normal equations of
            # sum ||Q_i (s RX_i + t - o_i)||^2.
            A_ss = torch.sum(QRXn * QRXn, dim=(-1, -2))
            b_s = torch.sum(QRXn * Qo_n, dim=(-1, -2))
            Qs, QRXb = torch.broadcast_tensors(Qsum, QRX[..., None, :])
            A = torch.cat([
                torch.cat([Qs, QRXb.mT[..., :, :1]], dim=-1),
                torch.cat([QRXb[..., :1, :], A_ss[..., None, None]], dim=-1),
            ], dim=-2)
            Qob, b_sb = torch.broadcast_tensors(Qo, b_s[..., None])
            b = torch.cat([Qob, b_sb[..., :1]], dim=-1)
            eye4 = torch.eye(4, dtype=dtype, device=device)
            y = torch.linalg.solve_ex(A + 1e-12 * eye4, b[..., None])[0][..., 0]
            return y[..., :3], y[..., 3], RX
        eye3 = torch.eye(3, dtype=dtype, device=device)
        rhs = (Qo - QRX)[..., None]
        t = torch.linalg.solve_ex((Qsum + 1e-12 * eye3).expand(rhs.shape[:-2] + (3, 3)),
                                  rhs)[0][..., 0]
        return t, torch.ones_like(aa[..., 0]), RX

    def residual(aa):
        t, s, RX = solve_linear(aa)
        v = s[..., None, None] * RX + t[..., None, :] - o
        return _mv(Q, v), v

    def cost_of(aa):
        r, _ = residual(aa)
        return torch.sum(r * r, dim=(-1, -2))

    Xc = X - torch.mean(X, dim=-2, keepdim=True)
    aa = aa0
    for _ in range(iters):
        # Generalized-ICP alternation: project the current transform onto
        # the rays for explicit targets, then the closed-form rotation of
        # the weighted Procrustes (Umeyama); (t, s) are re-solved exactly.
        _, v = residual(aa)
        targets = o + v - _mv(Q, v)  # o + d d^T v
        Tc = targets - torch.mean(targets, dim=-2, keepdim=True)
        U, _, Vt = _svd(Tc.mT @ Xc.expand(Tc.shape))
        det = _det3(U @ Vt)
        one = torch.ones_like(det)
        R_new = (U * torch.stack([one, one, det], dim=-1)[..., None, :]) @ Vt
        aa_new = rotation_matrix_to_angle_axis(R_new)
        better = cost_of(aa_new) < cost_of(aa)
        aa = torch.where(better[..., None], aa_new, aa)

    eye3 = torch.eye(3, dtype=dtype, device=device)
    for _ in range(iters):
        # Gauss-Newton over the 3 rotation parameters.
        r, J = _forward_jacobian(lambda a: residual(a)[0].flatten(-2), aa)
        JTJ = J.mT @ J
        JTr = (J.mT @ r[..., None])[..., 0]
        damp = 1e-10 * (1.0 + torch.diagonal(JTJ, dim1=-2, dim2=-1).sum(-1))[..., None, None]
        delta = torch.linalg.solve_ex(JTJ + damp * eye3, -JTr[..., None])[0][..., 0]
        aa_new = aa + delta
        better = cost_of(aa_new) < torch.sum(r * r, dim=-1)
        aa = torch.where(better[..., None], aa_new, aa)

    t, s, _ = solve_linear(aa)
    return aa, t, s, cost_of(aa)


def _multi_seed_solve(cost_terms, with_scale, iters, dtype, batch_shape, device):
    """`_vp_gn` from every seed; the seed of least cost (the first on ties)."""
    seeds = torch.as_tensor(_SEEDS, dtype=dtype, device=device)  # [S, 3]
    aa0 = seeds.expand(batch_shape + seeds.shape)
    terms = tuple(x[..., None, :, :] if x.dim() == len(batch_shape) + 2
                  else x[..., None, :, :, :] for x in cost_terms)
    aa, t, s, cost = _vp_gn(aa0, terms, with_scale, iters)
    best = torch.argmin(cost, dim=-1)
    take = lambda x: torch.take_along_dim(x, best[..., None, None], dim=-2)[..., 0, :]
    pick = lambda x: torch.take_along_dim(x, best[..., None], dim=-1)[..., 0]
    return take(aa), take(t), pick(s), pick(cost)


def upnp(ray_origins, ray_directions, world_points, iters: int = 12):
    """Universal PnP: the absolute pose of a (generalized) camera from rays.

    Parity: `Upnp` (`pose/upnp.h:79`): minimizes
    sum_i ||(I - d_i d_i^T)(R X_i + t - o_i)||^2. Central cameras pass zero
    origins. ray_origins, ray_directions (unit), world_points [.., N, 3].
    Returns (rotation [.., 3, 3], translation [.., 3], cost [..]).
    """
    d = ray_directions / torch.linalg.norm(ray_directions, dim=-1, keepdim=True)
    aa, t, _, cost = _multi_seed_solve(
        (_qmat(d), world_points, ray_origins), with_scale=False, iters=iters,
        dtype=world_points.dtype, batch_shape=world_points.shape[:-2],
        device=world_points.device)
    return angle_axis_to_rotation_matrix(aa), t, cost


def mlpnp(norm_feature_points, feature_covariances, world_points, iters: int = 10):
    """Maximum-likelihood PnP with per-feature bearing covariances.

    Parity: `MLPnP` (`pose/mlpnp.h:43`): the residual is the transformed
    point's projection onto the tangent plane of its bearing, whitened by
    the covariance projected into that plane (the inverse square root by
    the chunked batched 3x3 `eigh`). norm_feature_points [.., N, 2];
    feature_covariances [.., N, 3, 3] (identity when unknown); world_points
    [.., N, 3]. Returns (rotation [.., 3, 3], translation [.., 3], cost [..]).
    """
    v = torch.cat([norm_feature_points, torch.ones_like(norm_feature_points[..., :1])], dim=-1)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    P = _qmat(v)
    Sigma_t = P @ feature_covariances @ P
    # Full rank on the tangent plane plus v v^T (unit eigenvalue along v,
    # which the projector removes again).
    evals, evecs = _eigh(Sigma_t + v[..., :, None] * v[..., None, :])
    inv_sqrt = (evecs / torch.sqrt(torch.clamp(evals, min=1e-12))[..., None, :]) @ evecs.mT
    M = inv_sqrt @ P
    aa, t, _, cost = _multi_seed_solve(
        (M.mT @ M, world_points, torch.zeros_like(world_points)), with_scale=False,
        iters=iters, dtype=world_points.dtype, batch_shape=world_points.shape[:-2],
        device=world_points.device)
    return angle_axis_to_rotation_matrix(aa), t, cost


def gdls_similarity_transform(ray_origins, ray_directions, world_points, iters: int = 12):
    """Generalized DLS similarity transform from ray / point correspondences.

    Parity: `GdlsSimilarityTransform` (`pose/gdls_similarity_transform.h:61`):
    (s, R, t) minimizing sum_i ||(I - d d^T)(s R X_i + t - o_i)||^2.
    ray_origins, ray_directions, world_points [.., N, 3]. Returns (rotation
    [.., 3, 3], translation [.., 3], scale [..], cost [..]).
    """
    d = ray_directions / torch.linalg.norm(ray_directions, dim=-1, keepdim=True)
    aa, t, s, cost = _multi_seed_solve(
        (_qmat(d), world_points, ray_origins), with_scale=True, iters=iters,
        dtype=world_points.dtype, batch_shape=world_points.shape[:-2],
        device=world_points.device)
    return angle_axis_to_rotation_matrix(aa), t, s, cost
