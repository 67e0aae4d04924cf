"""Batched non-minimal PnP.

Counterpart of the JAX package's `ops/pnp.py` (`theia::DlsPnp`,
`dls_pnp.h:61`; `theia::SQPnP`, `sqpnp.h:70`): a DLT initialization (the
nullspace of the 2N x 12 design by a symmetric eigen-solve) or the
SQPnP-style 9x9 quadratic form, then Gauss-Newton on the reprojection
error over SO(3) x R^3. `dls_pnp` is the JAX package's single-candidate
shim over `sqpnp`. Every eigen-solve and SVD goes through
`ops/triangulation`'s chunked wrappers, so batches of any size reach
cuSOLVER in pieces it takes.

Conventions: `features` are normalized (calibrated) image points [.., N, 2];
the result is the world->camera rotation R and camera position c
(p_cam = R (X - c)).
"""

from __future__ import annotations

import torch

from . import rotation as rotops
from .triangulation import _det3, _eigh, _svd

__all__ = ["dlt_pnp", "sqpnp", "dls_pnp", "pnp_gauss_newton"]


def _masked_mean(x, mask, dim):
    if mask is None:
        return torch.mean(x, dim=dim, keepdim=True)
    w = mask.to(x.dtype)[..., None]
    return torch.sum(x * w, dim=dim, keepdim=True) / torch.clamp(
        torch.sum(w, dim=dim, keepdim=True), min=1.0
    )


def dlt_pnp(features: torch.Tensor, world_points: torch.Tensor, mask=None, gn_iters: int = 5):
    """Direct linear transform PnP (N >= 6) + Gauss-Newton polish.

    features [.., N, 2], world_points [.., N, 3] ->
    (R [.., 3, 3], position [.., 3], ok [..]).
    """
    dtype = features.dtype
    # Normalize the world points for conditioning.
    centroid = _masked_mean(world_points, mask, dim=-2)
    centered = world_points - centroid
    scale = torch.sqrt(
        torch.clamp(torch.mean(torch.sum(centered**2, dim=-1), dim=-1, keepdim=True), min=1e-12)
    )
    Xn = centered / scale[..., None]

    u = features[..., 0:1]
    v = features[..., 1:2]
    X_h = torch.cat([Xn, torch.ones_like(u)], dim=-1)  # [.., N, 4]
    zeros = torch.zeros_like(X_h)
    # Rows: [X 0 -u*X; 0 X -v*X] for P row-major as a 12-vector.
    row_u = torch.cat([X_h, zeros, -u * X_h], dim=-1)
    row_v = torch.cat([zeros, X_h, -v * X_h], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)  # [.., 2N, 12]
    if mask is not None:
        A = A * torch.cat([mask, mask], dim=-1)[..., None].to(dtype)
    _, vecs = _eigh(A.mT @ A)
    P = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 4))

    # Sign: the points' depths should be positive.
    depths = (X_h @ P.mT)[..., 2]
    signs = torch.sign(depths)
    if mask is not None:
        signs = signs * mask.to(dtype)
    sign_vote = torch.sum(signs, dim=-1)
    P = P * torch.where(sign_vote < 0, -1.0, 1.0).to(dtype)[..., None, None]

    # R by projection onto SO(3), the translation at M's scale.
    M = P[..., :3]
    R = rotops.project_to_so3(M)
    s = torch.diagonal(M @ R.mT, dim1=-2, dim2=-1).sum(-1) / 3.0
    t = P[..., 3] / torch.clamp(s, min=1e-12)[..., None]
    # Undo the world normalization: p_cam = R (X - centroid) / scale + t
    #                                    = R / scale (X - (centroid - scale R^T t)).
    position = centroid[..., 0, :] - scale * (R.mT @ t[..., None])[..., 0]

    R, position, ok = pnp_gauss_newton(
        features, world_points, R, position, mask=mask, iters=gn_iters
    )
    return R, position, ok & torch.all(torch.isfinite(position), dim=-1)


def pnp_gauss_newton(features, world_points, R, position, mask=None, iters=5):
    """Damped Gauss-Newton on the reprojection error over (so3 delta,
    position), R <- exp(dw) R. With p = R (X - c): dp/ddw = -hat(p),
    dp/dc = -R. Batched over leading dims."""
    dtype = features.dtype
    damp = 1e-8 * torch.eye(6, dtype=dtype, device=features.device)
    R_cur, c = R, position
    for _ in range(iters):
        p = (world_points - c[..., None, :]) @ R_cur.mT
        z = torch.clamp(p[..., 2], min=1e-8)
        inv_z = 1.0 / z
        r = p[..., :2] * inv_z[..., None] - features  # [.., N, 2]
        zeros = torch.zeros_like(inv_z)
        dpi = torch.stack(
            [
                torch.stack([inv_z, zeros, -p[..., 0] * inv_z * inv_z], dim=-1),
                torch.stack([zeros, inv_z, -p[..., 1] * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )  # [.., N, 2, 3]
        dp = torch.cat(
            [-rotops.hat(p), -R_cur[..., None, :, :].expand(p.shape[:-1] + (3, 3))], dim=-1
        )  # [.., N, 3, 6]
        J = dpi @ dp  # [.., N, 2, 6]
        if mask is not None:
            w = mask.to(dtype)[..., None]
            r = r * w
            J = J * w[..., None]
        Jf = J.reshape(J.shape[:-3] + (-1, 6))
        rf = r.reshape(r.shape[:-2] + (-1,))
        JtJ = Jf.mT @ Jf
        Jtr = (Jf.mT @ rf[..., None])[..., 0]
        step = torch.linalg.solve_ex(JtJ + damp, Jtr[..., None])[0][..., 0]
        step = torch.where(torch.all(torch.isfinite(step), dim=-1, keepdim=True), step,
                           torch.zeros_like(step))
        R_cur = rotops.angle_axis_to_rotation_matrix(-step[..., :3]) @ R_cur
        c = c - step[..., 3:]
    ok = torch.all(torch.isfinite(c), dim=-1) & torch.all(torch.isfinite(R_cur).flatten(-2), dim=-1)
    return R_cur, c, ok


def _project_to_so3(M):
    """`rotation.project_to_so3` over any batch (chunked SVD)."""
    U, _, Vh = _svd(M)
    det = _det3(U @ Vh)
    one = torch.ones_like(det)
    return (U * torch.stack([one, one, det], dim=-1)[..., None, :]) @ Vh


def sqpnp(features, world_points, mask=None, gn_iters: int = 8):
    """SQPnP-class non-minimal PnP, as the JAX package's `sqpnp`
    (`theia::SQPnP`, `sqpnp.h:70`): the object-space form r^T Omega r over
    the 9-vector of R (row-major) with t eliminated, seeded by the smallest
    eigenvector of Omega projected to SO(3) (the better of +-R by the
    reprojection error), then `gn_iters` Gauss-Newton steps.

    On exact data Omega's null space has max(1, 12 - 2N) dimensions, so
    below six points (RANSAC's samples have three) the seed is whichever
    null vector the eigen-solver returns, as in the JAX package.
    features [.., N, 2], world_points [.., N, 3] ->
    (R [.., 3, 3], position [.., 3], ok [..]).
    """
    dtype, device = features.dtype, features.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    # The projection constraint [I2, -u] (R X + t) = 0 of each point, with u
    # the homogeneous normalized feature.
    u = torch.cat([features, torch.ones_like(features[..., :1])], dim=-1)  # [.., N, 3]
    X = world_points
    zeros = torch.zeros_like(X)
    # A_i maps vec(R) (row-major) to R X_i: [.., N, 3, 9].
    A = torch.stack([
        torch.cat([X, zeros, zeros], dim=-1),
        torch.cat([zeros, X, zeros], dim=-1),
        torch.cat([zeros, zeros, X], dim=-1),
    ], dim=-2)
    # Q_i = I - u u^T / ||u||^2 annihilates the ray direction.
    uu = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    Qi = eye3 - uu[..., :, None] * uu[..., None, :]
    if mask is not None:
        Qi = Qi * mask.to(dtype)[..., None, None]
    # t elimination: t* = -(sum Q_i)^-1 sum Q_i A_i vec(R).
    Qsum = torch.sum(Qi, dim=-3) + 1e-9 * eye3
    QA_sum = torch.sum(Qi @ A, dim=-3)  # [.., 3, 9]
    P_t = -torch.linalg.solve(Qsum, QA_sum)  # [.., 3, 9]
    # The residual operator of each point: Q_i (A_i + P_t) vec(R).
    QB = Qi @ (A + P_t[..., None, :, :])
    Omega = torch.einsum("...nij,...nik->...jk", QB, QB)  # [.., 9, 9]
    _, vecs = _eigh(Omega)
    Rm = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    R = _project_to_so3(Rm)
    # The eigenvector's sign is arbitrary: take the better of +-R.
    R_neg = _project_to_so3(-Rm)

    def translation(Rc):
        return (P_t @ Rc.reshape(Rc.shape[:-2] + (9, 1)))[..., 0]

    def objective(Rc):
        p_cam = X @ Rc.mT + translation(Rc)[..., None, :]
        z = torch.clamp(p_cam[..., 2], min=1e-8)
        err = torch.sum((p_cam[..., :2] / z[..., None] - features) ** 2, dim=-1)
        if mask is not None:
            err = err * mask.to(dtype)
        return torch.sum(err, dim=-1)

    R = torch.where((objective(R_neg) < objective(R))[..., None, None], R_neg, R)
    position = -(R.mT @ translation(R)[..., None])[..., 0]
    return pnp_gauss_newton(features, world_points, R, position, mask=mask, iters=gn_iters)


def dls_pnp(features, world_points, mask=None):
    """The JAX package's parity shim for `theia::DlsPnp` (`dls_pnp.h:61`):
    the DLS method's Macaulay eigendecomposition is replaced by the
    SQPnP-class solution, returned as a one-candidate list.
    Returns (R [.., 1, 3, 3], position [.., 1, 3], valid [.., 1])."""
    R, c, ok = sqpnp(features, world_points, mask=mask)
    return R[..., None, :, :], c[..., None, :], ok[..., None]
