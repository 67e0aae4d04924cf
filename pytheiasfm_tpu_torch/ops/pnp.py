"""Batched non-minimal PnP: the DLT with a Gauss-Newton polish.

Counterpart of the part of the JAX package's `ops/pnp.py` that the
calibrated absolute-pose estimator's local optimization takes (`dlt_pnp`,
`pnp_gauss_newton`); SQPnP and DLS-PnP port with incremental SfM (ROADMAP
item C1). A DLT initialization (the nullspace of the 2N x 12 design by a
symmetric eigen-solve), then Gauss-Newton on the reprojection error over
SO(3) x R^3.

Conventions: `features` are normalized (calibrated) image points [.., N, 2];
the result is the world->camera rotation R and camera position c
(p_cam = R (X - c)).
"""

from __future__ import annotations

import torch

from . import rotation as rotops
from .triangulation import _eigh

__all__ = ["dlt_pnp", "pnp_gauss_newton"]


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
