"""Radial-distortion homography (one division parameter a side), 6 points.

Counterpart of the JAX package's `ops/radial_homography.py`
(`theia/sfm/pose/six_point_radial_distortion_homography.h`): a homography H
between two images together with one division-model parameter a side
(l1, l2). A distorted normalized point p = (x, y) with parameter l lifts to
the undistorted homogeneous point u(p, l) = (x, y, 1 + l r^2); the
constraint is u(p2, l2) ~ H u(p1, l1).

As in the JAX package, (l1, l2) are found by a derivative-free grid search
with H projected out: for fixed (l1, l2), H is the DLT solution (the
eigenvector of the smallest eigenvalue of the 9x9 normal matrix, by the
chunked batched `eigh` of `ops/triangulation`), scored by the symmetric
lifted transfer error; a 9x9 coarse grid, then 8 levels of a 5x5 grid
around each of the 4 best cells (881 DLTs a sample). The transfer error
back through H uses H's adjugate in place of the JAX package's batched LU
solve: adj(H) = det(H) H^-1, and det(H) cancels in the division by the
third component, so the ratio is the same in a closed form for the card's
millions of 3x3 systems. Neither depends on H's sign or scale.

Helper parity: `DistortPoint` / `UndistortPoint` /
`CheckRadialSymmetricError` (same header).
"""

from __future__ import annotations

import numpy as np
import torch

from .triangulation import _eigh

__all__ = [
    "six_point_radial_distortion_homography",
    "radial_distort_point",
    "radial_undistort_point",
    "check_radial_symmetric_error",
]


def _lift(p, l):
    """p [.., N, 2], l [..] -> u [.., N, 3] = (x, y, 1 + l r^2)."""
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    w = 1.0 + l[..., None, None] * r2
    return torch.cat([p.expand(w.shape[:-1] + (2,)), w], dim=-1)


def _dlt_h(u1, u2):
    """DLT homography from lifted points u1 -> u2 [.., N, 3]: the
    eigenvector of the smallest eigenvalue of the 9x9 normal matrix of the
    2N x 9 design matrix, as H [.., 3, 3]."""
    zeros = torch.zeros_like(u1)
    x2, y2, w2 = u2[..., 0:1], u2[..., 1:2], u2[..., 2:3]
    row1 = torch.cat([zeros, -w2 * u1, y2 * u1], dim=-1)  # [.., N, 9]
    row2 = torch.cat([w2 * u1, zeros, -x2 * u1], dim=-1)
    Dm = torch.cat([row1, row2], dim=-2)  # [.., 2N, 9]
    _, evecs = _eigh(Dm.mT @ Dm)
    return evecs[..., :, 0].reshape(*evecs.shape[:-2], 3, 3)


def _adjugate3(H):
    """The adjugate of [.., 3, 3] matrices (H adj(H) = det(H) I)."""
    c0 = torch.linalg.cross(H[..., 1, :], H[..., 2, :], dim=-1)
    c1 = torch.linalg.cross(H[..., 2, :], H[..., 0, :], dim=-1)
    c2 = torch.linalg.cross(H[..., 0, :], H[..., 1, :], dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)


def _safe(z):
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _transfer_terms(H, u1, u2):
    """The symmetric lifted transfer error of each correspondence: H
    [.., 3, 3] against u1, u2 [.., N, 3] -> [.., N]."""
    Hu1 = (H[..., None, :, :] @ u1[..., None])[..., 0]
    fwd = Hu1[..., :2] / _safe(Hu1[..., 2:3]) - u2[..., :2] / u2[..., 2:3]
    adj_u2 = (_adjugate3(H)[..., None, :, :] @ u2[..., None])[..., 0]
    bwd = adj_u2[..., :2] / _safe(adj_u2[..., 2:3]) - u1[..., :2] / u1[..., 2:3]
    return torch.sum(fwd * fwd + bwd * bwd, dim=-1)


def _sym_transfer_resid(H, u1, u2):
    """Symmetric lifted transfer error summed over the points: [..]."""
    return torch.sum(_transfer_terms(H, u1, u2), dim=-1)


def six_point_radial_distortion_homography(
    points1, points2, lmin: float = -5.0, lmax: float = 0.0, iters: int = 8,
    max_solutions: int = 4,
):
    """Estimate (H, l1, l2) from six correspondences.

    Parity: `SixPointRadialDistortionHomography`
    (`six_point_radial_distortion_homography.h:66`). points1, points2
    [.., 6, 2] normalized (focal-divided) distorted points; lmin / lmax the
    distortion search bounds. Returns (H [.., S, 3, 3], l1 [.., S], l2
    [.., S], valid [.., S]), S = max_solutions, ranked by residual.
    """
    dtype, device = points1.dtype, points1.device
    batch = points1.shape[:-2]

    def residual_of(lp):
        """lp [.., M, 2] -> [.., M] (points broadcast over M)."""
        p1 = points1.reshape(batch + (1,) * (lp.dim() - 1 - len(batch)) + points1.shape[-2:])
        p2 = points2.reshape(p1.shape)
        u1 = _lift(p1, lp[..., 0])
        u2 = _lift(p2, lp[..., 1])
        return _sym_transfer_resid(_dlt_h(u1, u2), u1, u2)

    coarse_1d = np.linspace(lmin, lmax, 9)
    coarse = np.stack(np.meshgrid(coarse_1d, coarse_1d), -1).reshape(-1, 2)
    grid0 = torch.as_tensor(coarse, dtype=dtype, device=device).expand(batch + (81, 2))
    r0 = residual_of(grid0)  # [.., 81]

    # The best `max_solutions` coarse cells (a stable sort) as incumbents.
    order0 = torch.sort(r0, dim=-1, stable=True).indices[..., :max_solutions]
    lp = torch.take_along_dim(grid0, order0[..., None], dim=-2)  # [.., S, 2]
    resid = torch.take_along_dim(r0, order0, dim=-1)

    offsets_1d = np.linspace(-1.0, 1.0, 5)
    offs = np.stack(np.meshgrid(offsets_1d, offsets_1d), -1).reshape(-1, 2)
    offs = torch.as_tensor(offs, dtype=dtype, device=device)  # [25, 2]
    radius0 = (lmax - lmin) / 8.0
    for i in range(iters):
        radius = radius0 * 0.35**i
        cand = lp[..., None, :] + radius * offs  # [.., S, 25, 2]
        r = residual_of(cand)  # [.., S, 25]
        best = torch.argmin(r, dim=-1)
        lp_new = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
        r_new = torch.take_along_dim(r, best[..., None], dim=-1)[..., 0]
        keep = r_new < resid
        lp = torch.where(keep[..., None], lp_new, lp)
        resid = torch.where(keep, r_new, resid)

    u1 = _lift(points1[..., None, :, :], lp[..., 0])
    u2 = _lift(points2[..., None, :, :], lp[..., 1])
    H = _dlt_h(u1, u2)
    tol = 1e-6 if dtype == torch.float32 else 1e-10
    return H, lp[..., 0], lp[..., 1], resid < tol * 6


def radial_distort_point(point_in_camera, focal_length, radial_distortion):
    """Division-model distortion of a 3D camera point to a 2D pixel.

    Parity: `DistortPoint` (`six_point_radial_distortion_homography.h:73`):
    the division model solved forward (a quadratic in the distorted radius).
    """
    x, y, z = point_in_camera[..., 0], point_in_camera[..., 1], point_in_camera[..., 2]
    zz = _safe(z)
    ru = torch.sqrt(x * x + y * y) / zz
    l = torch.as_tensor(radial_distortion, dtype=ru.dtype, device=ru.device)
    disc = torch.sqrt(torch.clamp(1.0 - 4.0 * l * ru * ru, min=0.0))
    rd = torch.where(torch.abs(l) < 1e-12, ru, (1.0 - disc) / (2.0 * l * _safe(ru)))
    scale = torch.where(torch.abs(ru) < 1e-12, torch.ones_like(ru),
                        rd / torch.clamp(ru, min=1e-12))
    return (focal_length * scale)[..., None] * torch.stack([x / zz, y / zz], dim=-1)


def radial_undistort_point(distorted_point, focal_length, radial_distortion):
    """Division-model undistortion to a unit-scale 3D ray.

    Parity: `UndistortPoint` (same header)."""
    p = distorted_point / focal_length
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    return torch.cat([p, 1.0 + radial_distortion * r2], dim=-1)


def check_radial_symmetric_error(
    H, l1, l2, point1, point2, focal_length1=1.0, focal_length2=1.0
):
    """Symmetric transfer error of each correspondence under the radial
    homography (parity: `CheckRadialSymmetricError`, same header). H
    [.., 3, 3], l1 and l2 [..] and points [.., 2] broadcast together ->
    [..]."""
    p1 = point1 / focal_length1
    p2 = point2 / focal_length2
    l1 = torch.as_tensor(l1, dtype=p1.dtype, device=p1.device)
    l2 = torch.as_tensor(l2, dtype=p1.dtype, device=p1.device)
    u1 = _lift(p1[..., None, :], l1)
    u2 = _lift(p2[..., None, :], l2)
    return _transfer_terms(H, u1, u2)[..., 0]
