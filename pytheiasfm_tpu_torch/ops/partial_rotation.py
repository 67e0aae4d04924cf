"""Minimal pose solvers with a known rotation axis ("partial rotation").

Counterpart of the JAX package's `ops/partial_rotation.py`
(`theia/sfm/pose/two_point_pose_partial_rotation.h`,
`three_point_relative_pose_partial_rotation.h`,
`four_point_relative_pose_partial_rotation.h`,
`sim_transform_partial_rotation.h`). As there, the rotation about the unit
axis a is written in tan-half-angle form,

    R(w) = I + (2w / (1 + w^2)) [a]_x + (2w^2 / (1 + w^2)) [a]_x^2,
    M(w) = (1 + w^2) R(w), a quadratic matrix polynomial in w,

so that every constraint set is G(w) y = 0 with y the remaining linear
unknowns. det G(w) is a polynomial in w whose coefficients come from its
values at Chebyshev nodes times the pseudo-inverse of their Vandermonde
matrix (numpy constants, built once a degree); its real roots are found by
`ops/polynomial.find_real_polynomial_roots`, and y by back-substitution at
each root (with 3 Gauss-Newton steps in w for the generalized solvers,
the derivative by forward-mode AD).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd import forward_ad

from . import polynomial as poly
from .rotation import hat
from .triangulation import _svd

__all__ = [
    "two_point_pose_partial_rotation",
    "three_point_relative_pose_partial_rotation",
    "four_point_relative_pose_partial_rotation",
    "sim_transform_partial_rotation",
    "axis_rotation_matrix",
]


def _axis(axis, like):
    return torch.as_tensor(axis, dtype=like.dtype, device=like.device)


def axis_rotation_matrix(axis, w):
    """R(w): the rotation by 2 atan(w) about the unit ``axis``; ``w`` may
    carry leading axes beyond ``axis``'s."""
    K = hat(_axis(axis, w))
    K2 = K @ K
    denom = 1.0 + w**2
    s = 2.0 * w / denom
    c1 = 2.0 * w**2 / denom
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s[..., None, None] * K + c1[..., None, None] * K2


def _m_poly(axis, w):
    """M(w) = (1 + w^2) I + 2w [a]_x + 2w^2 [a]_x^2."""
    K = hat(_axis(axis, w))
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return ((1.0 + w**2)[..., None, None] * eye + (2.0 * w)[..., None, None] * K
            + (2.0 * w**2)[..., None, None] * K2)


def _rows_times(M, v):
    """Each row vector of v [.., n, 3] times M [.., 3, 3]^T: M v_i."""
    return v @ M.mT


@functools.lru_cache(maxsize=None)
def _interpolation(eff_degree: int):
    """The Chebyshev nodes (scaled to a generous root window; tan-half-angle
    roots of these problems are O(1)) and the pseudo-inverse of their
    Vandermonde matrix, columns highest power first (numpy, f64)."""
    n = eff_degree + 1
    k = np.arange(n)
    nodes = 3.0 * np.cos((2 * k + 1) * np.pi / (2 * n))
    V = np.vander(nodes, n, increasing=False)
    return nodes, np.linalg.pinv(V).astype(np.float64)


def _roots_from_det(det_fn, degree: int, like, max_roots: int, clear_power: int = 0):
    """The real roots of w -> det_fn(w), where det_fn maps nodes [.., K] to
    determinants [.., K]. ``clear_power`` divides the values by
    (1 + w^2)^clear_power, the root-free factor of the tan-half-angle
    clearing, which lowers the interpolation degree by 2 clear_power.
    Returns the first ``max_roots`` slots, valid ones first (stable)."""
    nodes, V_pinv = _interpolation(degree - 2 * clear_power)
    nodes = torch.as_tensor(nodes, dtype=like.dtype, device=like.device)
    vals = det_fn(nodes)  # [.., K]
    if clear_power:
        vals = vals / (1.0 + nodes**2) ** clear_power
    coeffs = vals @ torch.as_tensor(V_pinv, dtype=like.dtype, device=like.device).mT
    roots, valid = poly.find_real_polynomial_roots(coeffs)
    order = torch.sort(torch.where(valid, 0.0, 1.0), dim=-1, stable=True).indices
    take = order[..., :max_roots]
    return torch.take_along_dim(roots, take, dim=-1), torch.take_along_dim(valid, take, dim=-1)


def _ortho_basis(r):
    """Two orthonormal vectors spanning the plane orthogonal to each unit
    vector r [.., 3] -> [.., 2, 3]."""
    abs_r = torch.abs(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    seed = torch.where(
        (abs_r[..., 0:1] <= abs_r[..., 1:2]) & (abs_r[..., 0:1] <= abs_r[..., 2:3]),
        eye[0].expand(r.shape),
        torch.where(abs_r[..., 1:2] <= abs_r[..., 2:3], eye[1].expand(r.shape),
                    eye[2].expand(r.shape)),
    )
    b1 = torch.linalg.cross(r, seed, dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return torch.stack([b1, torch.linalg.cross(r, b1, dim=-1)], dim=-2)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _newton_w(r_of, w, steps=3):
    """Gauss-Newton in the scalar w [..] on residuals r_of(w) [.., n]."""
    for _ in range(steps):
        with forward_ad.dual_level():
            r, dr = forward_ad.unpack_dual(
                r_of(forward_ad.make_dual(w, torch.ones_like(w))))
        num = torch.sum(r * dr, dim=-1)
        den = torch.clamp(torch.sum(dr * dr, dim=-1), min=1e-30)
        w = w - num / den
    return w


def two_point_pose_partial_rotation(axis, model_points, image_rays):
    """Absolute pose with a known rotation axis from two 2D-3D rays.

    Parity: `TwoPointPosePartialRotation`
    (`pose/two_point_pose_partial_rotation.h:56`): ray_i is parallel to
    R p_i + t with R a rotation about ``axis``. axis [3] unit;
    model_points [.., 2, 3]; image_rays [.., 2, 3] (need not be unit).
    Returns (rotations [.., 2, 3, 3], translations [.., 2, 3], valid [.., 2]).
    """
    dtype = image_rays.dtype
    B = _ortho_basis(_unit(image_rays))  # [.., 2, 2, 3]
    B_flat = B.reshape(*B.shape[:-3], 4, 3)
    p_sel = model_points[..., [0, 0, 1, 1], :]  # [.., 4, 3]

    def G_of(w):  # w [.., K] -> [.., K, 4, 4]
        Mp = _rows_times(_m_poly(axis, w), p_sel[..., None, :, :])  # [.., K, 4, 3]
        Bk = B_flat[..., None, :, :]
        c_last = torch.sum(Bk * Mp, dim=-1)
        c_t = (1.0 + w**2)[..., None, None] * Bk
        return torch.cat([c_t.expand(Mp.shape), c_last[..., None]], dim=-1)

    batch = image_rays.shape[:-2]
    # Columns 1-3 of degree 2, column 4 of degree 2: det of degree <= 8.
    roots, valid = _roots_from_det(
        lambda nodes: torch.linalg.det(G_of(nodes.expand(batch + nodes.shape))), 8,
        image_rays, max_roots=2, clear_power=3)

    G = G_of(roots)  # [.., 2, 4, 4]
    # t from the first 3 equations: (1 + w^2) B[:3] t = -c_last[:3].
    t = torch.linalg.solve_ex(G[..., :3, :3], -G[..., :3, 3:4])[0][..., 0]
    resid = torch.abs(torch.sum(G[..., 3, :3] * t, dim=-1) + G[..., 3, 3])
    rotations = axis_rotation_matrix(axis, roots)
    tol = 1e-4 if dtype == torch.float32 else 1e-8
    valid = valid & (resid < tol * (1.0 + torch.linalg.norm(t, dim=-1)))
    return rotations, t, valid


def three_point_relative_pose_partial_rotation(axis, image1_rays, image2_rays):
    """Relative pose (R about a known axis, t up to scale) from 3 ray pairs.

    Parity: `ThreePointRelativePosePartialRotation`
    (`pose/three_point_relative_pose_partial_rotation.h:57`): per
    correspondence t . (R r1 x r2) = 0. axis [3]; image{1,2}_rays
    [.., 3, 3]. Returns (rotations [.., 6, 3, 3], unit translations
    [.., 6, 3] (the null vector of a 3x3 SVD: its sign is the solver's),
    valid [.., 6]).
    """
    dtype = image1_rays.dtype
    r1 = _unit(image1_rays)[..., None, :, :]
    r2 = _unit(image2_rays)[..., None, :, :]

    def A_of(w):  # [.., K, 3, 3]; rows (M(w) r1_i) x r2_i
        return torch.linalg.cross(_rows_times(_m_poly(axis, w), r1), r2, dim=-1)

    batch = image1_rays.shape[:-2]
    roots, valid = _roots_from_det(
        lambda nodes: torch.linalg.det(A_of(nodes.expand(batch + nodes.shape))), 6,
        image1_rays, max_roots=6)
    _, s, Vt = _svd(A_of(roots))
    t = Vt[..., 2, :]
    resid = s[..., 2] / torch.clamp(s[..., 0], min=1e-20)
    tol = 1e-3 if dtype == torch.float32 else 1e-7
    return axis_rotation_matrix(axis, roots), t, valid & (resid < tol)


def _generalized_rows(axis, w, d1, o1, d2, o2):
    """Rows of the generalized epipolar constraint, cleared of (1 + w^2)^2:
    with X2 = s R X1 + t, per correspondence
      t . (R d1 x d2) + (d2 x (s R o1 - o2)) . R d1 = 0, i.e.
      coeff_t = (M d1 x d2)(1 + w^2) [.., 3], coeff_s = (d2 x M o1) . M d1,
      coeff_1 = -(d2 x o2) . M d1 (1 + w^2).
    w [.., K]; the rays [.., 1, n, 3]."""
    M = _m_poly(axis, w)
    Md1 = _rows_times(M, d1)
    Mo1 = _rows_times(M, o1)
    one = (1.0 + w**2)[..., None]
    coeff_t = torch.linalg.cross(Md1, d2.expand(Md1.shape), dim=-1) * one[..., None]
    coeff_s = torch.sum(torch.linalg.cross(d2.expand(Mo1.shape), Mo1, dim=-1) * Md1, dim=-1)
    coeff_1 = -torch.sum(torch.linalg.cross(d2, o2, dim=-1) * Md1, dim=-1) * one
    return coeff_t, coeff_s, coeff_1


def _generalized_residual(axis, w, t, s, d1, o1, d2, o2):
    """The generalized epipolar constraint of each correspondence at the
    pose (R(w), t, s): (residuals [.., K, n], d2 x (s R o1 + t - o2))."""
    R = axis_rotation_matrix(axis, w)
    Rd1 = _rows_times(R, d1)
    Ro1 = _rows_times(R, o1)
    lhs = torch.linalg.cross(d2.expand(Ro1.shape),
                             s[..., None, None] * Ro1 + t[..., None, :] - o2, dim=-1)
    return torch.sum(lhs * Rd1, dim=-1), lhs


def four_point_relative_pose_partial_rotation(
    axis, image1_directions, image1_origins, image2_directions, image2_origins
):
    """Generalized-camera relative pose with a known rotation axis (4 rays).

    Parity: `FourPointRelativePosePartialRotation`
    (`pose/four_point_relative_pose_partial_rotation.h:59`). axis [3];
    image{1,2}_directions / origins [.., 4, 3]. Returns (rotations
    [.., 8, 3, 3], translations [.., 8, 3], valid [.., 8]).
    """
    dtype = image1_directions.dtype
    d1 = _unit(image1_directions)[..., None, :, :]
    d2 = _unit(image2_directions)[..., None, :, :]
    o1 = image1_origins[..., None, :, :]
    o2 = image2_origins[..., None, :, :]

    def G_of(w):  # [.., K, 4, 4]: [coeff_t | coeff_s + coeff_1] with s = 1
        ct, cs, c1 = _generalized_rows(axis, w, d1, o1, d2, o2)
        return torch.cat([ct, (cs + c1)[..., None]], dim=-1)

    def t_of(w):
        G = G_of(w)
        return torch.linalg.solve_ex(G[..., :3, :3], -G[..., :3, 3:4])[0][..., 0]

    def r_of(w):
        # The translation re-solved exactly at w (variable projection).
        return _generalized_residual(axis, w, t_of(w), torch.ones_like(w), d1, o1, d2, o2)

    batch = image1_directions.shape[:-2]
    # Every column of degree <= 4: det of degree <= 16.
    roots, valid = _roots_from_det(
        lambda nodes: torch.linalg.det(G_of(nodes.expand(batch + nodes.shape))), 16,
        image1_directions, max_roots=8, clear_power=3)
    w = _newton_w(lambda u: r_of(u)[0], roots)
    resid, lhs = r_of(w)
    resid = torch.amax(torch.abs(resid) / (1.0 + torch.linalg.norm(lhs, dim=-1)), dim=-1)
    tol = 1e-3 if dtype == torch.float32 else 1e-6
    return axis_rotation_matrix(axis, w), t_of(w), valid & (resid < tol)


def sim_transform_partial_rotation(
    axis, image1_directions, image1_origins, image2_directions, image2_origins
):
    """Similarity transform (scale, rotation about a known axis,
    translation) from five generalized ray correspondences.

    Parity: `SimTransformPartialRotation`
    (`pose/sim_transform_partial_rotation.h:61`): X2 = s R X1 + t. axis [3];
    image{1,2}_directions / origins [.., 5, 3]. Returns (rotations
    [.., 8, 3, 3], translations [.., 8, 3], scales [.., 8], valid [.., 8]).
    """
    dtype = image1_directions.dtype
    d1 = _unit(image1_directions)[..., None, :, :]
    d2 = _unit(image2_directions)[..., None, :, :]
    o1 = image1_origins[..., None, :, :]
    o2 = image2_origins[..., None, :, :]

    def G_of(w):  # [.., K, 5, 5]: columns [t(3) | s | 1]
        ct, cs, c1 = _generalized_rows(axis, w, d1, o1, d2, o2)
        return torch.cat([ct, cs[..., None], c1[..., None]], dim=-1)

    def y_of(w):
        G = G_of(w)
        return torch.linalg.solve_ex(G[..., :4, :4], -G[..., :4, 4:5])[0][..., 0]

    def r_of(w):
        y = y_of(w)
        return _generalized_residual(axis, w, y[..., :3], y[..., 3], d1, o1, d2, o2)

    batch = image1_directions.shape[:-2]
    # All five columns of degree <= 4: det of degree <= 20.
    roots, valid = _roots_from_det(
        lambda nodes: torch.linalg.det(G_of(nodes.expand(batch + nodes.shape))), 20,
        image1_directions, max_roots=8, clear_power=4)
    w = _newton_w(lambda u: r_of(u)[0], roots)
    resid, lhs = r_of(w)
    resid = torch.amax(torch.abs(resid) / (1.0 + torch.linalg.norm(lhs, dim=-1)), dim=-1)
    y = y_of(w)
    tol = 1e-3 if dtype == torch.float32 else 1e-6
    valid = valid & (resid < tol) & (y[..., 3] > 0)
    return axis_rotation_matrix(axis, w), y[..., :3], y[..., 3], valid
