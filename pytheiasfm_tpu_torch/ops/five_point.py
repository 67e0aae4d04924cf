"""Batched five-point relative pose (essential matrix) solver.

Counterpart of the JAX package's `ops/five_point.py`
(`theia::FivePointRelativePose`, `sfm/pose/five_point_relative_pose.h:59`,
convention ``y^T E x = 0`` with x in image 1 and y in image 2), ported step
for step:

  1. The 4D nullspace of the 5x9 epipolar design matrix from its full SVD.
  2. E(x,y,z) = x X + y Y + z Z + W; the ten cubic constraints
     (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) expanded over the 20
     monomials of degree <= 3 with static product index tables.
  3. C(z) m(x,y) = 0 with C(z) a 10x10 matrix polynomial of degree <= 3;
     det C(z) (degree 10) recovered from batched determinants at 11
     Chebyshev nodes and one 11x11 Vandermonde solve.
  4. Real roots from the grid/bisection root finder; per root the (x, y)
     monomial vector by ridged inverse iteration on the equilibrated normal
     matrix C^T C (Cholesky + triangular solves), then a Gauss-Newton polish
     of (x, y, z) on the ten constraints.

The batched `torch.linalg` calls (`svd`, `det`, `solve_ex`, `cholesky_ex`,
`solve_triangular`) run as library code, as the JAX package leaves them to
XLA. The `_ex` variants report failures per matrix instead of raising, so a
degenerate sample turns into an invalid solution, as JAX's NaNs do.

Returns up to 10 essential matrices with a validity mask.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import polynomial as poly

__all__ = ["five_point_relative_pose", "essentials_from_nullspace"]


# Degree-1 basis over (x, y, z, 1).
_D1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]


@lru_cache(maxsize=None)
def _monomials(max_deg: int):
    out = []
    for i in range(max_deg, -1, -1):
        for j in range(max_deg - i, -1, -1):
            for k in range(max_deg - i - j, -1, -1):
                out.append((i, j, k))
    return out


_D2 = _monomials(2)  # 10 monomials
_D3 = _monomials(3)  # 20 monomials
_D2_INDEX = {m: i for i, m in enumerate(_D2)}
_D3_INDEX = {m: i for i, m in enumerate(_D3)}

# xy-monomial columns of m(x, y): degree <= 3 in (x, y).
_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
_XY_INDEX = {m: i for i, m in enumerate(_XY)}
_X_COL = _XY_INDEX[(1, 0)]
_Y_COL = _XY_INDEX[(0, 1)]
_ONE_COL = _XY_INDEX[(0, 0)]


def _mul(a, b, basis_a, out_index):
    """Product of two coefficient vectors over `basis_a` x `_D1`."""
    out = [None] * len(out_index)
    for i, mi in enumerate(basis_a):
        for j, mj in enumerate(_D1):
            k = out_index[(mi[0] + mj[0], mi[1] + mj[1], mi[2] + mj[2])]
            term = a[..., i] * b[..., j]
            out[k] = term if out[k] is None else out[k] + term
    return torch.stack(out, dim=-1)


def _mul_d1_d1(a, b):
    """[.., 4] x [.., 4] -> [.., 10] (degree-2 coefficients)."""
    return _mul(a, b, _D1, _D2_INDEX)


def _mul_d2_d1(a, b):
    """[.., 10] x [.., 4] -> [.., 20] (degree-3 coefficients)."""
    return _mul(a, b, _D2, _D3_INDEX)


# Map each degree-3 monomial to (xy column, z power) for the C(z) grouping.
_D3_TO_COL_ZP = [(_XY_INDEX[(i, j)], k) for (i, j, k) in _D3]


def _constraints_to_cz(constraints):
    """[.., 10, 20] degree-3 coefficients -> C(z) tensor [.., 10, 10, 4]."""
    batch = constraints.shape[:-2]
    czp = constraints.new_zeros(batch + (10, 10, 4))
    for mono_idx, (col, zp) in enumerate(_D3_TO_COL_ZP):
        czp[..., :, col, zp] += constraints[..., :, mono_idx]
    return czp


def five_point_relative_pose(points1: torch.Tensor, points2: torch.Tensor, mask=None):
    """points1/points2 [.., N>=5, 2] -> (E [.., 10, 3, 3], valid [.., 10]).

    A least-squares nullspace estimate is produced when N > 5, as in the
    reference (`five_point_relative_pose.h:57-58`).
    """
    dtype = points1.dtype
    x1 = torch.cat([points1, torch.ones_like(points1[..., :1])], dim=-1)
    x2 = torch.cat([points2, torch.ones_like(points2[..., :1])], dim=-1)
    # Rows: outer(y, x).flatten() encodes y^T E x with E row-major.
    Q = (x2[..., :, None] * x1[..., None, :]).reshape(points1.shape[:-1] + (9,))
    if mask is not None:
        Q = Q * mask[..., None].to(dtype)
    _, _, Vt = torch.linalg.svd(Q, full_matrices=True)
    return essentials_from_nullspace(Vt[..., -4:, :])


def essentials_from_nullspace(null: torch.Tensor):
    """Steps 2-4 of the solver from a nullspace basis [.., 4, 9] (rows X, Y,
    Z, W of E = x X + y Y + z Z + W, each a row-major 3x3) -> (E [.., 10, 3,
    3], valid [.., 10]).

    The basis of a 4D nullspace is not unique, and SVDs of different
    libraries return different ones; the real roots the grid finds (and so
    the valid slots) depend on it. Fed the same basis, this function
    reproduces the JAX solver.
    """
    dtype, device = null.dtype, null.device
    batch = null.shape[:-2]
    X = null[..., 0, :].reshape(batch + (3, 3))
    Y = null[..., 1, :].reshape(batch + (3, 3))
    Z = null[..., 2, :].reshape(batch + (3, 3))
    W = null[..., 3, :].reshape(batch + (3, 3))

    # E_ij as degree-1 coefficient vectors over (x, y, z, 1).
    E1 = torch.stack([X, Y, Z, W], dim=-1)  # [.., 3, 3, 4]

    def e1(i, j):
        return E1[..., i, j, :]

    eet = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = _mul_d1_d1(e1(i, k), e1(j, k))
                acc = term if acc is None else acc + term
            eet[i][j] = acc
    trace = eet[0][0] + eet[1][1] + eet[2][2]

    constraints = []
    det = (
        _mul_d2_d1(_mul_d1_d1(e1(1, 1), e1(2, 2)) - _mul_d1_d1(e1(1, 2), e1(2, 1)), e1(0, 0))
        - _mul_d2_d1(_mul_d1_d1(e1(1, 0), e1(2, 2)) - _mul_d1_d1(e1(1, 2), e1(2, 0)), e1(0, 1))
        + _mul_d2_d1(_mul_d1_d1(e1(1, 0), e1(2, 1)) - _mul_d1_d1(e1(1, 1), e1(2, 0)), e1(0, 2))
    )
    constraints.append(det)
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = _mul_d2_d1(eet[i][k], e1(k, j))
                acc = term if acc is None else acc + term
            constraints.append(2.0 * acc - _mul_d2_d1(trace, e1(i, j)))
    constraints = torch.stack(constraints, dim=-2)  # [.., 10, 20]

    # Row conditioning (constant scaling leaves the root set unchanged).
    row_scale = torch.amax(torch.abs(constraints), dim=-1, keepdim=True)
    constraints = constraints / torch.clamp(row_scale, min=1e-30)

    czp = _constraints_to_cz(constraints)  # [.., 10, 10, 4]

    # det C(z) at 11 Chebyshev nodes -> exact degree-10 coefficients.
    nodes = np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi)
    zpow = torch.as_tensor(
        np.stack([nodes**p for p in range(4)], axis=-1), dtype=dtype, device=device
    )  # [11, 4]
    Cz = torch.einsum("...ijp,np->...nij", czp, zpow)  # [.., 11, 10, 10]
    dets = torch.linalg.det(Cz)  # [.., 11]
    vander = torch.as_tensor(np.vander(nodes, 11), dtype=dtype, device=device)
    coeffs = torch.linalg.solve(
        vander.expand(dets.shape[:-1] + (11, 11)), dets[..., None]
    )[..., 0]  # [.., 11] degree-10 first

    roots, root_valid = poly.find_real_polynomial_roots(coeffs)

    # Nullvector of C(z*) per root -> (x, y), by ridged inverse iteration on
    # the row/column-equilibrated normal matrix C^T C.
    zr = roots  # [.., 10]
    zrp = torch.stack([torch.ones_like(zr), zr, zr * zr, zr**3], dim=-1)
    Cr = torch.einsum("...ijp,...np->...nij", czp, zrp)  # [.., 10roots, 10, 10]
    rown = torch.linalg.norm(Cr, dim=-1, keepdim=True)
    Cr = Cr / torch.clamp(rown, min=1e-30)
    coln = torch.linalg.norm(Cr, dim=-2, keepdim=True)
    Crs = Cr / torch.clamp(coln, min=1e-30)
    CtC = Crs.mT @ Crs
    ridge = 1e-6 if dtype == torch.float32 else 1e-12
    eye10 = torch.eye(10, dtype=dtype, device=device)
    Lc, info = torch.linalg.cholesky_ex(CtC + ridge * eye10)
    chol_ok = (info == 0) & torch.all(torch.isfinite(Lc), dim=-1).all(dim=-1)
    Lc = torch.where(chol_ok[..., None, None], Lc, eye10)

    m = torch.ones(Crs.shape[:-1], dtype=dtype, device=device)
    for _ in range(5):
        y = torch.linalg.solve_triangular(Lc, m[..., None], upper=False)
        m = torch.linalg.solve_triangular(Lc.mT, y, upper=True)[..., 0]
        m = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-30)
    m = m / torch.clamp(coln[..., 0, :], min=1e-30)
    m = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-30)
    denom = m[..., _ONE_COL]
    ok_scale = torch.abs(denom) > 1e-12
    safe = torch.where(ok_scale, denom, torch.ones_like(denom))
    xr = m[..., _X_COL] / safe
    yr = m[..., _Y_COL] / safe

    def _compose(x, y, z):
        return (
            x[..., None, None] * X[..., None, :, :]
            + y[..., None, None] * Y[..., None, :, :]
            + z[..., None, None] * Z[..., None, :, :]
            + W[..., None, :, :]
        )

    # Gauss-Newton polish of (x, y, z) on the 10 original constraints.
    def _constraint_values(x, y, z):
        E = _compose(x, y, z)
        EEt = E @ E.mT
        tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
        M = 2.0 * (EEt @ E) - tr[..., None, None] * E
        return torch.cat(
            [torch.linalg.det(E)[..., None], M.reshape(M.shape[:-2] + (9,))], dim=-1
        )

    eps = 1e-4 if dtype == torch.float32 else 1e-7
    eye3 = torch.eye(3, dtype=dtype, device=device)
    for _ in range(3):
        r = _constraint_values(xr, yr, zr)  # [.., 10roots, 10]
        jx = (_constraint_values(xr + eps, yr, zr) - r) / eps
        jy = (_constraint_values(xr, yr + eps, zr) - r) / eps
        jz = (_constraint_values(xr, yr, zr + eps) - r) / eps
        J = torch.stack([jx, jy, jz], dim=-1)  # [.., 10roots, 10, 3]
        JtJ = J.mT @ J + 1e-12 * eye3
        Jtr = (J.mT @ r[..., None])[..., 0]
        step, sinfo = torch.linalg.solve_ex(JtJ, Jtr)
        finite = torch.all(torch.isfinite(step), dim=-1, keepdim=True)
        step = torch.where(finite & (sinfo == 0)[..., None], step, torch.zeros_like(step))
        xr, yr, zr = xr - step[..., 0], yr - step[..., 1], zr - step[..., 2]

    E = _compose(xr, yr, zr)
    norm = torch.linalg.norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    E = E / torch.clamp(norm[..., None, None], min=1e-30)
    valid = root_valid & ok_scale & chol_ok & (norm > 1e-12)
    return E, valid
