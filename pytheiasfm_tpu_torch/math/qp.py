"""Quadratic programming and constrained L1 solvers (ADMM).

Counterpart of the JAX package's `math/qp.py`:
  - `theia::QPSolver` (`theia/math/qp_solver.h:65`):
    min 1/2 xᵀPx + qᵀx + r  s.t.  l <= x <= u  (box QP, ADMM).
  - `theia::ConstrainedL1Solver` (`theia/math/constrained_l1_solver.{h,cc}`):
    min ||Ax − b||_1  s.t.  Gx >= h.

Both run a fixed number of ADMM steps with matrix-free operators (matvec
closures) and CG inner solves, on the device of their inputs, with no read
back to the host inside the loop.
"""

from __future__ import annotations

import torch

from .l1 import _shrink, conjugate_gradient

__all__ = ["solve_box_qp", "solve_constrained_l1"]


def solve_box_qp(
    P_mv,
    q,
    lower,
    upper,
    x0=None,
    rho: float = 1.0,
    outer_iters: int = 200,
    cg_iters: int = 30,
):
    """Box-constrained QP by ADMM (parity: `QPSolver::Solve`, qp_solver.h:65).

    min 1/2 xᵀPx + qᵀx  s.t. lower <= x <= upper, with `P_mv` a PSD matvec.

    Returns x [n].
    """
    x = torch.zeros_like(q) if x0 is None else x0
    z = torch.clamp(x, lower, upper)
    u = torch.zeros_like(q)

    def matvec(v):
        return P_mv(v) + rho * v

    for _ in range(outer_iters):
        rhs = rho * (z - u) - q
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters)
        z = torch.clamp(x + u, lower, upper)
        u = u + x - z
    return z


def solve_constrained_l1(
    A_mv,
    At_mv,
    b,
    G_mv,
    Gt_mv,
    h,
    n: int,
    x0=None,
    rho: float = 1.0,
    outer_iters: int = 300,
    cg_iters: int = 40,
):
    """min ||Ax − b||_1 s.t. Gx >= h, by ADMM with two splittings.

    Parity: `ConstrainedL1Solver::Solve` (`constrained_l1_solver.h`): the
    same splitting (shrinkage on the residual block, projection on the
    inequality block); the (AᵀA + GᵀG)-solve is matrix-free CG.

    Args:
      A_mv/At_mv: matvec closures for A [m_a x n]; G_mv/Gt_mv for G [m_g x n];
      b [m_a]; h [m_g]; n: number of unknowns.

    Returns x [n].
    """
    x = torch.zeros(n, dtype=b.dtype, device=b.device) if x0 is None else x0
    y = A_mv(x) - b  # residual block
    s = torch.clamp(G_mv(x) - h, min=0.0)  # slack block (>= 0)
    uy = torch.zeros_like(y)
    us = torch.zeros_like(s)

    def matvec(v):
        return At_mv(A_mv(v)) + Gt_mv(G_mv(v)) + 1e-12 * v

    for _ in range(outer_iters):
        rhs = At_mv(b + y - uy) + Gt_mv(h + s - us)
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters)
        Ax_b = A_mv(x) - b
        Gx_h = G_mv(x) - h
        y = _shrink(Ax_b + uy, 1.0 / rho)
        s = torch.clamp(Gx_h + us, min=0.0)
        uy = uy + Ax_b - y
        us = us + Gx_h - s
    return x
