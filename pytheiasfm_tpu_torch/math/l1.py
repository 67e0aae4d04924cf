"""Robust linear solvers: operator-form ADMM L1 and IRLS least squares.

Counterpart of the JAX package's `math/l1.py` (`theia/math/l1_solver.h:87`,
ADMM least-absolute-deviation, and the IRLS refinement inside
`robust_rotation_estimator.h:127-140`). The matrix never materializes:
callers pass `matvec` closures and every solve is preconditioned conjugate
gradient. Every loop runs a fixed number of steps, as the JAX package's
`lax.scan` does, and none reads a value back to the host, so a device
never waits on the host inside a solve.
"""

from __future__ import annotations

import torch

__all__ = ["conjugate_gradient", "admm_l1", "irls_solve", "seeded_normal"]


def seeded_normal(shape, dtype, device, seed: int):
    """A standard normal draw of `shape` from a CPU generator seeded `seed`,
    then moved to `device`: the same start on every device. The solvers'
    random starts (the JAX package draws them from `jax.random`)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype).to(device)


def conjugate_gradient(matvec, b, x0=None, iters: int = 50, precond=None):
    """CG for SPD `matvec`, a fixed number of steps; `precond`: an
    approximate inverse."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda r: r
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def _shrink(v, kappa):
    return torch.sign(v) * torch.clamp(torch.abs(v) - kappa, min=0.0)


def admm_l1(
    apply_A,
    apply_At,
    b,
    x_shape,
    rho: float = 1.0,
    outer_iters: int = 100,
    cg_iters: int = 30,
    precond=None,
    x0=None,
    normal_matvec=None,
):
    """minimize ||A x - b||_1 by ADMM in operator form.

    Parity: `theia::L1Solver` (`l1_solver.h:70-85`, scaled-dual ADMM).
    The x-update solves AᵀA x = Aᵀ(b + z - u) with CG; the z-update is soft
    thresholding with 1/rho; u is the scaled dual. `normal_matvec`: an
    optional v -> AᵀA v for the inner CG (a materialized normal matrix).
    """
    x = torch.zeros(x_shape, dtype=b.dtype, device=b.device) if x0 is None else x0
    z = apply_A(x) - b
    u = torch.zeros_like(b)
    normal = normal_matvec or (lambda v: apply_At(apply_A(v)))
    for _ in range(outer_iters):
        rhs = apply_At(b + z - u)
        x = conjugate_gradient(normal, rhs, x0=x, iters=cg_iters, precond=precond)
        Ax = apply_A(x)
        z = _shrink(Ax - b + u, 1.0 / rho)
        u = u + Ax - b - z
    return x


def irls_solve(
    apply_A,
    apply_At,
    b,
    x_shape,
    weight_fn,
    group_fn=None,
    outer_iters: int = 10,
    cg_iters: int = 30,
    precond=None,
    x0=None,
):
    """Iteratively reweighted least squares: min Σ w(r) r².

    `weight_fn(residual_norms) -> weights` maps per-group residual norms to
    weights; `group_fn(residual) -> norms` reduces the raw residual to
    per-group magnitudes (default: elementwise |r|). `apply_A(x, w)` and
    `apply_At(y, w)` take the weights (None for the unweighted residual).
    """
    x = torch.zeros(x_shape, dtype=b.dtype, device=b.device) if x0 is None else x0
    if group_fn is None:
        group_fn = torch.abs
    for _ in range(outer_iters):
        r = apply_A(x, None) - b
        w = weight_fn(group_fn(r))
        matvec = lambda v, w=w: apply_At(apply_A(v, w), w)
        rhs = apply_At(b, w)
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters, precond=precond)
    return x
