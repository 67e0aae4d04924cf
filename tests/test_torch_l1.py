"""The port's robust linear solvers (`math/l1.py`) against the JAX package's,
on the same random well-conditioned systems in f64.

No JAX test calls `admm_l1` directly, so both packages get the same random
overdetermined system here (with sparse gross outliers for the L1 and IRLS
solves). Bar: 1e-9 relative to the solution's norm; both run the same
fixed-step iterations in f64, and only the summation order of the products
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.math import l1 as jl1
from pytheiasfm_tpu_torch.math import l1 as tl1
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

REL = 1e-9


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    m, n = 120, 20
    A = rng.normal(size=(m, n))
    x_true = rng.normal(size=n)
    b = A @ x_true + rng.normal(size=m) * 0.01
    b[rng.choice(m, 12, replace=False)] += rng.normal(size=12) * 5.0
    return A, b, x_true


def _ops(A, lib):
    Aj = lib(A)
    return (lambda x: Aj @ x), (lambda y: Aj.T @ y)


def _check(got, want):
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= REL * np.linalg.norm(want)


def test_conjugate_gradient_matches_jax(system):
    A, b, _ = system
    N = A.T @ A + np.eye(A.shape[1])
    rhs = A.T @ b
    diag = np.diag(N).copy()
    got = tl1.conjugate_gradient(
        lambda v: torch.as_tensor(N) @ v, torch.as_tensor(rhs), iters=15,
        precond=lambda r: r / torch.as_tensor(diag),
    )
    want = jl1.conjugate_gradient(
        lambda v: jnp.asarray(N) @ v, jnp.asarray(rhs), iters=15,
        precond=lambda r: r / jnp.asarray(diag),
    )
    _check(got, want)
    # Past convergence the step guard keeps the iterate fixed, not NaN.
    done = tl1.conjugate_gradient(lambda v: torch.as_tensor(N) @ v, torch.as_tensor(rhs), iters=80)
    assert torch.isfinite(done).all()
    np.testing.assert_allclose(done.numpy(), np.linalg.solve(N, rhs), rtol=1e-9)


def test_admm_l1_matches_jax(system):
    A, b, x_true = system
    n = A.shape[1]
    got = tl1.admm_l1(*_ops(A, torch.as_tensor), torch.as_tensor(b), (n,),
                      outer_iters=40, cg_iters=20)
    want = jl1.admm_l1(*_ops(A, jnp.asarray), jnp.asarray(b), (n,), outer_iters=40, cg_iters=20)
    _check(got, want)
    # The L1 fit ignores the outliers that a least-squares fit would follow.
    assert np.linalg.norm(got.numpy() - x_true) < 0.05


def test_irls_solve_matches_jax(system):
    A, b, _ = system
    n = A.shape[1]

    def ops(lib, sqrt):
        Aj = lib(A)

        def apply_A(x, w):
            r = Aj @ x
            return r if w is None else r * sqrt(w)

        def apply_At(y, w):
            return Aj.T @ (y * sqrt(w))

        return apply_A, apply_At

    def weight(r, lib_sqrt):
        # Bounded weights keep every reweighted system well conditioned, so
        # 30 CG steps (n = 20 unknowns) solve each one.
        return 1.0 / lib_sqrt(1.0 + r)

    got = tl1.irls_solve(*ops(torch.as_tensor, torch.sqrt), torch.as_tensor(b), (n,),
                         lambda r: weight(r, torch.sqrt), outer_iters=8, cg_iters=30)
    want = jl1.irls_solve(*ops(jnp.asarray, jnp.sqrt), jnp.asarray(b), (n,),
                          lambda r: weight(r, jnp.sqrt), outer_iters=8, cg_iters=30)
    _check(got, want)
