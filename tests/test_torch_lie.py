"""The port's SE(3) and Sim(3) functions (`ops/lie.py`) against the JAX
package's on the same inputs, f64, at 1e-12: one JAX call a function, on a
batch that holds general tangents and every series branch (small rotation,
small log-scale, both, and zero), made from a numpy seed; then the group
laws of `tests/test_lie.py` in the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import lie as jlie
from pytheiasfm_tpu_torch.ops import lie as tlie
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-12


def tangents():
    """[32, 7] Sim3 tangents (rho, phi, sigma); the SE3 ones are [:, :6]:
    rows 0-15 general, 16-19 small rotation, 20-23 small log-scale, 24-27
    both small, 28-29 zero rotation and scale, 30-31 zero."""
    rng = np.random.default_rng(42)
    xi = rng.normal(size=(32, 7)) * np.array([1, 1, 1, 1, 1, 1, 0.3])
    xi[16:20, 3:6] *= 1e-6
    xi[20:24, 6] *= 1e-10
    xi[24:28, 3:7] *= 1e-9
    xi[28:30, 3:7] = 0.0
    xi[30:32] = 0.0
    return xi


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.tensor(np.asarray(x)) for x in a]


def _close(got, want, tol=TOL):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def groups():
    """Elements of both groups from the JAX package's exp (the inputs of
    the other functions)."""
    xi = tangents()
    R, t = (np.asarray(x) for x in jlie.se3_exp(jnp.asarray(xi[:, :6])))
    s, Rs, ts = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(xi)))
    p = np.random.default_rng(7).normal(size=(32, 3))
    return xi, (R, t), (s, Rs, ts), p


def test_se3_exp(groups):
    xi, (R, t), _, _ = groups
    _close([x.numpy() for x in tlie.se3_exp(torch.tensor(xi[:, :6]))], [R, t])


def test_se3_log(groups):
    _, (R, t), _, _ = groups
    _close(tlie.se3_log(*_t(R, t)).numpy(), jlie.se3_log(*_j(R, t)))


def test_sim3_exp(groups):
    xi, _, sim, _ = groups
    _close([x.numpy() for x in tlie.sim3_exp(torch.tensor(xi))], list(sim))


def test_sim3_log(groups):
    _, _, sim, _ = groups
    _close(tlie.sim3_log(*_t(*sim)).numpy(), jlie.sim3_log(*_j(*sim)))


def test_se3_group_operations(groups):
    _, (R, t), _, p = groups
    R2, t2 = np.roll(R, 1, 0), np.roll(t, 1, 0)
    _close([x.numpy() for x in tlie.se3_inverse(*_t(R, t))], jlie.se3_inverse(*_j(R, t)))
    _close([x.numpy() for x in tlie.se3_multiply(*_t(R, t, R2, t2))],
           jlie.se3_multiply(*_j(R, t, R2, t2)))
    _close(tlie.se3_action(*_t(R, t, p)).numpy(), jlie.se3_action(*_j(R, t, p)))


def test_sim3_group_operations(groups):
    _, _, (s, R, t), p = groups
    s2, R2, t2 = np.roll(s, 1, 0), np.roll(R, 1, 0), np.roll(t, 1, 0)
    _close([x.numpy() for x in tlie.sim3_inverse(*_t(s, R, t))],
           jlie.sim3_inverse(*_j(s, R, t)))
    _close([x.numpy() for x in tlie.sim3_multiply(*_t(s, R, t, s2, R2, t2))],
           jlie.sim3_multiply(*_j(s, R, t, s2, R2, t2)))
    _close(tlie.sim3_action(*_t(s, R, t, p)).numpy(), jlie.sim3_action(*_j(s, R, t, p)))


def test_round_trips_and_group_laws():
    """`tests/test_lie.py`'s checks in the port: exp then log gives the
    tangent back (its small-tangent case at 1e-12); the product acts as the
    composition; an element times its inverse is the identity."""
    xi = torch.tensor(tangents())
    R, t = tlie.se3_exp(xi[:, :6])
    _close(tlie.se3_log(R, t).numpy(), xi[:, :6].numpy(), 1e-8)
    _close(tlie.se3_log(R[16:], t[16:]).numpy(), xi[16:, :6].numpy())
    s, Rs, ts = tlie.sim3_exp(xi)
    _close(tlie.sim3_log(s, Rs, ts).numpy(), xi.numpy(), 1e-8)
    p = torch.tensor(np.random.default_rng(8).normal(size=(32, 3)))
    R2, t2 = R.roll(1, 0), t.roll(1, 0)
    _close(tlie.se3_action(*tlie.se3_multiply(R, t, R2, t2), p).numpy(),
           tlie.se3_action(R, t, tlie.se3_action(R2, t2, p)).numpy(), 1e-10)
    Re, te = tlie.se3_multiply(R, t, *tlie.se3_inverse(R, t))
    _close(Re.numpy(), np.broadcast_to(np.eye(3), Re.shape))
    _close(te.numpy(), np.zeros(te.shape))
    se, Re, te = tlie.sim3_multiply(s, Rs, ts, *tlie.sim3_inverse(s, Rs, ts))
    _close(se.numpy(), np.ones(se.shape))
    _close(Re.numpy(), np.broadcast_to(np.eye(3), Re.shape))
    _close(te.numpy(), np.zeros(te.shape), 1e-11)
