"""The port's two-view triangulation (`pytheiasfm_tpu_torch/ops/
triangulation.py`) against the JAX package's `ops/triangulation.py`, in f64
on the same numpy inputs.

Tolerance 1e-9 (absolute, on quantities of order 1-10): both run the same
closed-form arithmetic in f64, and LAPACK's `syevd` for the 4x4 `eigh`.
DLT points are compared de-homogenised, because the sign of an eigenvector
is arbitrary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import triangulation as jtri
from pytheiasfm_tpu_torch.ops import triangulation as ttri
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np

TOL = 1e-9


def _scene(seed, n=50, noise=1e-3):
    """Batched poses [n, 3, 4] (camera 1 identity, camera 2 per point set
    from one relative pose), noisy normalized observations [n, 2] each."""
    rng = np.random.default_rng(seed)
    R = angle_axis_to_rotation_matrix_np(rng.normal(size=3) * 0.2)
    c = np.array([1.0, 0.1, -0.2]) + rng.normal(size=3) * 0.1
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    pose1 = np.broadcast_to(np.eye(3, 4), (n, 3, 4)).copy()
    pose2 = np.broadcast_to(np.concatenate([R, (-R @ c)[:, None]], 1), (n, 3, 4)).copy()
    x1 = X[:, :2] / X[:, 2:]
    Xc = (X - c) @ R.T
    x2 = Xc[:, :2] / Xc[:, 2:]
    x1 = x1 + rng.normal(size=x1.shape) * noise
    x2 = x2 + rng.normal(size=x2.shape) * noise
    return pose1, pose2, x1, x2, X


def _both(fn_name, *args):
    j = getattr(jtri, fn_name)(*(jnp.asarray(a) for a in args))
    t = getattr(ttri, fn_name)(*(torch.tensor(a) for a in args))
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_essential_matrix_from_two_projection_matrices(seed):
    pose1, pose2, *_ = _scene(seed)
    j, t = _both("essential_matrix_from_two_projection_matrices", pose1, pose2)
    assert t.dtype == np.float64
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_optimal_image_points(seed):
    pose1, pose2, x1, x2, _ = _scene(seed)
    E = np.asarray(jtri.essential_matrix_from_two_projection_matrices(
        jnp.asarray(pose1), jnp.asarray(pose2)))
    (j1, j2), (t1, t2) = _both("find_optimal_image_points", E, x1, x2)
    np.testing.assert_allclose(t1, j1, rtol=0, atol=TOL)
    np.testing.assert_allclose(t2, j2, rtol=0, atol=TOL)
    # The correction moves the points onto the epipolar constraint.
    h1 = np.concatenate([t1, np.ones((len(t1), 1))], 1)
    h2 = np.concatenate([t2, np.ones((len(t2), 1))], 1)
    assert np.abs(np.einsum("ni,nij,nj->n", h1, E, h2)).max() < 1e-6


@pytest.mark.parametrize("name", ["triangulate_dlt", "triangulate"])
def test_triangulation_dehomogenised(name):
    pose1, pose2, x1, x2, X = _scene(2, noise=1e-4)
    j, t = _both(name, pose1, pose2, x1, x2)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(t[:, :3] / t[:, 3:], j[:, :3] / j[:, 3:], rtol=0, atol=TOL)
    # Ground truth within the noise.
    assert np.abs(t[:, :3] / t[:, 3:] - X).max() < 0.1
