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
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

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


# The N-view functions of the track estimator: a batch of tracks seen by up
# to 5 views, the last slots masked in some tracks (a masked slot carries a
# wrong observation, so a function that reads it fails the test). Points
# agree to 1e-10 (f64, de-homogenised: the eigen- and singular vectors come
# back up to sign); the angle test's boolean is equal.
NVIEW_TOL = 1e-10


def _nview(seed, T=40, N=5, noise=1e-4):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, -2], [2, 2, 2], (T, 3))
    aa = rng.normal(size=(T, N, 3)) * 0.3
    c = rng.normal(size=(T, N, 3)) * 2.0 + np.array([0.0, 0.0, -8.0])
    R = angle_axis_to_rotation_matrix_np(aa.reshape(-1, 3)).reshape(T, N, 3, 3)
    Xc = np.einsum("tnij,tnj->tni", R, X[:, None] - c)
    x = Xc[..., :2] / Xc[..., 2:] + rng.normal(size=(T, N, 2)) * noise
    poses = np.concatenate([R, -np.einsum("tnij,tnj->tni", R, c)[..., None]], -1)
    mask = np.ones((T, N), bool)
    mask[::3, 3:] = False
    x[~mask] += 0.5
    dirs = np.concatenate([x, np.ones((T, N, 1))], -1)
    dirs = np.einsum("tnji,tnj->tni", R, dirs)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return poses, x, mask, c, dirs, X


def _dehom(p):
    return p[..., :3] / p[..., 3:]


@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_midpoint(masked):
    _, _, mask, c, dirs, X = _nview(3)
    m = mask if masked else None
    if not masked:
        dirs = dirs[:, :3]
        c = c[:, :3]
    (jp, jok), (tp, tok) = _both("triangulate_midpoint", c, dirs, *([m] if masked else []))
    np.testing.assert_array_equal(tok, jok)
    assert tok.all()
    np.testing.assert_allclose(_dehom(tp), _dehom(jp), rtol=0, atol=NVIEW_TOL)
    assert np.abs(_dehom(tp) - X).max() < 0.05


@pytest.mark.parametrize("name", ["triangulate_nview", "triangulate_nview_svd"])
@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_nview_dehomogenised(name, masked):
    poses, x, mask, _, _, X = _nview(4)
    if masked:
        j, t = _both(name, poses, x, mask)
    else:
        j, t = _both(name, poses[:, :3], x[:, :3])
    if name == "triangulate_nview":
        np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(_dehom(t), _dehom(j), rtol=0, atol=NVIEW_TOL)
    assert np.abs(_dehom(t) - X).max() < 0.05


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("min_angle", [30.0, 50.0, 90.0])
def test_sufficient_triangulation_angle(masked, min_angle):
    _, _, mask, _, dirs, _ = _nview(5)
    args = (dirs, min_angle) + ((mask,) if masked else ())
    j = jtri.sufficient_triangulation_angle(*(jnp.asarray(a) for a in args))
    t = ttri.sufficient_triangulation_angle(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if min_angle == 50.0:  # the rays' widest pairs span 25-85 deg
        assert 0 < t.sum() < len(t)
