"""The port's two-view refinements (`pytheiasfm_tpu_torch/ba/two_view.py`) and
the batched triangulation gate / pose refinement of two-view verification
(`sfm/two_view_match_geometric_verification.py`) against the JAX package's,
on the scenes of `tests/test_two_view_ba.py`, from the same starts.

Tolerances:
  - `bundle_adjust_two_views`: rotation and position to 1e-8 in f64 (the same
    GN steps on the same arithmetic; only the summation order of the
    6x6 normal equations differs), 1e-4 in f32;
  - the angular BA and the homography in f64 to 1e-8; F to 1e-8 after
    sign alignment (`svd` bases may differ in sign, which the manifold
    parametrization absorbs as an orthogonal change of variables);
  - `triangulation_gate` / `refine_relative_pose_batch` on a 3-pair f32
    batch with outliers and padding: identical keep masks, poses to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import losses as jlosses
from pytheiasfm_tpu.ba import two_view as jtv
from pytheiasfm_tpu.sfm import two_view_match_geometric_verification as jgv
from pytheiasfm_tpu_torch.ba import losses as tlosses
from pytheiasfm_tpu_torch.ba import two_view as ttv
from pytheiasfm_tpu_torch.sfm import two_view_match_geometric_verification as tgv
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


def _rot(rng, scale=0.5):
    aa = rng.normal(size=3)
    aa = aa / np.linalg.norm(aa) * rng.uniform(0.1, scale)
    th = np.linalg.norm(aa)
    K = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]]) / th
    return aa, np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _two_view_scene(rng, N=40):
    aa_gt, R_gt = _rot(rng)
    pos_gt = np.array([1.0, 0.2, -0.1])
    X = rng.uniform(-2, 2, (N, 3)) + np.array([0, 0, 6.0])
    p1 = X[:, :2] / X[:, 2:3]
    Xc = (R_gt @ (X - pos_gt).T).T
    p2 = Xc[:, :2] / Xc[:, 2:3]
    return aa_gt, pos_gt, X, p1, p2


def _j(*xs, dtype=np.float64):
    return [jnp.asarray(np.asarray(x, dtype)) for x in xs]


def _t(*xs, dtype=np.float64):
    return [torch.tensor(np.asarray(x, dtype)) for x in xs]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 1e-4)])
def test_bundle_adjust_two_views(dtype, tol):
    rng = np.random.default_rng(61)
    aa_gt, pos_gt, X, p1, p2 = _two_view_scene(rng)
    aa0 = aa_gt + rng.normal(size=3) * 0.02
    pos0 = pos_gt + rng.normal(size=3) * 0.02
    j = jtv.bundle_adjust_two_views(*_j(aa0, pos0, p1, p2, dtype=dtype))
    t = ttv.bundle_adjust_two_views(*_t(aa0, pos0, p1, p2, dtype=dtype))
    assert t[0].dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0, atol=tol)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0, atol=tol)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=0, atol=100 * tol)
    # The ground-truth bars of tests/test_two_view_ba.py.
    pos = t[1].numpy().astype(np.float64)
    scale = np.linalg.norm(pos_gt) / np.linalg.norm(pos)
    assert np.linalg.norm(t[0].numpy() - aa_gt) < (1e-5 if dtype == np.float64 else 1e-3)
    assert np.linalg.norm(pos * scale - pos_gt) < (1e-4 if dtype == np.float64 else 1e-2)


def test_bundle_adjust_two_views_batched_masked_and_robust():
    """A batch of 3 with padded rows (garbage in them) and a Huber loss."""
    rng = np.random.default_rng(65)
    aas, poss, p1s, p2s = [], [], [], []
    mask = np.ones((3, 36), bool)
    for b in range(3):
        aa_gt, pos_gt, X, p1, p2 = _two_view_scene(rng, N=36)
        aas.append(aa_gt + rng.normal(size=3) * 0.02)
        poss.append(pos_gt + rng.normal(size=3) * 0.02)
        p1s.append(p1)
        p2s.append(p2)
    mask[1, 30:] = False
    p1s[1][30:] = 0.0
    p2s[1][30:] = 0.0
    args = (np.stack(aas), np.stack(poss), np.stack(p1s), np.stack(p2s))
    kw = dict(iters=10)
    j = jtv.bundle_adjust_two_views(
        *_j(*args), mask=jnp.asarray(mask), loss=jlosses.LossFunctionType.HUBER,
        loss_width=0.05, **kw)
    t = ttv.bundle_adjust_two_views(
        *_t(*args), mask=torch.tensor(mask), loss=tlosses.LossFunctionType.HUBER,
        loss_width=0.05, **kw)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-6, atol=1e-14)


def test_bundle_adjust_two_views_angular():
    rng = np.random.default_rng(62)
    aa_gt, pos_gt, X, p1, p2 = _two_view_scene(rng)
    t_gt = pos_gt / np.linalg.norm(pos_gt)
    aa0 = aa_gt + rng.normal(size=3) * 0.03
    pos0 = t_gt + rng.normal(size=3) * 0.03
    j = jtv.bundle_adjust_two_views_angular(*_j(aa0, pos0, p1, p2))
    t = ttv.bundle_adjust_two_views_angular(*_t(aa0, pos0, p1, p2))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0, atol=1e-8)
    assert np.linalg.norm(t[0].numpy() - aa_gt) < 1e-4


def test_optimize_fundamental_matrix():
    rng = np.random.default_rng(63)
    aa_gt, R_gt = _rot(rng)
    pos_gt = np.array([0.8, -0.1, 0.3])
    f1, f2 = 700.0, 650.0
    K1 = np.diag([f1, f1, 1.0])
    K2 = np.diag([f2, f2, 1.0])
    t = -R_gt @ pos_gt
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F_gt = np.linalg.inv(K2).T @ tx @ R_gt @ np.linalg.inv(K1)
    F_gt /= np.linalg.norm(F_gt)
    X = rng.uniform(-2, 2, (50, 3)) + np.array([0, 0, 6.0])
    p1 = f1 * X[:, :2] / X[:, 2:3]
    Xc = (R_gt @ (X - pos_gt).T).T
    p2 = f2 * Xc[:, :2] / Xc[:, 2:3]
    F0 = F_gt + rng.normal(size=(3, 3)) * 0.02 * np.abs(F_gt).max()
    Fj = np.asarray(jtv.optimize_fundamental_matrix(*_j(F0, p1, p2))[0])
    Ft = ttv.optimize_fundamental_matrix(*_t(F0, p1, p2))[0].numpy()
    Ft = Ft * np.sign(np.sum(Ft * Fj))
    np.testing.assert_allclose(Ft, Fj, rtol=0, atol=1e-8)
    x1 = np.concatenate([p1, np.ones((50, 1))], 1)
    x2 = np.concatenate([p2, np.ones((50, 1))], 1)
    Fx1, Ftx2 = x1 @ Ft.T, x2 @ Ft
    sampson = np.sum(x2 * Fx1, 1) / np.sqrt((Fx1[:, :2] ** 2).sum(1) + (Ftx2[:, :2] ** 2).sum(1))
    assert np.abs(sampson).max() < 1e-4


def test_optimize_homography():
    rng = np.random.default_rng(64)
    H_gt = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    H_gt /= H_gt[2, 2]
    p1 = rng.uniform(-1, 1, (30, 2))
    x2 = np.concatenate([p1, np.ones((30, 1))], 1) @ H_gt.T
    p2 = x2[:, :2] / x2[:, 2:3]
    H0 = H_gt + rng.normal(size=(3, 3)) * 0.01
    Hj = np.asarray(jtv.optimize_homography(*_j(H0, p1, p2))[0])
    Ht = ttv.optimize_homography(*_t(H0, p1, p2))[0].numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-8)
    assert np.abs(Ht - H_gt).max() < 1e-6


@pytest.mark.parametrize("name", list(tlosses.LossFunctionType.__members__))
def test_losses(name):
    s = np.abs(np.random.default_rng(3).normal(size=64)) * 0.01
    jl, tl = jlosses.LossFunctionType[name], tlosses.LossFunctionType[name]
    for fn in ("loss_rho", "loss_weight"):
        want = np.asarray(getattr(jlosses, fn)(jnp.asarray(s), jl, 0.05))
        got = getattr(tlosses, fn)(torch.tensor(s), tl, 0.05).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def _gate_batch():
    """3 pairs of normalized correspondences (f32) padded to K = 64: pair 0
    clean, pair 1 with 8 outliers, pair 2 with 20 rows of padding and a
    point behind camera 2."""
    rng = np.random.default_rng(7)
    K = 64
    aa = np.zeros((3, 3))
    pos = np.zeros((3, 3))
    n1 = np.zeros((3, K, 2))
    n2 = np.zeros((3, K, 2))
    mask = np.ones((3, K), bool)
    for b in range(3):
        aa_gt, pos_gt, X, p1, p2 = _two_view_scene(rng, N=K)
        p1 = p1 + rng.normal(size=p1.shape) * 3e-4
        p2 = p2 + rng.normal(size=p2.shape) * 3e-4
        aa[b] = aa_gt + rng.normal(size=3) * 0.01
        pos[b] = pos_gt / np.linalg.norm(pos_gt) + rng.normal(size=3) * 0.01
        n1[b], n2[b] = p1, p2
    n2[1, :8] += rng.uniform(-0.1, 0.1, (8, 2))
    mask[2, 44:] = False
    n1[2, 44:] = 0.0
    n2[2, 44:] = 0.0
    n2[2, 0] = -n2[2, 0] * 5.0
    thr = np.full((3, 1), 4.0 / 800.0)
    return aa, pos, n1, n2, mask, thr


def test_triangulation_gate_and_refine_batch_match_jax():
    aa, pos, n1, n2, mask, thr = _gate_batch()
    f32 = np.float32
    jargs = _j(aa, pos, n1, n2, dtype=f32) + [jnp.asarray(mask)]
    targs = _t(aa, pos, n1, n2, dtype=f32) + [torch.tensor(mask)]

    Xj, keep_j = jgv.triangulation_gate(*jargs, jnp.asarray(thr * 3, f32), 2.0)
    Xt, keep_t = tgv.triangulation_gate(*targs, torch.tensor(thr * 3, dtype=torch.float32), 2.0)
    keep_j = np.asarray(keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert not keep_j[2, 44:].any() and not keep_j[1, :8].all() and keep_j[0].all()
    np.testing.assert_allclose(Xt.numpy()[keep_j], np.asarray(Xj)[keep_j], rtol=1e-4, atol=1e-4)

    aj, pj, kj = jgv.refine_relative_pose_batch(
        *jargs, jnp.asarray(thr * 3, f32), 2.0, jnp.asarray(thr, f32))
    at, pt, kt = tgv.refine_relative_pose_batch(
        *targs, torch.tensor(thr * 3, dtype=torch.float32), 2.0,
        torch.tensor(thr, dtype=torch.float32))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-4)
    assert np.asarray(kj)[0].sum() >= 60
