"""The port's radial-distortion homography (`ops/radial_homography.py`) and
planar orthographic pose (`ops/orthographic.py`) against the JAX package's
on the same inputs, f64: one JAX call a function, on a batch that holds
every case (the scenes of `tests/test_ortho_radial_homography.py`, with
their distortions, rotations and magnifications varied by numpy seeds).

Bars: the valid masks equal; distortions, poses and magnifications to
1e-8; H to 1e-8 after both are scaled to unit norm with the sign of their
largest entry positive (the DLT's eigenvector has no sign or scale); and
the JAX test's ground-truth recoveries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import orthographic as jortho
from pytheiasfm_tpu.ops import radial_homography as jrh
from pytheiasfm_tpu_torch.ops import orthographic as tortho
from pytheiasfm_tpu_torch.ops import radial_homography as trh
from test_ortho_radial_homography import _rot
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-8
# (l1, l2) of each radial-homography problem; the first is the JAX test's.
DISTORTIONS = [(-0.8, -1.5), (-0.3, -0.6), (-1.2, -0.4), (-2.0, -2.5), (-0.1, -3.0),
               (-0.6, -0.6)]


def _distort(u, l):
    """The division model inverted along each ray (the JAX test's)."""
    rho = np.linalg.norm(u, axis=1, keepdims=True)
    return u / rho * (1 - np.sqrt(1 - 4 * l * rho**2)) / (2 * l * rho)


def homography_cases():
    """points1, points2 [6, 6, 2] and the ground truth (H, l1, l2)."""
    p1, p2, gt = [], [], []
    for i, (l1, l2) in enumerate(DISTORTIONS):
        rng = np.random.default_rng(32 + i)
        H = _rot(rng, 0.4) + rng.normal(size=(3, 3)) * 0.05
        u1 = rng.uniform(-0.4, 0.4, (6, 2))
        u2h = (H @ np.concatenate([u1, np.ones((6, 1))], 1).T).T
        p1.append(_distort(u1, l1))
        p2.append(_distort(u2h[:, :2] / u2h[:, 2:3], l2))
        gt.append((H, l1, l2))
    return np.stack(p1), np.stack(p2), gt


def ortho_cases():
    """features [4, 6, 2], planar world points [4, 6, 3], magnifications."""
    feats, worlds, ms = [], [], []
    for i, m in enumerate([350.0, 80.0, 1200.0, 15.0]):
        rng = np.random.default_rng(31 + 10 * i)
        R = _rot(rng)
        X = np.concatenate([rng.uniform(-1, 1, (6, 2)), np.zeros((6, 1))], axis=1)
        feats.append(m * (R[:2] @ X.T).T + np.array([12.0, -7.0]) * (i + 1))
        worlds.append(X)
        ms.append(m)
    return np.stack(feats), np.stack(worlds), np.array(ms)


def _unit_h(H):
    H = H / np.linalg.norm(H, axis=(-1, -2), keepdims=True)
    flat = H.reshape(*H.shape[:-2], 9)
    big = np.take_along_axis(flat, np.argmax(np.abs(flat), -1)[..., None], -1)
    return H * np.sign(big)[..., None]


@pytest.fixture(scope="module")
def homography():
    p1, p2, gt = homography_cases()
    want = [np.asarray(x) for x in jrh.six_point_radial_distortion_homography(
        jnp.asarray(p1), jnp.asarray(p2))]
    got = [x.numpy() for x in trh.six_point_radial_distortion_homography(
        torch.tensor(p1), torch.tensor(p2))]
    return want, got, gt


def test_six_point_matches_the_jax_package(homography):
    want, got, _ = homography
    valid = want[3]
    assert valid.any()
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    np.testing.assert_allclose(_unit_h(got[0])[valid], _unit_h(want[0])[valid], rtol=0, atol=TOL)


def test_six_point_recovers_ground_truth(homography):
    """The JAX test's bar (l1, l2 within 0.05 for a valid solution) on
    every problem the JAX package recovers, and on the JAX test's own."""
    want, got, gt = homography
    for b, (_, l1, l2) in enumerate(gt):
        hit = [bool(r[3][b, k]) and abs(r[1][b, k] - l1) < 0.05 and abs(r[2][b, k] - l2) < 0.05
               for r in (want, got) for k in range(4)]
        assert any(hit[4:]) >= any(hit[:4]), b
    assert any(got[3][0] & (np.abs(got[1][0] + 0.8) < 0.05) & (np.abs(got[2][0] + 1.5) < 0.05))


def test_distortion_helpers_match_the_jax_package():
    rng = np.random.default_rng(33)
    pts3 = np.concatenate([rng.uniform(-0.5, 0.5, (10, 2)), np.ones((10, 1))], axis=1)
    pts3[:3, 2] = [2.0, 0.5, 1e-13]  # one at zero depth
    f, l = 450.0, -0.9
    want = np.asarray(jrh.radial_distort_point(jnp.asarray(pts3), f, l))
    got = trh.radial_distort_point(torch.tensor(pts3), f, l).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    want_u = np.asarray(jrh.radial_undistort_point(jnp.asarray(want), f, l))
    got_u = trh.radial_undistort_point(torch.tensor(want), f, l).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=1e-12)
    # The round trip gives rays parallel to the points (the JAX test).
    np.testing.assert_allclose((got_u / got_u[:, 2:3])[3:], pts3[3:], rtol=0, atol=1e-8)


def test_symmetric_error_matches_the_jax_package(homography):
    want, _, _ = homography
    H = want[0][0, 0]
    rng = np.random.default_rng(34)
    x1, x2 = rng.uniform(-0.5, 0.5, (2, 12, 2))
    ref = np.asarray(jrh.check_radial_symmetric_error(
        jnp.asarray(H), -0.3, -0.5, jnp.asarray(x1), jnp.asarray(x2), 2.0, 1.5))
    got = trh.check_radial_symmetric_error(
        torch.tensor(H), -0.3, -0.5, torch.tensor(x1), torch.tensor(x2), 2.0, 1.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)


def test_orthographic_matches_the_jax_package():
    feats, worlds, ms = ortho_cases()
    want = [np.asarray(x) for x in jortho.planar_uncalibrated_orthographic_pose(
        jnp.asarray(feats), jnp.asarray(worlds))]
    got = [x.numpy() for x in tortho.planar_uncalibrated_orthographic_pose(
        torch.tensor(feats), torch.tensor(worlds))]
    np.testing.assert_array_equal(got[3], want[3])
    assert want[3].all()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    # The JAX test's bars: the magnification, and a solution that reprojects.
    np.testing.assert_allclose(got[2], ms, rtol=1e-6)
    for b in range(len(ms)):
        err = min(np.abs(got[2][b] * (got[0][b, k][:2] @ worlds[b].T).T
                         + got[2][b] * got[1][b, k][:2] - feats[b]).max() for k in range(2))
        assert err < 1e-6 * max(1.0, ms[b] / 350.0)


def test_orthographic_principal_point():
    """A principal point given is subtracted first: the same solution as
    the centred features without it."""
    feats, worlds, _ = ortho_cases()
    pp = torch.tensor([[3.0, -2.0]] * len(feats), dtype=torch.float64)
    plain = tortho.planar_uncalibrated_orthographic_pose(torch.tensor(feats), torch.tensor(worlds))
    shifted = tortho.planar_uncalibrated_orthographic_pose(
        torch.tensor(feats) + pp[:, None], torch.tensor(worlds), pp)
    for a, b in zip(plain, shifted):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10, atol=1e-10)
