"""The port's guided epipolar rematch (`pytheiasfm_tpu_torch/matching/
guided_epipolar.py`) against the JAX package's `matching/guided_epipolar.py`
on the pair of `tests/test_two_view_verification.py:22-66`, with the true
fundamental matrix, half of the features already matched, and padding, and
on a pair of the ring scene of `chip_smoke.py` (cut to 1024 features a view)
with every co-visible track already matched, with its descriptors and with
every descriptor equal.

Bar: identical index arrays. Both compute in f32 (the JAX function casts to
f32 whatever it is given) from the same f64 inputs; exact duplicate
descriptors must resolve by the lowest-index rule of `jax.lax.top_k`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching.guided_epipolar import GuidedEpipolarMatcher as JGuided
from pytheiasfm_tpu.matching.guided_epipolar import guided_epipolar_match as jmatch
from pytheiasfm_tpu.matching.types import KeypointsAndDescriptors
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.matching.guided_epipolar import GuidedEpipolarMatcher as TGuided
from pytheiasfm_tpu_torch.matching.guided_epipolar import guided_epipolar_match as tmatch
from pytheiasfm_tpu_torch.tools import ring_scene as rs
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

FOCAL = 800.0
PP = (400.0, 300.0)


def _pair(seed=0, n=200, dim=32, noise=0.3):
    """Features of the two views of tests/test_two_view_verification.py and
    the true fundamental matrix."""
    rng = np.random.default_rng(seed)
    points = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n, 3))
    angle = 0.12
    R2 = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                   [-np.sin(angle), 0, np.cos(angle)]])
    c2 = np.array([1.0, 0.15, 0.0])

    def project(X, R, c):
        Xc = (X - c) @ R.T
        return Xc[:, :2] / Xc[:, 2:3] * FOCAL + np.asarray(PP)

    uv1 = project(points, np.eye(3), np.zeros(3)) + rng.normal(size=(n, 2)) * noise
    uv2 = project(points, R2, c2) + rng.normal(size=(n, 2)) * noise
    desc = rng.normal(size=(n, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    d1 = desc + rng.normal(size=desc.shape).astype(np.float32) * 0.05
    d2 = desc + rng.normal(size=desc.shape).astype(np.float32) * 0.05
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    K = np.array([[FOCAL, 0, PP[0]], [0, FOCAL, PP[1]], [0, 0, 1.0]])
    cx = np.array([[0, -c2[2], c2[1]], [c2[2], 0, -c2[0]], [-c2[1], c2[0], 0]])
    F = np.linalg.inv(K).T @ (R2 @ cx) @ np.linalg.inv(K)
    return uv1, uv2, d1, d2, F


def _run_both(F, uv1, uv2, d1, d2, m1, m2, a1, a2, dist, ratio):
    want = np.asarray(jmatch(
        jnp.asarray(F), jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(d1),
        jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(a1),
        jnp.asarray(a2), jnp.asarray(dist, jnp.float32), jnp.asarray(ratio, jnp.float32)))
    got = tmatch(*(torch.tensor(x)[None] for x in (F, uv1, uv2, d1, d2, m1, m2, a1, a2)),
                 dist, ratio)
    assert got.dtype == torch.int32 and got.shape == (1, len(uv1))
    return want, got[0].numpy()


@pytest.mark.parametrize("dist,ratio", [(2.0, 0.8), (3.0, 0.9)])
def test_guided_epipolar_match_identical(dist, ratio):
    uv1, uv2, d1, d2, F = _pair()
    n = len(uv1)
    rng = np.random.default_rng(1)
    a1 = np.zeros(n, bool)
    a2 = np.zeros(n, bool)
    done = rng.choice(n, n // 2, replace=False)
    a1[done] = a2[done] = True
    m1 = np.ones(n, bool)
    m2 = np.ones(n, bool)
    m1[-10:] = m2[-5:] = False
    want, got = _run_both(F, uv1, uv2, d1, d2, m1, m2, a1, a2, dist, ratio)
    np.testing.assert_array_equal(got, want)
    free = np.flatnonzero(want >= 0)
    assert len(free) > 0.5 * (n // 2 - 10)
    assert np.mean(want[free] == free) > 0.95  # the true matches come back


def test_guided_epipolar_match_duplicated_descriptors():
    """Exact duplicate descriptors (and points) in view 2: the lowest index
    wins, the second best equals the best, so the ratio test rejects the
    duplicated rows in both packages."""
    uv1, uv2, d1, d2, F = _pair(seed=3)
    n = len(uv1)
    for lo, hi in ((4, 150), (20, 21)):
        d2[hi] = d2[lo]
        uv2[hi] = uv2[lo]
    ones = np.ones(n, bool)
    none = np.zeros(n, bool)
    for ratio in (0.8, 1.0001):
        want, got = _run_both(F, uv1, uv2, d1, d2, ones, ones, none, none, 3.0, ratio)
        np.testing.assert_array_equal(got, want)
        assert not np.any(got == 150) and not np.any(got == 21)
    assert got[4] == 4 and got[20] == 20


def _ring_pair():
    """Views 0 and 2 of the ring scene cut to 1024 features a view, the
    true fundamental matrix, every co-visible track marked as matched, and
    for each feature of view 0 how many unmatched features of view 2 lie in
    its 2 px epipolar band."""
    views, rots, tids = rs.ring_scene(num_tracks=3000, num_features=1024)
    V = rs.NUM_VIEWS
    ang = 2 * np.pi * np.arange(V) / V
    # The ring's camera centres, from the scene's own first draw.
    z = np.random.default_rng(0).uniform(-0.3, 0.3, V)
    centers = np.stack([10 * np.cos(ang), 10 * np.sin(ang), z], -1)
    K = np.array([[rs.FOCAL, 0, rs.WIDTH / 2], [0, rs.FOCAL, rs.HEIGHT / 2], [0, 0, 1.0]])
    a, b = 0, 2
    R = rots[b] @ rots[a].T
    c = rots[a] @ (centers[b] - centers[a])
    cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
    F = np.linalg.inv(K).T @ (R @ cx) @ np.linalg.inv(K)
    ta, tb = tids[a], tids[b]
    common = np.intersect1d(ta[ta >= 0], tb[tb >= 0])
    a1, a2 = np.isin(ta, common), np.isin(tb, common)
    h1 = np.c_[views[a][0], np.ones(len(ta))]
    h2 = np.c_[views[b][0], np.ones(len(tb))]
    lines = h1 @ F.T
    dist = np.abs(lines @ h2.T) / np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
    in_band = (dist <= 2.0) & ~a2[None, :]
    return F, views[a], views[b], ta, tb, a1, a2, in_band


def test_guided_rematch_adds_only_lone_band_candidates_on_the_ring():
    """With every co-visible track of a ring pair already matched, what the
    rematch adds in both packages is wrong, and nearly all of it comes from
    unmatched features of view 1 whose epipolar band holds a single
    unmatched candidate: the second best is then +inf and passes Lowe's
    test (a band of two passes only by chance)."""
    F, (uv1, d1), (uv2, d2), ta, tb, a1, a2, in_band = _ring_pair()
    ones = np.ones(len(ta), bool)
    want, got = _run_both(F, uv1, uv2, d1, d2, ones, ones, a1, a2, 2.0, 0.8)
    np.testing.assert_array_equal(got, want)
    rows = np.flatnonzero(got >= 0)
    assert len(rows) > 0 and not np.any((ta[rows] == tb[got[rows]]) & (ta[rows] >= 0))
    assert np.mean(in_band.sum(1)[rows] == 1) >= 0.95


def test_equal_descriptors_accept_exactly_the_single_candidate_rows():
    """With every descriptor equal (all zero), Lowe's test passes only
    against a second best of +inf: both packages return, for each unmatched
    feature of view 1 whose band holds one unmatched candidate, that
    candidate, and -1 elsewhere. `chip_smoke.py` counts the rematch's lone
    candidates this way. Bar: identical index arrays, equal to the count of
    the band in f64."""
    F, (uv1, _), (uv2, _), ta, tb, a1, a2, in_band = _ring_pair()
    ones = np.ones(len(ta), bool)
    zeros1 = np.zeros((len(ta), 1), np.float32)
    zeros2 = np.zeros((len(tb), 1), np.float32)
    want, got = _run_both(F, uv1, uv2, zeros1, zeros2, ones, ones, a1, a2, 2.0, 0.8)
    np.testing.assert_array_equal(got, want)
    lone = ~a1 & (in_band.sum(1) == 1)
    assert lone.sum() > 10
    np.testing.assert_array_equal(got >= 0, lone)
    np.testing.assert_array_equal(got[lone], np.argmax(in_band[lone], axis=1))


def test_guided_epipolar_matcher_shim():
    uv1, uv2, d1, d2, F = _pair(seed=5)
    f1 = KeypointsAndDescriptors(image_name="a", keypoints=uv1, descriptors=d1)
    f2 = KeypointsAndDescriptors(image_name="b", keypoints=uv2, descriptors=d2)
    existing = [(i, i) for i in range(0, 200, 3)]
    want = JGuided(3.0, 0.8).get_matches(F, f1, f2, existing)
    got = TGuided(3.0, 0.8, device="cpu").get_matches(
        F, convert.keypoints_and_descriptors(f1), convert.keypoints_and_descriptors(f2),
        existing)
    assert got == want and len(got) > len(existing)
    jax.clear_caches()
