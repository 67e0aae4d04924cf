"""The port's single-pair two-view verification
(`TwoViewMatchGeometricVerification`, `sfm/two_view.estimate_two_view_info`)
and the homography pieces it needs (`ops/epipolar.normalize_image_points`,
`four_point_homography`, `ransac/estimators.estimate_homography`) against
the JAX package's, on the pairs of `tests/test_two_view_verification.py`.

Bars:
  - normalization and the four-point homography in f64 to 1e-9 (the same
    closed form; LAPACK `syevd` for the 9x9 `eigh` in both);
  - the homography scorer on the JAX package's own samples: H to 1e-6
    and identical inliers (as the relative-pose scorer is held in
    `tests/test_torch_ransac_two_view.py`);
  - the verification flow with each package's own RANSAC samples: the same
    accept/reject decision, rotations within 1e-3 rad, and the ground-truth
    bars of `tests/test_two_view_verification.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import epipolar as jepi
from pytheiasfm_tpu.ransac import engine as jeng
from pytheiasfm_tpu.ransac import estimators as jest
from pytheiasfm_tpu.sfm import two_view as jtv
from pytheiasfm_tpu.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerification as JVerify,
)
from pytheiasfm_tpu.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions as JOptions,
)
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ops import epipolar as tepi
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np
from pytheiasfm_tpu_torch.ransac import engine as teng
from pytheiasfm_tpu_torch.ransac import estimators as test_
from pytheiasfm_tpu_torch.sfm import two_view as ttv
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from pytheiasfm_tpu_torch.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerification as TVerify,
)
from test_two_view_verification import _synthetic_pair
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


def _angle(a, b):
    Ra, Rb = angle_axis_to_rotation_matrix_np(a), angle_axis_to_rotation_matrix_np(b)
    return np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))


def _homography_scene(rng, n=60, n_out=20):
    H = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    H /= H[2, 2]
    p1 = rng.uniform(-1, 1, (n + n_out, 2))
    x2 = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ H.T
    p2 = x2[:, :2] / x2[:, 2:3]
    p2[n:] = rng.uniform(-1, 1, (n_out, 2))
    return H, p1, p2


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_and_four_point_homography(masked):
    rng = np.random.default_rng(11)
    H, p1, p2 = _homography_scene(rng, n_out=0)
    p1 = np.stack([p1, p1 * 2.0 + 0.3])
    p2 = np.stack([p2, p2])
    mask = np.ones(p1.shape[:2], bool)
    if masked:
        mask[:, 50:] = False
        p2[:, 50:] += rng.normal(size=(2, 10, 2))
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.tensor(mask) if masked else None
    nj, Tj = jepi.normalize_image_points(jnp.asarray(p1), m_j)
    nt, Tt = tepi.normalize_image_points(torch.tensor(p1), m_t)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-9)
    Hj, okj = jepi.four_point_homography(jnp.asarray(p1[0]), jnp.asarray(p2[0]),
                                         None if m_j is None else m_j[0])
    Ht, okt = tepi.four_point_homography(torch.tensor(p1[0]), torch.tensor(p2[0]),
                                         None if m_t is None else m_t[0])
    assert bool(okt) and bool(okj)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Ht.numpy(), H, rtol=0, atol=1e-8)


def test_homography_scorer_matches_jax_on_jax_samples():
    rng = np.random.default_rng(12)
    _, p1, p2 = _homography_scene(rng)
    p2[:60] += rng.normal(size=(60, 2)) * 1e-4
    params = jeng.RansacParameters(error_thresh=1e-6, max_iterations=64)
    key = jax.random.PRNGKey(5)
    idx = jeng._draw_samples(key, len(p1), params, 4, None)
    jm, js = jest.estimate_homography(key, jnp.asarray(p1), jnp.asarray(p2), params,
                                      quality="mle")
    tparams = teng.RansacParameters(error_thresh=1e-6, max_iterations=64)
    data = test_.TwoViewData(torch.tensor(p1)[None], torch.tensor(p2)[None])
    tm, ts = teng.score_samples(torch.tensor(np.asarray(idx))[None], data,
                                test_.HOMOGRAPHY_ESTIMATOR, tparams, quality="mle")
    np.testing.assert_allclose(tm.homography[0].numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.inliers[0].numpy(), np.asarray(js.inliers))
    assert int(ts.num_inliers[0]) == int(js.num_inliers) >= 55
    # With its own generator the port finds the plane too.
    gen = torch.Generator().manual_seed(0)
    _, own = test_.estimate_homography(gen, data.points1, data.points2, tparams, quality="mle")
    assert own.inliers[0, :60].all() and not own.inliers[0, 60:].any()


def test_estimate_two_view_info_single_pair():
    feats1, feats2, prior, aa_gt, pos_gt = _synthetic_pair(seed=6)
    opts = jtv.EstimateTwoViewInfoOptions()
    jinfo, jidx = jtv.estimate_two_view_info(
        jax.random.PRNGKey(0), opts, prior, prior, feats1.keypoints, feats2.keypoints)
    tprior = convert.camera_intrinsics_prior(prior)
    tinfo, tidx = ttv.estimate_two_view_info(
        torch.Generator().manual_seed(0), ttv.EstimateTwoViewInfoOptions(), tprior, tprior,
        feats1.keypoints, feats2.keypoints, device="cpu")
    assert _angle(tinfo.rotation_2, jinfo.rotation_2) < 1e-2
    assert abs(len(tidx) - len(jidx)) <= 0.02 * len(jidx)
    assert _angle(tinfo.rotation_2, aa_gt) < 1e-2
    # One side without a focal prior: the uncalibrated path, whose focal
    # lengths come from one minimal sample (held statistically in
    # tests/test_torch_uncalibrated_verification.py).
    uinfo, uidx = ttv.estimate_two_view_info(
        torch.Generator().manual_seed(0), ttv.EstimateTwoViewInfoOptions(), tprior,
        CameraIntrinsicsPrior(image_width=800, image_height=600),
        feats1.keypoints, feats2.keypoints, device="cpu")
    assert len(uidx) >= 0.95 * len(feats1.keypoints)
    assert _angle(uinfo.rotation_2, aa_gt) < np.radians(3.0)
    assert abs(uinfo.focal_length_1 / 800.0 - 1) < 0.3
    assert abs(uinfo.focal_length_2 / 800.0 - 1) < 0.3


def _both(opts_kw, feats1, feats2, prior, matches):
    j = JVerify(JOptions(**opts_kw), prior, prior, feats1, feats2, matches).verify_matches()
    tprior = convert.camera_intrinsics_prior(prior)
    t = TVerify(
        convert.two_view_match_geometric_verification_options(JOptions(**opts_kw)),
        tprior, tprior, convert.keypoints_and_descriptors(feats1),
        convert.keypoints_and_descriptors(feats2), matches, device="cpu",
    ).verify_matches()
    return j, t


@pytest.mark.parametrize("guided", [False, True])
def test_verify_matches_matches_jax(guided):
    """tests/test_two_view_verification.py:69-113 in both packages."""
    feats1, feats2, prior, aa_gt, pos_gt = _synthetic_pair()
    n = len(feats1.keypoints)
    rng = np.random.default_rng(1)
    correct = rng.choice(n, size=int(0.55 * n), replace=False)
    matches = [(int(i), int(i)) for i in correct]
    wrong1 = rng.choice(n, 15, replace=False)
    wrong2 = rng.permutation(wrong1)
    matches += [(int(a), int(b)) for a, b in zip(wrong1, wrong2) if a != b]
    kw = dict(min_num_inlier_matches=30, guided_matching=guided, bundle_adjustment=True)
    if guided:
        kw["guided_matching_max_distance_pixels"] = 3.0
    j, t = _both(kw, feats1, feats2, prior, matches)
    assert j is not None and t is not None
    (jm, jinfo), (tm, tinfo) = j, t
    assert _angle(tinfo.rotation_2, jinfo.rotation_2) < 1e-3
    assert all(i == k for i, k in tm)
    assert tinfo.num_verified_matches == len(tm)
    assert abs(len(tm) - len(jm)) <= 0.02 * len(jm)
    assert np.linalg.norm(tinfo.rotation_2 - aa_gt) < 0.01
    assert np.dot(tinfo.position_2, pos_gt) > 0.999
    if guided:
        assert len(tm) > 0.8 * len(correct) + 0.2 * n
    else:
        assert len(tm) >= 0.8 * len(correct)
    assert abs(tinfo.num_homography_inliers - jinfo.num_homography_inliers) <= 0.1 * len(
        matches)


def test_verify_matches_rejections_match_jax():
    """tests/test_two_view_verification.py:116-133: too few and garbage
    matches are rejected by both packages; the port rejects them on an
    uncalibrated pair too, and verifies that pair's correct matches."""
    feats1, feats2, prior, _, _ = _synthetic_pair(seed=2)
    kw = dict(min_num_inlier_matches=30)
    assert _both(kw, feats1, feats2, prior, [(0, 0)] * 10) == (None, None)
    rng = np.random.default_rng(3)
    garbage = [(int(a), int(b)) for a, b in zip(rng.integers(0, 200, 80),
                                                 rng.integers(0, 200, 80))]
    assert _both(kw, feats1, feats2, prior, garbage) == (None, None)
    bare = CameraIntrinsicsPrior(image_width=800, image_height=600)
    f1, f2 = convert.keypoints_and_descriptors(feats1), convert.keypoints_and_descriptors(feats2)

    def uncalibrated(matches):
        return TVerify(convert.two_view_match_geometric_verification_options(JOptions(**kw)),
                       bare, bare, f1, f2, matches, device="cpu").verify_matches()

    assert uncalibrated([(0, 0)] * 10) is None
    assert uncalibrated(garbage) is None
    verified, info = uncalibrated([(i, i) for i in range(40)])
    assert verified == [(i, i) for i in range(40)] and info.num_verified_matches == 40
