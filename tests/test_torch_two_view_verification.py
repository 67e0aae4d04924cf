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

from pathlib import Path

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


def _clean_pairs(rng, num_pairs=4, n=48):
    """Exact normalized correspondences of `num_pairs` random relative poses
    (points 4-8 in front of both cameras), the last pair padded: its final
    8 rows masked out. Returns (points1, points2, mask, rotations,
    positions), the positions unit."""
    p1 = np.zeros((num_pairs, n, 2))
    p2 = np.zeros((num_pairs, n, 2))
    aa = rng.normal(size=(num_pairs, 3)) * 0.15
    c = rng.normal(size=(num_pairs, 3))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    for i in range(num_pairs):
        X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n, 3))
        R = angle_axis_to_rotation_matrix_np(aa[i])
        Xc = (X - c[i]) @ R.T
        p1[i] = X[:, :2] / X[:, 2:3]
        p2[i] = Xc[:, :2] / Xc[:, 2:3]
    mask = np.ones((num_pairs, n), bool)
    mask[-1, -8:] = False
    return p1, p2, mask, aa, c


VERIFIER_RECORD = Path(__file__).resolve().parent / "data" / "torch_two_view_verifier_jax.npz"
VERIFIER_ITERATIONS = 64


def _verifier_inputs():
    p1, p2, mask, aa, c = _clean_pairs(np.random.default_rng(3))
    return p1, p2, mask, np.full((len(p1),), 1e-6), aa, c


def jax_verifier_outputs():
    """The JAX package's `make_batched_verifier` on `_verifier_inputs` in
    f32, `PRNGKey(0)` split over the pairs (about 25 s to trace here, so
    recorded: `JAX_PLATFORMS=cpu python tests/torch_verifier_reference.py`)."""
    p1, p2, mask, thresh, _, _ = _verifier_inputs()
    f32 = np.float32
    run = jtv.make_batched_verifier(jeng.RansacParameters(max_iterations=VERIFIER_ITERATIONS))
    out = run(jax.random.split(jax.random.PRNGKey(0), len(p1)), jnp.asarray(p1, f32),
              jnp.asarray(p2, f32), jnp.asarray(mask), jnp.asarray(thresh, f32))
    return dict(zip(("aa", "position", "inliers", "num_inliers"), map(np.asarray, out)))


def save_verifier_record(path=VERIFIER_RECORD):
    np.savez_compressed(path, **jax_verifier_outputs())


def test_batched_verifier_matches_jax_on_clean_pairs():
    """`make_batched_verifier` against the JAX package's (recorded in
    `tests/data/torch_two_view_verifier_jax.npz`) on exact pairs, in f32,
    each package with its own draws: the same inlier sets (every unmasked
    row), rotations and positions within 1e-5 of each other and of the
    truth."""
    p1, p2, mask, thresh, aa, c = _verifier_inputs()
    with np.load(VERIFIER_RECORD) as z:
        want = dict(z)
    run = ttv.make_batched_verifier(teng.RansacParameters(max_iterations=VERIFIER_ITERATIONS))
    out = run(torch.Generator().manual_seed(0), torch.as_tensor(p1, dtype=torch.float32),
              torch.as_tensor(p2, dtype=torch.float32), torch.as_tensor(mask),
              torch.as_tensor(thresh, dtype=torch.float32))
    taa, tpos, tin, tnum = (t.numpy() for t in out)
    assert [t.shape for t in out] == [(4, 3), (4, 3), (4, 48), (4,)]
    assert out[0].dtype == torch.float32 and out[2].dtype == torch.bool
    np.testing.assert_array_equal(tin, want["inliers"])
    np.testing.assert_array_equal(tin, mask)
    np.testing.assert_array_equal(tnum, want["num_inliers"])
    np.testing.assert_allclose(taa, want["aa"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpos, want["position"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(taa, aa, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpos, c, rtol=0, atol=1e-5)


@pytest.mark.slow
def test_verifier_record_is_the_jax_package_s():
    """The JAX verifier on the record's inputs gives the record: the same
    inliers, the f32 models to 1e-6 (its rounding on another CPU)."""
    with np.load(VERIFIER_RECORD) as z:
        want = dict(z)
    got = jax_verifier_outputs()
    for k in ("inliers", "num_inliers"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("aa", "position"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_batch_verification_is_the_batched_verifier(monkeypatch):
    """`estimate_two_view_info_batch` runs stage 1 through
    `make_batched_verifier`: from one generator seed both give the same
    bits (rotation, position, inliers), in two chunks of pairs."""
    monkeypatch.setattr(ttv, "_pairs_per_chunk", lambda max_iterations: 4)
    rng = np.random.default_rng(4)
    p1, p2, mask, _, _ = _clean_pairs(rng, num_pairs=6)
    p1 += rng.normal(size=p1.shape) * 2e-4
    f, pp = 800.0, (320.0, 240.0)
    prior = CameraIntrinsicsPrior(focal_length=f, principal_point=pp, image_width=640,
                                  image_height=480)
    options = ttv.EstimateTwoViewInfoOptions(max_ransac_iterations=250)
    pix1, pix2 = p1 * f + np.asarray(pp), p2 * f + np.asarray(pp)
    infos = ttv.estimate_two_view_info_batch(
        torch.Generator().manual_seed(7), options, [prior] * 6, [prior] * 6, pix1, pix2, mask,
        device="cpu")
    params = ttv._ransac_parameters(options)
    n1, n2 = ttv._normalized([prior] * 6, [prior] * 6, pix1, pix2, True)
    thresh = ttv._thresholds(options, [prior] * 6, [prior] * 6, True)
    f32 = torch.float32
    aa, pos, inl, num = ttv.make_batched_verifier(params)(
        torch.Generator().manual_seed(7), torch.as_tensor(n1, dtype=f32),
        torch.as_tensor(n2, dtype=f32), torch.as_tensor(mask), torch.as_tensor(thresh, dtype=f32))
    for i, (info, idx) in enumerate(infos):
        assert info is not None
        np.testing.assert_array_equal(info.rotation_2, aa[i].numpy().astype(np.float64))
        np.testing.assert_array_equal(info.position_2, pos[i].numpy().astype(np.float64))
        np.testing.assert_array_equal(idx, np.flatnonzero(inl[i].numpy()))
        assert info.num_verified_matches == int(num[i])

