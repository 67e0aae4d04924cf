"""The port's uncalibrated two-view verification: `estimate_two_view_info`,
`TwoViewMatchGeometricVerification.verify_matches` and
`FeatureMatcher.match_images` on a pair without focal priors, and the
guided rematch's epipolar bands.

The JAX reference cannot be run end to end on this path: its wrapper
indexes the model's scalar fields (ROADMAP.md, section 3). Its estimator,
`estimate_uncalibrated_relative_pose`, returns, and its exact parity with
the port on the same draws is in `tests/test_torch_ransac_variants.py`.
Here the path is held to ground truth on the f = 800 pair of
`tests/test_two_view_verification.py:22-66` (seed 6, 200 points, 0.3 px
noise), over several draws of the port's generator: the focal lengths are
those of the best minimal 8-point sample, unrefined in both packages, and
one draw's error spreads from 0.5% to 25% (the JAX estimator's median over
32 keys on this pair: 5.0%, on the pair of seed 0: 6.3%). Bars: the median
over the draws of |f / 800 - 1| within 10% and, for the estimator, within
1.5x (+0.01) of the JAX estimator's median over as many keys on the same
correspondences; the median rotation error within 1 deg.

`-m slow -s` prints the JAX package's CPU constants of `chip_smoke.py`
phases 11 and 12 (run them on the chip machine's CPU with
`JAX_PLATFORMS=cpu`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ransac import engine as jeng
from pytheiasfm_tpu.ransac import estimators as jest
from pytheiasfm_tpu.sfm import estimator_options as jopts
from pytheiasfm_tpu.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions as JOptions,
)
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.matching import FeatureMatcher, FeatureMatcherOptions
from pytheiasfm_tpu_torch.matching.guided_epipolar import guided_epipolar_match
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np
from pytheiasfm_tpu_torch.sfm import two_view as ttv
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from pytheiasfm_tpu_torch.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerification as TVerify,
)
from pytheiasfm_tpu_torch.sfm.two_view_match_geometric_verification import (
    _prior_K,
    fundamental_from_two_view_info,
)
from pytheiasfm_tpu_torch.tools import localization
from pytheiasfm_tpu_torch.tools import ring_scene as rs
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)
from test_two_view_verification import FOCAL, PP, H, W, _synthetic_pair

PAIR_SEED = 6
MAX_MEDIAN_FOCAL_ERR = 0.10
JAX_RATIO, JAX_SLACK = 1.5, 0.01
MAX_MEDIAN_ROTATION_DEG = 1.0
BARE = CameraIntrinsicsPrior(image_width=W, image_height=H, principal_point=PP)


def _rotation_err_deg(aa, aa_gt):
    R, G = angle_axis_to_rotation_matrix_np(aa), angle_axis_to_rotation_matrix_np(aa_gt)
    return float(np.degrees(np.arccos(np.clip((np.trace(R @ G.T) - 1) / 2, -1, 1))))


def _medians(infos, aa_gt):
    f = [abs(i.focal_length_1 / FOCAL - 1) for i in infos] + [
        abs(i.focal_length_2 / FOCAL - 1) for i in infos]
    return float(np.median(f)), float(np.median([_rotation_err_deg(i.rotation_2, aa_gt)
                                                 for i in infos]))


def _jax_median_focal_err(kp1, kp2, keys):
    """The JAX estimator on the same centred pixels, f32, over `keys`
    PRNG keys: the median of |f / 800 - 1| over both views."""
    opts = ttv.EstimateTwoViewInfoOptions()
    params = jeng.RansacParameters(
        failure_probability=1.0 - opts.expected_ransac_confidence,
        min_iterations=opts.min_ransac_iterations, max_iterations=opts.max_ransac_iterations)
    thresh = jnp.float32(ttv.compute_resolution_scaled_threshold(
        opts.max_sampson_error_pixels, W, H) ** 2)
    run = jax.jit(lambda k, a, b: jest.estimate_uncalibrated_relative_pose(
        k, a, b, params, quality="mle", error_thresh=thresh)[0])
    a = jnp.asarray(kp1 - np.asarray(PP), jnp.float32)
    b = jnp.asarray(kp2 - np.asarray(PP), jnp.float32)
    errs = []
    for k in range(keys):
        m = run(jax.random.PRNGKey(k), a, b)
        errs += [abs(float(m.focal_length1) / FOCAL - 1), abs(float(m.focal_length2) / FOCAL - 1)]
    return float(np.median(errs))


def test_estimate_two_view_info_without_focal_priors():
    feats1, feats2, _, aa_gt, pos_gt = _synthetic_pair(seed=PAIR_SEED)
    draws = 32
    infos = []
    for s in range(draws):
        info, idx = ttv.estimate_two_view_info(
            torch.Generator().manual_seed(s), ttv.EstimateTwoViewInfoOptions(), BARE, BARE,
            feats1.keypoints, feats2.keypoints, device="cpu")
        assert info is not None and len(idx) >= 190
        assert info.num_verified_matches == len(idx) and info.visibility_score > 0
        assert np.dot(info.position_2, pos_gt) > 0.99
        infos.append(info)
    focal, rot = _medians(infos, aa_gt)
    jax_focal = _jax_median_focal_err(feats1.keypoints, feats2.keypoints, draws)
    assert focal <= MAX_MEDIAN_FOCAL_ERR and rot <= MAX_MEDIAN_ROTATION_DEG, (focal, rot)
    assert focal <= JAX_RATIO * jax_focal + JAX_SLACK, (focal, jax_focal)


def test_estimate_two_view_info_variants_without_focal_priors():
    """PROSAC (the single-pair sampler) and LO (no refit for this estimator,
    as in the JAX package) run on the uncalibrated path; a pair with one
    focal prior is uncalibrated too."""
    feats1, feats2, prior, aa_gt, _ = _synthetic_pair(seed=PAIR_SEED)
    one_prior = convert.camera_intrinsics_prior(prior)
    for kw, p1 in ((dict(ransac_type="prosac"), BARE), (dict(use_lo=True), BARE),
                   (dict(), one_prior)):
        info, idx = ttv.estimate_two_view_info(
            torch.Generator().manual_seed(0), ttv.EstimateTwoViewInfoOptions(**kw), p1, BARE,
            feats1.keypoints, feats2.keypoints, device="cpu")
        assert len(idx) >= 190 and _rotation_err_deg(info.rotation_2, aa_gt) < 3.0
        assert abs(info.focal_length_1 / FOCAL - 1) < 0.3


def _matches(n):
    rng = np.random.default_rng(1)
    wrong1 = rng.choice(n, 15, replace=False)
    wrong2 = rng.permutation(wrong1)
    return [(i, i) for i in range(n)] + [(int(a), int(b)) for a, b in zip(wrong1, wrong2)
                                         if a != b]


@pytest.mark.parametrize("guided", [False, True])
def test_verify_matches_without_focal_priors(guided):
    feats1, feats2, _, aa_gt, pos_gt = _synthetic_pair(seed=PAIR_SEED)
    matches = _matches(len(feats1.keypoints))
    kw = dict(min_num_inlier_matches=30, guided_matching=guided, bundle_adjustment=True)
    if guided:
        kw["guided_matching_max_distance_pixels"] = 3.0
    options = convert.two_view_match_geometric_verification_options(JOptions(**kw))
    f1, f2 = (convert.keypoints_and_descriptors(f) for f in (feats1, feats2))
    infos = []
    for s in range(16):
        out = TVerify(options, BARE, BARE, f1, f2, matches, device="cpu").verify_matches(
            torch.Generator().manual_seed(s))
        assert out is not None
        verified, info = out
        assert info.num_verified_matches == len(verified) >= 0.8 * 200
        assert sum(i == k for i, k in verified) >= 0.95 * len(verified)
        assert np.dot(info.position_2, pos_gt) > 0.99
        infos.append(info)
    focal, rot = _medians(infos, aa_gt)
    assert focal <= MAX_MEDIAN_FOCAL_ERR and rot <= MAX_MEDIAN_ROTATION_DEG, (focal, rot)


def test_match_images_without_focal_priors():
    """Replaces the refusal test of `tests/test_torch_feature_matcher.py`:
    the pair verifies on every draw and is held to the bars above."""
    feats1, feats2, _, aa_gt, _ = _synthetic_pair(seed=PAIR_SEED)
    infos = []
    for s in range(16):
        m = FeatureMatcher(FeatureMatcherOptions(), device="cpu", seed=s)
        m.add_image("a", feats1.keypoints, feats1.descriptors, BARE)
        m.add_image("b", feats2.keypoints, feats2.descriptors, BARE)
        out = m.match_images()
        assert [(p.image1, p.image2) for p in out] == [("a", "b")]
        info = out[0].twoview_info
        assert info.num_verified_matches == len(out[0].correspondences1) >= 0.8 * 200
        infos.append(info)
    focal, rot = _medians(infos, aa_gt)
    assert focal <= MAX_MEDIAN_FOCAL_ERR and rot <= MAX_MEDIAN_ROTATION_DEG, (focal, rot)


def _band_share(F, kp1, kp2, max_distance):
    """The share of the ground-truth correspondences (feature i with i) that
    the guided rematch's band of F finds again when the pair has no match
    yet, with identical descriptors in each view (so the band alone
    decides)."""
    n = len(kp1)
    f32 = torch.float32
    d = torch.eye(n, dtype=f32)[None]
    idx = guided_epipolar_match(
        torch.as_tensor(F, dtype=f32)[None], torch.as_tensor(kp1, dtype=f32)[None],
        torch.as_tensor(kp2, dtype=f32)[None], d, d, torch.ones(1, n, dtype=torch.bool),
        torch.ones(1, n, dtype=torch.bool), torch.zeros(1, n, dtype=torch.bool),
        torch.zeros(1, n, dtype=torch.bool), max_distance, 0.8)[0].numpy()
    return float(np.mean(idx == np.arange(n)))


def test_rematch_bands_use_the_recovered_focal_lengths():
    """A calibrated pair's rematch F is built from the prior's focal length
    as before; an uncalibrated pair's from its recovered ones, and its band
    then holds the ground-truth correspondences, where the JAX package's
    f = 1 does not (ROADMAP.md, section 3)."""
    feats1, feats2, prior, aa_gt, pos_gt = _synthetic_pair(seed=PAIR_SEED)
    cal = convert.camera_intrinsics_prior(prior)
    np.testing.assert_array_equal(_prior_K(cal), _prior_K(cal, None))
    np.testing.assert_array_equal(_prior_K(cal)[:2, :2], np.eye(2) * FOCAL)
    info, _ = ttv.estimate_two_view_info(
        torch.Generator().manual_seed(0), ttv.EstimateTwoViewInfoOptions(), BARE, BARE,
        feats1.keypoints, feats2.keypoints, device="cpu")

    def F_of(K1, K2):
        return fundamental_from_two_view_info(
            *(torch.as_tensor(x) for x in (info.rotation_2, info.position_2, K1, K2))).numpy()

    recovered = F_of(_prior_K(BARE, info.focal_length_1), _prior_K(BARE, info.focal_length_2))
    unit = F_of(_prior_K(BARE), _prior_K(BARE))
    share = _band_share(recovered, feats1.keypoints, feats2.keypoints, 3.0)
    share_unit = _band_share(unit, feats1.keypoints, feats2.keypoints, 3.0)
    assert share >= 0.9 and share_unit <= 0.2, (share, share_unit)


# ----------------------------------------------- JAX constants of chip_smoke


@pytest.mark.slow
def test_print_jax_constants_of_phase_11():
    """The JAX estimator on every co-visible pair of the jittered ring scene
    (256 pairs, ground-truth correspondences, f32, the two-view options'
    parameters, keys split from PRNGKey(0)): median focal and rotation
    errors, the constants of `chip_smoke.py` phase 11."""
    views, rots, track_ids = rs.ring_scene(look_jitter=rs.UNCALIBRATED_LOOK_JITTER)
    pairs, p1, p2, mask = rs.covisible_correspondences(views, track_ids)
    opts = ttv.EstimateTwoViewInfoOptions()
    params = jeng.RansacParameters(
        failure_probability=1.0 - opts.expected_ransac_confidence,
        min_iterations=opts.min_ransac_iterations, max_iterations=opts.max_ransac_iterations)
    thresh = jnp.float32(ttv.compute_resolution_scaled_threshold(
        opts.max_sampson_error_pixels, rs.WIDTH, rs.HEIGHT) ** 2)
    run = jax.jit(jax.vmap(lambda k, a, b, m: jest.estimate_uncalibrated_relative_pose(
        k, a, b, params, mask=m, quality="mle", error_thresh=thresh)[0]))
    keys = jax.random.split(jax.random.PRNGKey(0), len(pairs))
    pp = np.array([rs.WIDTH / 2, rs.HEIGHT / 2])
    f1, f2, R = [], [], []
    for s0 in range(0, len(pairs), 16):
        sl = slice(s0, s0 + 16)
        m = run(keys[sl], jnp.asarray(p1[sl] - pp, jnp.float32),
                jnp.asarray(p2[sl] - pp, jnp.float32), jnp.asarray(mask[sl]))
        f1.append(np.asarray(m.focal_length1))
        f2.append(np.asarray(m.focal_length2))
        R.append(np.asarray(m.rotation))
    focal, rot = rs.focal_and_rotation_errors(pairs, np.concatenate(f1), np.concatenate(f2),
                                              np.concatenate(R), rots)
    print(f"\nJAX_CPU_UNCAL_PAIRS = {len(pairs)}\nJAX_CPU_UNCAL_MEDIAN_FOCAL_ERR = {focal!r}\n"
          f"JAX_CPU_UNCAL_MEDIAN_ROTATION_DEG = {rot!r}")
    assert np.isfinite(focal) and np.isfinite(rot)


@pytest.mark.slow
def test_print_jax_constants_of_phase_12():
    """The JAX estimator `estimate_calibrated_absolute_pose` on the 553
    localization problems of `tools/localization.py`, f32, each variant in
    one vmapped run over chunks of views (keys split from PRNGKey(0)):
    median rotation and position errors and the share of views with 30
    inliers or more, the constants of `chip_smoke.py` phase 12."""
    problems = localization.build_problems()
    base = jopts.set_ransac_parameters(jopts.ReconstructionEstimatorOptions())
    P = len(problems["thresh"])
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    out = {}
    for name, (changes, quality) in localization.VARIANTS.items():
        params = dataclasses.replace(base, **changes)
        run = jax.jit(jax.vmap(lambda k, f, w, m, t, params=params, quality=quality:
                               jest.estimate_calibrated_absolute_pose(
                                   k, f, w, params, mask=m, quality=quality, error_thresh=t)))
        rot, pos, num = [], [], []
        for s0 in range(0, P, 16):
            sl = slice(s0, s0 + 16)
            model, summary = run(keys[sl], jnp.asarray(problems["feature"][sl], jnp.float32),
                                 jnp.asarray(problems["world"][sl], jnp.float32),
                                 jnp.asarray(problems["mask"][sl]),
                                 jnp.asarray(problems["thresh"][sl], jnp.float32))
            rot.append(np.asarray(model.rotation))
            pos.append(np.asarray(model.position))
            num.append(np.asarray(summary.num_inliers))
        out[name] = localization.errors(np.concatenate(rot), np.concatenate(pos),
                                        np.concatenate(num), problems)
    print("\nJAX_CPU_LOCALIZATION = {")
    for name, (rot, pos, share) in out.items():
        print(f"    {name!r}: ({rot!r}, {pos!r}, {share!r}),")
    print("}")
