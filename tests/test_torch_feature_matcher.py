"""The slice as a whole: the port's `FeatureMatcher.match_images` against the
JAX package's on the scene of `tests/test_matching.py:133-158` (4 views,
120 tracks, 32-D descriptors), calibrated priors.

Bars:
  - without verification the correspondences are identical;
  - stage 1 alone (`bundle_adjustment=False`): the same pairs verify and the
    relative rotations agree to 2e-3 rad (the two packages draw different
    RANSAC samples, and the best minimal model at 0.02 px noise is off by
    about 20x the noise in angle);
  - default options (stage 2: triangulation gate + two-view BA), guided
    rematch off and on: the same pairs verify, rotations agree to 2e-4 rad
    (both refine to the same optimum from different RANSAC starts) and the
    verified counts within 2%.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching import BruteForceFeatureMatcher as JMatcher
from pytheiasfm_tpu.matching import FeatureMatcherOptions as JOptions
from pytheiasfm_tpu.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions as JGVOptions,
)
from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.matching import (
    BruteForceFeatureMatcher,
    FeatureMatcher,
    FeatureMatcherOptions,
)
from pytheiasfm_tpu_torch.matching import streaming_matcher as sm
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior


def _rand_unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def scene():
    """Per view: (name, keypoints, descriptors, JAX prior)."""
    recon, _, _ = generate_scene(
        SyntheticSceneOptions(num_views=4, num_tracks=120, pixel_noise=0.02, seed=21)
    )
    track_desc = _rand_unit(np.random.default_rng(0), 120, 32)
    rng = np.random.default_rng(42)
    views = []
    for v in range(recon.num_views()):
        tracks = recon.tracks_in_view(v)
        kps = np.stack([recon.obs_uv[recon._view_track_to_obs[v][t]] for t in tracks])
        descs = track_desc[tracks] + rng.normal(size=(len(tracks), 32)).astype(
            np.float32) * 0.01
        views.append((recon.view_names[v], kps, descs.astype(np.float32),
                      recon.view_priors[v]))
    return views


def _options(verify: bool):
    return JOptions(
        min_num_feature_matches=20,
        perform_geometric_verification=verify,
        geometric_verification_options=JGVOptions(bundle_adjustment=False),
    )


def _run_both(views, verify):
    jm = JMatcher(_options(verify))
    tm = BruteForceFeatureMatcher(convert.feature_matcher_options(_options(verify)),
                                  device="cpu")
    for name, kps, descs, prior in views:
        jm.add_image(name, kps, descs, prior)
        tm.add_image(name, kps, descs, convert.camera_intrinsics_prior(prior))
    return jm.match_images(), tm.match_images(), tm


def test_correspondences_identical_without_verification(scene):
    jout, tout, _ = _run_both(scene, verify=False)
    assert len(jout) == len(tout) == 6
    for j, t in zip(jout, tout):
        assert (t.image1, t.image2) == (j.image1, j.image2)
        np.testing.assert_array_equal(t.correspondences1, j.correspondences1)
        np.testing.assert_array_equal(t.correspondences2, j.correspondences2)
        assert t.twoview_info.num_verified_matches == j.twoview_info.num_verified_matches


def test_verified_pairs_and_rotations_match_jax(scene):
    before = sm.streaming_top2.launches
    jout, tout, tm = _run_both(scene, verify=True)
    assert sm.streaming_top2.launches == before  # CPU tensors: plain path
    assert [(m.image1, m.image2) for m in tout] == [(m.image1, m.image2) for m in jout]
    assert len(tout) >= 4
    for j, t in zip(jout, tout):
        angle = _rotation_angle(t.twoview_info.rotation_2, j.twoview_info.rotation_2)
        assert angle < 2e-3, angle
        assert len(t.correspondences1) == t.twoview_info.num_verified_matches >= 20
        assert abs(t.twoview_info.num_verified_matches
                   - j.twoview_info.num_verified_matches) <= 0.02 * len(j.correspondences1)
        # The port's records convert like the JAX package's.
        assert convert.image_pair_match(t).twoview_info.visibility_score == (
            t.twoview_info.visibility_score)
    assert tm.database.num_matches() == len(tout)


def _rotation_angle(a, b):
    Ra = angle_axis_to_rotation_matrix_np(a)
    Rb = angle_axis_to_rotation_matrix_np(b)
    return np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))


@pytest.mark.parametrize("guided", [False, True])
def test_default_options_match_jax(scene, guided):
    """`match_images` at default options (stage 2 on), guided rematch off and
    on, against the JAX package."""
    jopt = JOptions()
    jopt.geometric_verification_options.guided_matching = guided
    topt = FeatureMatcherOptions()
    topt.geometric_verification_options.guided_matching = guided
    assert topt.geometric_verification_options.bundle_adjustment
    jm = JMatcher(jopt)
    tm = FeatureMatcher(topt, device="cpu")
    for name, kps, descs, prior in scene:
        jm.add_image(name, kps, descs, prior)
        tm.add_image(name, kps, descs, convert.camera_intrinsics_prior(prior))
    jout, tout = jm.match_images(), tm.match_images()
    assert [(m.image1, m.image2) for m in tout] == [(m.image1, m.image2) for m in jout]
    assert len(tout) >= 4
    assert 0 < tm.timings["refinement"] <= tm.timings["verification"]
    for j, t in zip(jout, tout):
        assert _rotation_angle(t.twoview_info.rotation_2, j.twoview_info.rotation_2) < 2e-4
        assert np.dot(t.twoview_info.position_2, j.twoview_info.position_2) > 1 - 1e-6
        nj, nt = j.twoview_info.num_verified_matches, t.twoview_info.num_verified_matches
        assert abs(nt - nj) <= 0.02 * nj
        assert len(t.correspondences1) == nt >= topt.min_num_feature_matches


def test_uncalibrated_pair_raises(scene):
    m = FeatureMatcher(convert.feature_matcher_options(_options(True)), device="cpu")
    for name, kps, descs, prior in scene:
        m.add_image(name, kps, descs, CameraIntrinsicsPrior(
            image_width=prior.image_width, image_height=prior.image_height))
    with pytest.raises(NotImplementedError, match="focal-length prior"):
        m.match_images()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert FeatureMatcher().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            FeatureMatcher()
