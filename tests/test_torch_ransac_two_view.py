"""The port's RANSAC engine and calibrated two-view verification against the
JAX package's.

The two packages draw different random samples (`jax.random` against a
`torch.Generator`), so exact parity is tested by feeding the JAX package's
own sample indices to the port's scorer: the best model then agrees to
1e-6 in f64 and the inlier mask exactly. With each package's own samples
the results are held to ground truth and to each other at the bars of
the slice: the same pairs verify, inlier counts within 2%, rotations
within 2e-3 rad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ransac import engine as jeng
from pytheiasfm_tpu.ransac import estimators as jest
from pytheiasfm_tpu.sfm import two_view as jtv
from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JPrior
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ops.rotation import angle_axis_to_rotation_matrix
from pytheiasfm_tpu_torch.ransac import engine as teng
from pytheiasfm_tpu_torch.ransac import estimators as test_
from pytheiasfm_tpu_torch.sfm import two_view as ttv
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


def _rotation(aa):
    return angle_axis_to_rotation_matrix(torch.tensor(aa, dtype=torch.float64)).numpy()


def _scene(rng, n_inliers=70, n_outliers=30, noise=0.0, n_pad=0):
    """Normalized correspondences, outliers after the inliers, then
    `n_pad` masked padding rows."""
    R = _rotation(rng.normal(size=3) * 0.3)
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    pts = rng.uniform(-1, 1, size=(n_inliers, 3)) + [0, 0, 4.0]
    x1 = pts[:, :2] / pts[:, 2:3]
    p2 = pts @ R.T + t
    x2 = p2[:, :2] / p2[:, 2:3]
    x1 = x1 + rng.normal(size=x1.shape) * noise
    x2 = x2 + rng.normal(size=x2.shape) * noise
    p1 = np.concatenate([x1, rng.uniform(-1, 1, (n_outliers, 2)), np.zeros((n_pad, 2))])
    p2 = np.concatenate([x2, rng.uniform(-1, 1, (n_outliers, 2)), np.zeros((n_pad, 2))])
    mask = np.arange(len(p1)) < n_inliers + n_outliers
    return p1, p2, mask, R, t


def _angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


@pytest.mark.parametrize("quality", ["mle", "inlier"])
def test_scorer_matches_jax_on_jax_samples(rng, quality):
    p1, p2, mask, R, _ = _scene(rng, noise=1e-4, n_pad=8)
    params = jeng.RansacParameters(error_thresh=1e-6, max_iterations=64)
    key = jax.random.PRNGKey(3)
    idx = jeng._draw_samples(key, len(p1), params, 5, jnp.asarray(mask))
    jm, js = jax.jit(
        lambda k, a, b, m: jest.estimate_relative_pose(
            k, a, b, params, mask=m, quality=quality
        )
    )(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))

    tparams = teng.RansacParameters(error_thresh=1e-6, max_iterations=64)
    data = test_.TwoViewData(torch.tensor(p1)[None], torch.tensor(p2)[None])
    tm, ts = teng.score_samples(
        torch.tensor(np.asarray(idx))[None], data, test_.RELATIVE_POSE_ESTIMATOR,
        tparams, mask=torch.tensor(mask)[None], quality=quality,
    )
    np.testing.assert_allclose(tm.rotation[0].numpy(), np.asarray(jm.rotation), atol=1e-6)
    np.testing.assert_allclose(tm.position[0].numpy(), np.asarray(jm.position), atol=1e-6)
    Et, Ej = tm.essential_matrix[0].numpy(), np.asarray(jm.essential_matrix)
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < 1e-6
    np.testing.assert_array_equal(ts.inliers[0].numpy(), np.asarray(js.inliers))
    assert int(ts.num_inliers[0]) == int(js.num_inliers)
    assert int(ts.num_iterations[0]) == int(js.num_iterations)
    np.testing.assert_allclose(float(ts.best_cost[0]), float(js.best_cost), rtol=1e-8)
    assert _angle(tm.rotation[0].numpy(), R) < 1e-2


def test_ransac_with_its_own_generator(rng):
    scenes = [_scene(rng) for _ in range(3)]
    p1 = torch.tensor(np.stack([s[0] for s in scenes]))
    p2 = torch.tensor(np.stack([s[1] for s in scenes]))
    params = teng.RansacParameters(error_thresh=1e-6, max_iterations=128)
    gen = torch.Generator().manual_seed(0)
    model, summary = test_.estimate_relative_pose(gen, p1, p2, params, quality="mle")
    for i, (_, _, _, R, t) in enumerate(scenes):
        assert _angle(model.rotation[i].numpy(), R) < 1e-3
        inl = summary.inliers[i].numpy()
        assert inl[:70].all() and inl[70:].mean() < 0.2
    sample = teng._draw_samples(gen, torch.ones(2, 9, dtype=torch.bool), 50, 5)
    assert all(len(set(s.tolist())) == 5 for s in sample.reshape(-1, 5))


FOCAL, W, H = 800.0, 1024, 768


def _pixel_pair(rng, n_in, n_out, K, angle, noise=0.02):
    """One calibrated pair in pixels, padded to K rows. The pixel noise is
    small: without the refinement of stage 2, the best minimal model of
    RANSAC is off by ~20x the noise in angle, and the two packages draw
    different samples."""
    R = _rotation(np.array([0.02, angle, -0.01]))
    c2 = np.array([1.0, 0.1, 0.05])
    pts = rng.uniform([-2, -1.5, 5], [2, 1.5, 9], size=(n_in, 3))

    def project(X, R, c):
        Xc = (X - c) @ R.T
        return Xc[:, :2] / Xc[:, 2:3] * FOCAL + [W / 2, H / 2]

    uv1 = project(pts, np.eye(3), np.zeros(3)) + rng.normal(size=(n_in, 2)) * noise
    uv2 = project(pts, R, c2) + rng.normal(size=(n_in, 2)) * noise
    out1 = rng.uniform([0, 0], [W, H], (n_out, 2))
    out2 = rng.uniform([0, 0], [W, H], (n_out, 2))
    p1 = np.zeros((K, 2))
    p2 = np.zeros((K, 2))
    p1[: n_in + n_out] = np.concatenate([uv1, out1])
    p2[: n_in + n_out] = np.concatenate([uv2, out2])
    return p1, p2, np.arange(K) < n_in + n_out, R


def test_estimate_two_view_info_batch_matches_jax(rng):
    K = 256
    pairs = [
        _pixel_pair(rng, 150, 40, K, 0.1),
        _pixel_pair(rng, 0, 120, K, 0.0),  # no geometry: must not verify
        _pixel_pair(rng, 200, 30, K, -0.15),
    ]
    p1 = np.stack([p[0] for p in pairs])
    p2 = np.stack([p[1] for p in pairs])
    masks = np.stack([p[2] for p in pairs])
    jprior = JPrior(image_width=W, image_height=H, focal_length=FOCAL)
    jopt = jtv.EstimateTwoViewInfoOptions(max_ransac_iterations=200)
    jres = jtv.estimate_two_view_info_batch(
        jax.random.PRNGKey(0), jopt, [jprior] * 3, [jprior] * 3, p1, p2, masks,
        min_num_inlier_matches=30,
    )
    tprior = convert.camera_intrinsics_prior(jprior)
    topt = ttv.EstimateTwoViewInfoOptions(max_ransac_iterations=200)
    tres = ttv.estimate_two_view_info_batch(
        torch.Generator().manual_seed(0), topt, [tprior] * 3, [tprior] * 3,
        p1, p2, masks, min_num_inlier_matches=30,
    )
    assert [r[0] is None for r in tres] == [r[0] is None for r in jres] == [
        False, True, False]
    for (ti, tidx), (ji, jidx), pair in zip(tres, jres, pairs):
        if ji is None:
            continue
        n_t, n_j = ti.num_verified_matches, ji.num_verified_matches
        assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
        assert _angle(_rotation(ti.rotation_2), _rotation(ji.rotation_2)) < 2e-3
        assert _angle(_rotation(ti.rotation_2), pair[3]) < 2e-3
        assert ti.focal_length_1 == ji.focal_length_1 == FOCAL
        if np.array_equal(tidx, jidx):
            assert ti.visibility_score == ji.visibility_score
