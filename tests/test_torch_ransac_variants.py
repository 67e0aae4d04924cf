"""The rest of the port's RANSAC engine (PROSAC, LMed, LO-RANSAC, SPRT) and
the estimators that come with it, against the JAX package's on the CPU.

The two packages draw different random samples (`jax.random` against a
`torch.Generator`), so exact parity is tested on the JAX package's own draws
(`engine._draw_samples`, and the SPRT subset as its engine draws it): the
best model to 1e-6 in f64 and the inlier mask exactly, with LO the same
number of LO rounds. PROSAC's prefix bound is compared hypothesis for
hypothesis. With the port's own generator each estimator is held to the
recovery bars of `tests/test_ransac.py` on that file's scenes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.math import sprt as jsprt
from pytheiasfm_tpu.models import camera as jcam
from pytheiasfm_tpu.ransac import engine as jeng
from pytheiasfm_tpu.ransac import estimators as jest
from pytheiasfm_tpu_torch.math import sprt as tsprt
from pytheiasfm_tpu_torch.ransac import engine as teng
from pytheiasfm_tpu_torch.ransac import estimators as test_
from test_ransac import make_two_view_scene
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

MODEL_TOL = 1e-6


def _t(x):
    return torch.tensor(np.asarray(x))


def _params(**kw):
    return jeng.RansacParameters(**kw), teng.RansacParameters(**kw)


def _jax_draws(key, params, sample_size, mask, n):
    idx = jeng._draw_samples(key, n, params, sample_size,
                             None if mask is None else jnp.asarray(mask))
    sub = None
    if params.use_Tdd_test:
        # As `engine.ransac` draws the SPRT subset.
        n1 = min(n, max(params.sprt_subset_size, 4 * sample_size))
        _, k_sub = jax.random.split(key)
        g = jax.random.gumbel(k_sub, (n,))
        if mask is not None:
            g = jnp.where(jnp.asarray(mask), g, -jnp.inf)
        sub = _t(jax.lax.top_k(g, n1)[1])[None]
    return _t(idx)[None], sub


def _angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


# --------------------------------------------------------------------- SPRT


def test_sprt_matches_jax(rng):
    for sigma, eps, ratio in ((0.05, 0.1, 200.0), (0.05, 0.3, 100.0), (0.1, 0.4, 1000.0)):
        a_t = tsprt.calculate_sprt_decision_threshold(sigma, eps, ratio)
        a_j = float(jsprt.calculate_sprt_decision_threshold(sigma, eps, ratio))
        assert abs(a_t - a_j) <= 1e-12 * a_j
    flags = rng.uniform(size=(64, 48)) < np.linspace(0.02, 0.6, 64)[:, None]
    A = tsprt.calculate_sprt_decision_threshold(0.05, 0.1)
    pt, ot = tsprt.sequential_probability_ratio_test(_t(flags), 0.05, 0.1, A)
    pj, oj = jsprt.sequential_probability_ratio_test(jnp.asarray(flags), 0.05, 0.1, A)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-12)
    assert pt.any() and not pt.all()


# ----------------------------------------------- the engine on JAX's draws


def _relative_pose_both(p1, p2, mask, R, quality, seed=3, error_thresh=1e-6, max_angle=1e-2,
                        **kw):
    jp, tp = _params(error_thresh=error_thresh, max_iterations=64, **kw)
    key = jax.random.PRNGKey(seed)
    idx, sub = _jax_draws(key, jp, 5, mask, len(p1))
    jm, js = jax.jit(lambda k, a, b, m: jest.estimate_relative_pose(
        k, a, b, jp, mask=m, quality=quality))(
        key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))
    data = test_.TwoViewData(_t(p1)[None], _t(p2)[None])
    tm, ts = teng.score_samples(idx, data, test_.RELATIVE_POSE_ESTIMATOR, tp,
                                mask=_t(mask)[None], quality=quality, subset_idx=sub)
    np.testing.assert_allclose(tm.rotation[0].numpy(), np.asarray(jm.rotation), atol=MODEL_TOL)
    np.testing.assert_allclose(tm.position[0].numpy(), np.asarray(jm.position), atol=MODEL_TOL)
    Et, Ej = tm.essential_matrix[0].numpy(), np.asarray(jm.essential_matrix)
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < MODEL_TOL
    np.testing.assert_array_equal(ts.inliers[0].numpy(), np.asarray(js.inliers))
    assert int(ts.num_inliers[0]) == int(js.num_inliers)
    assert ts.num_lo_iterations == js.num_lo_iterations
    np.testing.assert_allclose(float(ts.best_cost[0]), float(js.best_cost), rtol=1e-8,
                               atol=1e-14)
    assert _angle(tm.rotation[0].numpy(), R) < max_angle
    return ts


def _padded_scene(rng, n_in, n_out, n_pad, noise):
    p1, p2, R, t, _, _ = make_two_view_scene(rng, n_in, n_out, noise)
    pad = np.zeros((n_pad, 2))
    mask = np.arange(n_in + n_out + n_pad) < n_in + n_out
    return np.concatenate([p1, pad]), np.concatenate([p2, pad]), mask, R


@pytest.mark.parametrize("quality", ["inlier", "mle", "lmed"])
def test_engine_quality_matches_jax_on_jax_draws(rng, quality):
    """LMed on an even count of valid rows: the median is the mean of the
    two middle residuals there (`jnp.nanmedian`), not the lower one."""
    p1, p2, mask, R = _padded_scene(rng, 70, 30, 8, 1e-4)
    assert mask.sum() % 2 == 0
    _relative_pose_both(p1, p2, mask, R, quality)


@pytest.mark.parametrize("quality", ["inlier", "mle"])
def test_engine_lo_matches_jax_on_jax_draws(rng, quality):
    p1, p2, mask, R = _padded_scene(rng, 70, 30, 8, 1e-3)
    # The threshold and the ground-truth bar (2 deg) of
    # `tests/test_ransac.py::test_estimate_relative_pose_with_noise_and_lo`.
    ts = _relative_pose_both(p1, p2, mask, R, quality, error_thresh=(3e-3) ** 2,
                             max_angle=np.radians(2.0), use_lo=True, lo_iterations=3)
    assert ts.num_lo_iterations == 3


@pytest.mark.parametrize("quality", ["inlier", "lmed"])
def test_engine_sprt_matches_jax_on_jax_draws(rng, quality):
    p1, p2, mask, R = _padded_scene(rng, 120, 80, 8, 1e-4)
    _relative_pose_both(p1, p2, mask, R, quality, use_Tdd_test=True, sprt_subset_size=48,
                        sprt_keep_fraction=0.2)


def test_prosac_prefix_matches_jax(monkeypatch):
    """The prefix each hypothesis draws from, read off the JAX sampler by
    recording the keys it hands to `lax.top_k` (with the Gumbel noise at 0,
    the allowed rows are the finite keys)."""
    seen = []
    orig_top_k = jax.lax.top_k

    def top_k(g, k):
        seen.append(np.asarray(g))
        return orig_top_k(g, k)

    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape: jnp.zeros(shape))
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    for B, N, S in ((128, 120, 5), (1000, 37, 8), (64, 500, 3)):
        params = jeng.RansacParameters(max_iterations=B, sampler="prosac")
        seen.clear()
        jeng._draw_samples(jax.random.PRNGKey(0), N, params, S)
        n_jax = np.isfinite(seen[0]).sum(-1)
        n_port = teng.prosac_prefix(B, torch.tensor([N]), S)[0].numpy()
        np.testing.assert_array_equal(n_port, n_jax)
    monkeypatch.undo()
    # The port's draws stay inside each hypothesis's prefix, valid rows only.
    mask = torch.ones(2, 120, dtype=torch.bool)
    mask[1, 100:] = False
    idx = teng._draw_samples(torch.Generator().manual_seed(0), mask, 128, 5, "prosac",
                             num_data=torch.tensor([120, 100]))
    bound = teng.prosac_prefix(128, torch.tensor([120, 100]), 5)
    assert (idx < bound[..., None]).all()
    assert all(len(set(s.tolist())) == 5 for s in idx.reshape(-1, 5))


def test_lmed_cost_is_jax_median():
    res = torch.tensor([[3.0, 1.0, 2.0, 10.0, 7.0, float("nan")]], dtype=torch.float64)
    mask = torch.tensor([[True, True, True, True, False, True]])
    got = teng._lmed_cost(torch.where(mask, res, torch.inf), mask)
    want = jnp.nanmedian(jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(res.numpy()),
                                   jnp.nan), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(teng._lmed_cost(res[:, :4]).numpy(),
                               np.asarray(jnp.median(jnp.asarray(res.numpy()[:, :4]), -1)))


# ------------------------------------------- estimators on JAX's draws


def _both_estimators(jfn, estimator, data_type, data_np, params_kw, quality, sample_size, key,
                     mask=None):
    jp, tp = _params(**params_kw)
    n = len(data_np[0])
    idx, sub = _jax_draws(key, jp, sample_size, mask, n)
    jm, js = jax.jit(lambda k, *a: jfn(k, *a, jp, quality=quality))(
        key, *(jnp.asarray(a) for a in data_np))
    data = data_type(*(_t(a)[None] for a in data_np))
    tm, ts = teng.score_samples(idx, data, estimator, tp, quality=quality,
                                subset_idx=sub)
    np.testing.assert_array_equal(ts.inliers[0].numpy(), np.asarray(js.inliers))
    assert ts.num_lo_iterations == js.num_lo_iterations
    return jm, js, tm, ts


def _abs_pose_scene(rng, n_in=50, n_out=30):
    """`tests/test_ransac.py::test_estimate_calibrated_absolute_pose`'s scene."""
    from pytheiasfm_tpu.ops import rotation as jrot

    aa = rng.normal(size=3) * 0.4
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    c = rng.normal(size=3)
    world = rng.uniform(-3, 3, size=(n_in, 3))
    p_cam = (world - c) @ R.T
    p_cam[:, 2] = np.abs(p_cam[:, 2]) + 2.0
    world = p_cam @ R + c
    feat = p_cam[:, :2] / p_cam[:, 2:3]
    features = np.concatenate([feat, rng.uniform(-1, 1, size=(n_out, 2))])
    world_all = np.concatenate([world, rng.uniform(-3, 3, size=(n_out, 3)) + [0, 0, 10.0]])
    return features, world_all, R, c


def _triangulation_scene(rng):
    """`tests/test_ransac.py::test_estimate_triangulation`'s scene."""
    n_views = 8
    aa = 0.15 * rng.normal(size=(n_views, 3))
    pos = rng.normal(size=(n_views, 3)) * 2.0
    pos[:, 2] -= 8.0
    ext = jcam.make_extrinsics(jnp.asarray(pos), jnp.asarray(aa))
    poses = np.asarray(jcam.compose_projection_matrix(ext))
    point = np.asarray([0.3, -0.2, 0.5])
    obs = np.stack([(poses[v] @ np.append(point, 1.0))[:2] / (poses[v] @ np.append(point, 1.0))[2]
                    for v in range(n_views)])
    obs[5] += 0.05
    obs[6] -= 0.03
    return poses, obs, point


@pytest.mark.parametrize("kind", ["essential", "fundamental", "homography"])
def test_two_view_estimators_match_jax_on_jax_draws(rng, kind):
    p1, p2, R, t, E, n_in = make_two_view_scene(rng, noise=1e-4)
    if kind == "homography":
        H = np.eye(3) + 0.15 * rng.normal(size=(3, 3))
        x2 = np.concatenate([p1, np.ones((len(p1), 1))], -1) @ H.T
        p2 = np.where(np.arange(len(p1))[:, None] < n_in, x2[:, :2] / x2[:, 2:3], p2)
    jfn, est, size, field = {
        "essential": (jest.estimate_essential_matrix, test_.ESSENTIAL_ESTIMATOR, 5,
                      "essential_matrix"),
        "fundamental": (jest.estimate_fundamental_matrix, test_.FUNDAMENTAL_ESTIMATOR, 7,
                        "fundamental_matrix"),
        "homography": (jest.estimate_homography, test_.HOMOGRAPHY_ESTIMATOR, 4, "homography"),
    }[kind]
    jm, js, tm, ts = _both_estimators(
        jfn, est, test_.TwoViewData, (p1, p2),
        dict(error_thresh=1e-6, max_iterations=64, use_lo=True), "mle", size,
        jax.random.PRNGKey(11))
    Mt, Mj = getattr(tm, field)[0].numpy(), np.asarray(jm)
    if kind == "homography":
        np.testing.assert_allclose(Mt, Mj, atol=MODEL_TOL)
    else:
        Mt, Mj = Mt / np.linalg.norm(Mt), Mj / np.linalg.norm(Mj)
        assert min(np.abs(Mt - Mj).max(), np.abs(Mt + Mj).max()) < MODEL_TOL
    assert int(ts.num_inliers[0]) >= 0.9 * n_in


def test_absolute_pose_matches_jax_on_jax_draws(rng):
    feat, world, R, c = _abs_pose_scene(rng)
    jm, js, tm, ts = _both_estimators(
        jest.estimate_calibrated_absolute_pose, test_.ABSOLUTE_POSE_ESTIMATOR, test_.Corr2D3D,
        (feat, world), dict(error_thresh=1e-8, max_iterations=64, use_lo=True), "inlier", 3,
        jax.random.PRNGKey(4))
    np.testing.assert_allclose(tm.rotation[0].numpy(), np.asarray(jm.rotation), atol=MODEL_TOL)
    np.testing.assert_allclose(tm.position[0].numpy(), np.asarray(jm.position), atol=MODEL_TOL)
    np.testing.assert_allclose(tm.rotation[0].numpy(), R, atol=1e-4)


def test_uncalibrated_relative_pose_matches_jax_on_jax_draws(rng):
    p1, p2, R, t, E, n_in = make_two_view_scene(rng, noise=1e-4)
    p1, p2 = p1 * 900.0, p2 * 900.0  # pixels about the principal point
    jm, js, tm, ts = _both_estimators(
        jest.estimate_uncalibrated_relative_pose, test_.UNCALIBRATED_RELATIVE_POSE_ESTIMATOR,
        test_.TwoViewData, (p1, p2), dict(error_thresh=1.0, max_iterations=64), "mle", 8,
        jax.random.PRNGKey(9))
    Ft, Fj = tm.fundamental_matrix[0].numpy(), np.asarray(jm.fundamental_matrix)
    assert min(np.abs(Ft - Fj).max(), np.abs(Ft + Fj).max()) < MODEL_TOL
    for a, b in ((tm.focal_length1, jm.focal_length1), (tm.focal_length2, jm.focal_length2)):
        np.testing.assert_allclose(float(a[0]), float(b), rtol=MODEL_TOL)
    np.testing.assert_allclose(tm.rotation[0].numpy(), np.asarray(jm.rotation), atol=MODEL_TOL)
    np.testing.assert_allclose(tm.position[0].numpy(), np.asarray(jm.position), atol=MODEL_TOL)
    assert int(ts.num_inliers[0]) >= 0.9 * n_in


def test_triangulation_matches_jax_on_jax_draws(rng):
    poses, obs, point = _triangulation_scene(rng)
    jm, js, tm, ts = _both_estimators(
        jest.estimate_triangulation, test_.TRIANGULATION_ESTIMATOR, test_.TriangulationData,
        (poses, obs), dict(error_thresh=1e-8, max_iterations=64, use_lo=True), "inlier", 2,
        jax.random.PRNGKey(5))
    pt, pj = tm.point[0].numpy(), np.asarray(jm)
    np.testing.assert_allclose(pt[:3] / pt[3], pj[:3] / pj[3], atol=MODEL_TOL)
    np.testing.assert_allclose(pt[:3] / pt[3], point, atol=1e-6)


# ------------------------------------- the port's own generator, JAX bars


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_relative_pose_lo_prosac_lmed_sprt_with_own_generator(rng):
    """`tests/test_ransac.py`'s LO, PROSAC, LMed and SPRT cases, each on its
    own scene, at that file's bars."""
    p1, p2, R, t, E, n_in = make_two_view_scene(rng, noise=1e-3)
    _, s = test_.estimate_relative_pose(
        _gen(1), _t(p1)[None], _t(p2)[None],
        teng.RansacParameters(error_thresh=(3e-3) ** 2, max_iterations=256, use_lo=True))
    assert int(s.num_inliers[0]) >= n_in * 0.85 and s.num_lo_iterations == 2

    p1, p2, R, t, E, n_in = make_two_view_scene(rng, n_inliers=60, n_outliers=60)
    _, s = test_.estimate_relative_pose(
        _gen(6), _t(p1)[None], _t(p2)[None],
        teng.RansacParameters(error_thresh=1e-6, max_iterations=128, sampler="prosac"))
    assert int(s.num_inliers[0]) >= n_in * 0.9

    p1, p2, R, t, E, n_in = make_two_view_scene(rng, n_inliers=90, n_outliers=30)
    m, _ = test_.estimate_relative_pose(
        _gen(7), _t(p1)[None], _t(p2)[None],
        teng.RansacParameters(error_thresh=1e-6, max_iterations=256), quality="lmed")
    assert np.abs(m.rotation[0].numpy() - R).max() < 1e-3

    p1, p2, R, t, E, n_in = make_two_view_scene(rng, n_inliers=120, n_outliers=80)
    params = teng.RansacParameters(error_thresh=1e-6, max_iterations=256, use_Tdd_test=True,
                                   sprt_subset_size=48, sprt_keep_fraction=0.2)
    m, s = test_.estimate_relative_pose(_gen(1), _t(p1)[None], _t(p2)[None], params)
    assert int(s.num_inliers[0]) >= n_in * 0.9
    assert np.abs(m.rotation[0].numpy() - R).max() < 5e-3
    base, bs = test_.estimate_relative_pose(
        _gen(1), _t(p1)[None], _t(p2)[None], dataclasses.replace(params, use_Tdd_test=False))
    assert int(bs.num_inliers[0]) == int(s.num_inliers[0])


def test_other_estimators_with_own_generator(rng):
    """`tests/test_ransac.py`'s fundamental-matrix, homography (LO),
    absolute-pose (LO) and triangulation (LO) cases at that file's bars."""
    p1, p2, R, t, E, n_in = make_two_view_scene(rng)
    F, s = test_.estimate_fundamental_matrix(
        _gen(2), _t(p1)[None], _t(p2)[None],
        teng.RansacParameters(error_thresh=1e-6, max_iterations=256))
    F = F.fundamental_matrix[0].numpy()
    F /= np.linalg.norm(F)
    assert min(np.abs(F - E).max(), np.abs(F + E).max()) < 1e-3
    assert int(s.num_inliers[0]) >= n_in * 0.9

    H_gt = np.eye(3) + 0.15 * rng.normal(size=(3, 3))
    H_gt /= H_gt[2, 2]
    x1 = rng.uniform(-1, 1, size=(60, 2))
    h2 = np.concatenate([x1, np.ones((60, 1))], -1) @ H_gt.T
    q1 = np.concatenate([x1, rng.uniform(-1, 1, size=(30, 2))])
    q2 = np.concatenate([h2[:, :2] / h2[:, 2:3], rng.uniform(-1, 1, size=(30, 2))])
    H, s = test_.estimate_homography(
        _gen(3), _t(q1)[None], _t(q2)[None],
        teng.RansacParameters(error_thresh=1e-8, max_iterations=256, use_lo=True))
    np.testing.assert_allclose(H.homography[0].numpy(), H_gt, atol=1e-5)
    assert int(s.num_inliers[0]) >= 60 * 0.95

    feat, world, R, c = _abs_pose_scene(rng)
    m, s = test_.estimate_calibrated_absolute_pose(
        _gen(4), _t(feat)[None], _t(world)[None],
        teng.RansacParameters(error_thresh=1e-8, max_iterations=256, use_lo=True))
    assert int(s.num_inliers[0]) >= 50 * 0.9
    np.testing.assert_allclose(m.rotation[0].numpy(), R, atol=1e-4)
    np.testing.assert_allclose(m.position[0].numpy(), c, atol=1e-4)

    poses, obs, point = _triangulation_scene(rng)
    pt, s = test_.estimate_triangulation(
        _gen(5), _t(poses)[None], _t(obs)[None],
        teng.RansacParameters(error_thresh=1e-8, max_iterations=64, use_lo=True))
    pt = pt.point[0].numpy()
    np.testing.assert_allclose(pt[:3] / pt[3], point, atol=1e-6)
    inl = s.inliers[0].numpy()
    assert inl[:5].all() and inl[7] and not inl[5] and not inl[6]


@pytest.mark.parametrize("name,item", [
    ("estimate_uncalibrated_absolute_pose", "E1"),
    ("estimate_radial_dist_uncalibrated_absolute_pose", "E1"),
    ("estimate_similarity_transformation_2d_3d", "E1"),
    ("estimate_rigid_transformation_2d_3d", "E1"),
    ("estimate_dominant_plane_from_points", "E1"),
    ("estimate_radial_distortion_homography", "E1"),
])
def test_unported_estimators_name_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        getattr(test_, name)(None)
