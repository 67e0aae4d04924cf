"""Localization in the port against the JAX package on the CPU: the
known-rotation solvers (`ops/known_rotation.py`), SQPnP and the DLS shim
(`ops/pnp.py`), the three estimators they feed (`ransac/estimators.py`:
the typed calibrated absolute pose, the known-orientation absolute and
relative positions) and `sfm/localize.py`.

Bars. The solvers take the same numpy inputs in both packages (f64): the
two-ray position, the relative position (up to its sign: an SVD null
vector) and SQPnP / DLS on 6 or more points to 1e-8. On exact data SQPnP's
9x9 Omega has a null space of max(1, 12 - 2N) dimensions, so below 6
points its seed is whichever null vector the eigen-solver returns (LAPACK
through torch and through XLA return different ones): on 400 exact 3-, 4-
and 5-point problems its recovery rate (position error < 1e-3) is held
within 0.10 of the JAX function's. The known-orientation estimators run on the JAX
package's own draws (the engine's split, `score_samples`): model 1e-6,
inliers exact. The typed estimator with SQPNP or DLS depends on the basis
(above), so it is held with the port's own generator: every point an inlier
on clean data, as in the JAX package, and the pose recovered with 30%
outliers. Localization (`localize_view_to_reconstruction` in both branches
and each PnP type, and the batch) runs on the 7-view scenes of
`tests/test_incremental_estimator.py` (seed 5) and
`tests/test_hybrid_and_builder.py` (seed 9), every other view and every
track at ground truth: each localized pose within 1.25x the JAX package's
error against ground truth plus 1e-4 where BA polishes it; where nothing
does (the known-orientation branch, the batch), the best minimal
hypothesis's error depends on the draws, so the medians over 32 (one
view) or 12 (a batch of 3-4 views) keys / generator seeds are held so, and
the inputs that reach the RANSAC call (features, points, thresholds) are
held equal to the JAX package's to 1e-12 (relative, and absolute near 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import known_rotation as jkr
from pytheiasfm_tpu.ops import pnp as jpnp
from pytheiasfm_tpu.ransac import estimators as jest
from pytheiasfm_tpu.sfm import localize as jloc
from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ops import known_rotation as tkr
from pytheiasfm_tpu_torch.ops import pnp as tpnp
from pytheiasfm_tpu_torch.ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from pytheiasfm_tpu_torch.ransac import engine as teng
from pytheiasfm_tpu_torch.ransac import estimators as test_
from pytheiasfm_tpu_torch.sfm import localize as tloc
from test_pnp import make_pnp_scene
from test_torch_ransac_variants import MODEL_TOL, _abs_pose_scene, _both_estimators
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

SOLVER_TOL = 1e-8
RECOVERY_RATE_TOL = 0.10
POSE_RATIO = 1.25
POSE_SLACK = 1e-4
# Keys / generator seeds where no BA polishes the best hypothesis (the
# known-orientation branch; the batch, a few views a call).
DRAWS = {"known orientation": 32, "batch": 12}


def _t(x):
    return torch.tensor(np.asarray(x))


def _rotated(features, R):
    """World-aligned features: R^T [u, v, 1], dehomogenized."""
    rays = np.concatenate([features, np.ones(features.shape[:-1] + (1,))], -1) @ R
    return rays[..., :2] / rays[..., 2:3]


# ------------------------------------------------------------------ solvers


def test_position_from_two_rays_matches_jax(rng):
    B = 64
    c = rng.normal(size=(B, 3))
    X = rng.uniform(-2, 2, size=(B, 2, 3)) + [0, 0, 6.0] + c[:, None]
    d = X - c[:, None]
    f = d[..., :2] / d[..., 2:3]
    X[:3, 1] = X[:3, 0]  # the same point twice: rank 2
    f[:3, 1] = f[:3, 0]
    pj, vj = jax.vmap(jkr.position_from_two_rays)(*(jnp.asarray(a) for a in (
        f[:, 0], X[:, 0], f[:, 1], X[:, 1])))
    pt, vt = tkr.position_from_two_rays(_t(f[:, 0]), _t(X[:, 0]), _t(f[:, 1]), _t(X[:, 1]))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[:3].any() and vt[3:].all()
    np.testing.assert_allclose(pt[3:].numpy(), np.asarray(pj)[3:], atol=SOLVER_TOL)
    np.testing.assert_allclose(pt[3:].numpy(), c[3:], atol=SOLVER_TOL)


def test_relative_pose_from_two_points_with_known_rotation_matches_jax(rng):
    B = 64
    t = rng.normal(size=(B, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    X = rng.uniform(-2, 2, size=(B, 2, 3)) + [0, 0, 8.0]
    p = X[..., :2] / X[..., 2:3]
    d = X - t[:, None]
    q = d[..., :2] / d[..., 2:3]
    q[:2] = p[:2]  # no baseline: the two constraints coincide
    tj, vj = jax.vmap(jkr.relative_pose_from_two_points_with_known_rotation)(
        jnp.asarray(p), jnp.asarray(q))
    tt, vt = tkr.relative_pose_from_two_points_with_known_rotation(_t(p), _t(q))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt[2:].all()
    tt, tj = tt.numpy()[2:], np.asarray(tj)[2:]
    sign = np.sign(np.sum(tt * tj, axis=-1, keepdims=True))
    np.testing.assert_allclose(tt * sign, tj, atol=SOLVER_TOL)
    np.testing.assert_allclose(np.abs(np.sum(tt * t[2:], axis=-1)), 1.0, atol=SOLVER_TOL)


@pytest.mark.parametrize("N,noise", [(6, 0.0), (8, 0.0), (10, 1e-3), (20, 1e-3)])
def test_sqpnp_matches_jax(rng, N, noise):
    feat, world, R, c = make_pnp_scene(rng, B=16, N=N, noise=noise)
    mask = np.ones(feat.shape[:2], bool)
    if N >= 10:
        mask[:, -2:] = False
        world = world.copy()
        world[:, -2:] = rng.normal(size=(16, 2, 3))
    Rj, cj, okj = jpnp.sqpnp(jnp.asarray(feat), jnp.asarray(world), mask=jnp.asarray(mask))
    Rt, ct, okt = tpnp.sqpnp(_t(feat), _t(world), mask=_t(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=SOLVER_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=SOLVER_TOL)
    if noise == 0.0:
        np.testing.assert_allclose(Rt.numpy(), R, atol=1e-9)
        np.testing.assert_allclose(ct.numpy(), c, atol=1e-8)


def test_dls_pnp_matches_jax(rng):
    feat, world, R, c = make_pnp_scene(rng, B=4, N=8)
    Rj, cj, vj = jpnp.dls_pnp(jnp.asarray(feat), jnp.asarray(world))
    Rt, ct, vt = tpnp.dls_pnp(_t(feat), _t(world))
    assert Rt.shape == (4, 1, 3, 3) and ct.shape == (4, 1, 3) and vt.shape == (4, 1)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=SOLVER_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=SOLVER_TOL)
    np.testing.assert_allclose(Rt[:, 0].numpy(), R, atol=1e-9)


@pytest.mark.parametrize("N,low,high", [(3, 0.2, 0.6), (4, 0.4, 0.8), (5, 0.6, 0.95)])
def test_sqpnp_few_point_recovery_rate(N, low, high):
    """400 exact N-point problems (f64, numpy seed 1): the share whose
    position comes back within 1e-3, in both packages. Omega's null space
    has max(1, 12 - 2N) dimensions on exact data, so below 6 points the
    seed is the eigen-solver's choice."""
    feat, world, R, c = make_pnp_scene(np.random.default_rng(1), B=400, N=N)
    Rj, cj, okj = jax.jit(jpnp.sqpnp)(jnp.asarray(feat), jnp.asarray(world))
    Rt, ct, okt = tpnp.sqpnp(_t(feat), _t(world))
    rate_j = float(np.mean(np.linalg.norm(np.asarray(cj) - c, axis=-1) < 1e-3))
    rate_t = float(np.mean(np.linalg.norm(ct.numpy() - c, axis=-1) < 1e-3))
    assert np.all(np.asarray(okj)) and bool(okt.all())
    assert low < rate_j < high, rate_j
    assert abs(rate_t - rate_j) <= RECOVERY_RATE_TOL, (rate_t, rate_j)


# --------------------------------------------------------------- estimators


def _known_orientation_scene(rng, n_in=60, n_out=26):
    """Inliers seen from a camera at c with rotation R, outliers random; the
    features rotated into the world-aligned frame by the true R."""
    feat, world, R, c = _abs_pose_scene(rng, n_in, n_out)
    return _rotated(feat, R), world, R, c


def test_known_orientation_absolute_pose_matches_jax_on_jax_draws(rng):
    rfeat, world, R, c = _known_orientation_scene(rng)
    jm, js, tm, ts = _both_estimators(
        jest.estimate_absolute_pose_with_known_orientation,
        test_.KNOWN_ORIENTATION_ABSOLUTE_POSE_ESTIMATOR, test_.Corr2D3D, (rfeat, world),
        dict(error_thresh=1e-8, max_iterations=64), "inlier", 2, jax.random.PRNGKey(3))
    np.testing.assert_allclose(tm.position[0].numpy(), np.asarray(jm), atol=MODEL_TOL)
    np.testing.assert_allclose(tm.position[0].numpy(), c, atol=1e-6)
    assert int(ts.num_inliers[0]) == 60


def test_known_orientation_relative_pose_matches_jax_on_jax_draws(rng):
    n_in, n_out = 60, 26
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, size=(n_in, 3)) + [0, 0, 8.0]
    p = X[:, :2] / X[:, 2:3]
    d = X - t
    q = d[:, :2] / d[:, 2:3]
    p = np.concatenate([p, rng.uniform(-0.3, 0.3, size=(n_out, 2))])
    q = np.concatenate([q, rng.uniform(-0.3, 0.3, size=(n_out, 2))])
    jm, js, tm, ts = _both_estimators(
        jest.estimate_relative_pose_with_known_orientation,
        test_.KNOWN_ORIENTATION_RELATIVE_POSE_ESTIMATOR, test_.TwoViewData, (p, q),
        dict(error_thresh=1e-8, max_iterations=64), "inlier", 2, jax.random.PRNGKey(7))
    tt, tj = tm.position[0].numpy(), np.asarray(jm)
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < MODEL_TOL
    assert abs(abs(float(tt @ t)) - 1.0) < 1e-9
    assert int(ts.num_inliers[0]) >= n_in


def _own_run(fn, data, params, seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    return fn(gen, *(_t(a)[None] for a in data), params, **kw)


@pytest.mark.parametrize("outliers", [0, 26])
@pytest.mark.parametrize("pnp_type", [0, 1, 2])
def test_typed_absolute_pose_with_own_generator(rng, pnp_type, outliers):
    """Clean data: every point an inlier in both packages. 30% outliers: the
    pose recovered and the outliers rejected, as by the JAX package."""
    feat, world, R, c = _abs_pose_scene(rng, 60, outliers)
    kw = dict(error_thresh=1e-8, max_iterations=128)
    jm, js = jest.estimate_calibrated_absolute_pose_typed(
        jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(world),
        dataclasses.replace(jest.engine.RansacParameters(), **kw), pnp_type=pnp_type)
    tm, ts = _own_run(test_.estimate_calibrated_absolute_pose_typed, (feat, world),
                      teng.RansacParameters(**kw), pnp_type=pnp_type)
    want = np.arange(60 + outliers) < 60
    np.testing.assert_array_equal(np.asarray(js.inliers), want)
    np.testing.assert_array_equal(ts.inliers[0].numpy(), want)
    # The best minimal hypothesis, unrefined (SQPnP's 8 Gauss-Newton steps
    # on its 3 points): near the pose, not at it.
    np.testing.assert_allclose(tm.rotation[0].numpy(), R, atol=1e-4)
    np.testing.assert_allclose(tm.position[0].numpy(), c, atol=1e-4)
    if outliers:
        # LO refits by the DLT on the inliers, as in the JAX package.
        kw["use_lo"] = True
        tm, ts = _own_run(test_.estimate_calibrated_absolute_pose_typed, (feat, world),
                          teng.RansacParameters(**kw), seed=1, pnp_type=pnp_type)
        np.testing.assert_array_equal(ts.inliers[0].numpy(), want)
        np.testing.assert_allclose(tm.position[0].numpy(), c, atol=1e-6)


def test_known_orientation_estimators_with_own_generator(rng):
    rfeat, world, R, c = _known_orientation_scene(rng)
    params = teng.RansacParameters(error_thresh=1e-8, max_iterations=64)
    m, s = _own_run(test_.estimate_absolute_pose_with_known_orientation, (rfeat, world), params)
    np.testing.assert_allclose(m.position[0].numpy(), c, atol=1e-6)
    np.testing.assert_array_equal(s.inliers[0].numpy(), np.arange(86) < 60)


# ------------------------------------------------------------- localization


def _scene(seed, targets, known_orientation=False):
    """The 7-view scene with every view but `targets` and every track at
    ground truth; the targets unestimated, their positions zeroed (and their
    rotations too unless `known_orientation`). Returns (JAX reconstruction,
    port reconstruction, ground-truth extrinsics)."""
    recon, gt_ext, pts = generate_scene(
        SyntheticSceneOptions(num_views=7, num_tracks=300, pixel_noise=0.3, seed=seed))
    recon.points[:, :3] = pts
    recon.points[:, 3] = 1.0
    recon.track_estimated[:] = True
    recon.view_estimated[:] = True
    for v in targets:
        recon.view_estimated[v] = False
        recon.view_extrinsics[v, :3] = 0.0
        if not known_orientation:
            recon.view_extrinsics[v, 3:] = 0.0
    return recon, convert.reconstruction(recon), gt_ext


def _pose_errors(recon, gt_ext, v):
    R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[v, 3:])
    R_gt = angle_axis_to_rotation_matrix_np(gt_ext[v, 3:])
    rot = float(np.linalg.norm(rotation_matrix_to_angle_axis_np(R @ R_gt.T)))
    return rot, float(np.linalg.norm(recon.view_extrinsics[v, :3] - gt_ext[v, :3]))


def _hold(jr, tr, gt_ext, views):
    for v in views:
        assert tr.view_estimated[v] and jr.view_estimated[v], v
        for got, want in zip(_pose_errors(tr, gt_ext, v), _pose_errors(jr, gt_ext, v)):
            assert got <= POSE_RATIO * want + POSE_SLACK, (v, got, want)


@pytest.mark.parametrize("seed,view", [(5, 3), (9, 6)])
@pytest.mark.parametrize("pnp_type", [0, 1, 2])
def test_localize_view_full_pose(seed, view, pnp_type):
    jr, tr, gt = _scene(seed, [view])
    jok, jsum = jloc.localize_view_to_reconstruction(
        view, jloc.LocalizeViewToReconstructionOptions(pnp_type=pnp_type), jr)
    tok, tsum = tloc.localize_view_to_reconstruction(
        view, tloc.LocalizeViewToReconstructionOptions(pnp_type=pnp_type), tr, device="cpu")
    assert jok and tok
    assert abs(int(tsum.num_inliers[0]) - int(jsum.num_inliers)) <= 3
    _hold(jr, tr, gt, [view])


def _hold_medians(jerrs, terrs):
    """Medians over views and draws of (rotation, position) errors."""
    for got, want in zip(np.median(terrs, axis=0), np.median(jerrs, axis=0)):
        assert got <= POSE_RATIO * want + POSE_SLACK, (got, want)


@pytest.mark.parametrize("seed,view", [(5, 3), (9, 6)])
def test_localize_view_known_orientation(seed, view):
    """No BA polish: the best 2-point hypothesis's error depends on the
    draws, so both packages are held over DRAWS keys / generator seeds."""
    kw = dict(assume_known_orientation=True, bundle_adjust_view=False)
    jerrs, terrs = [], []
    for draw in range(DRAWS["known orientation"]):
        jr, tr, gt = _scene(seed, [view], known_orientation=True)
        jok, _ = jloc.localize_view_to_reconstruction(
            view, jloc.LocalizeViewToReconstructionOptions(**kw), jr, key=jax.random.PRNGKey(draw))
        tok, _ = tloc.localize_view_to_reconstruction(
            view, tloc.LocalizeViewToReconstructionOptions(**kw), tr,
            generator=torch.Generator().manual_seed(draw), device="cpu")
        assert jok and tok
        np.testing.assert_array_equal(tr.view_extrinsics[view, 3:], gt[view, 3:])
        jerrs.append(_pose_errors(jr, gt, view))
        terrs.append(_pose_errors(tr, gt, view))
    _hold_medians(jerrs, terrs)


def test_localize_view_rejects_too_few_rows():
    jr, tr, gt = _scene(5, [2])
    options = tloc.LocalizeViewToReconstructionOptions(min_num_inliers=10_000)
    ok, summary = tloc.localize_view_to_reconstruction(2, options, tr, device="cpu")
    assert not ok and summary is None and not tr.view_estimated[2]


@pytest.mark.parametrize("seed,views", [(5, [1, 3, 5]), (9, [0, 2, 4, 6])])
@pytest.mark.parametrize("pnp_type", [0, 2])
def test_localize_views_batch(seed, views, pnp_type):
    """No BA polish (the caller's partial BA follows): held over DRAWS keys /
    generator seeds, as the known-orientation branch."""
    jerrs, terrs = [], []
    for draw in range(DRAWS["batch"]):
        jr, tr, gt = _scene(seed, views)
        jout = jloc.localize_views_to_reconstruction_batch(
            views, jloc.LocalizeViewToReconstructionOptions(pnp_type=pnp_type), jr,
            key=jax.random.PRNGKey(draw))
        tout = tloc.localize_views_to_reconstruction_batch(
            views, tloc.LocalizeViewToReconstructionOptions(pnp_type=pnp_type), tr,
            generator=torch.Generator().manual_seed(draw), device="cpu")
        assert sorted(tout) == sorted(jout) == sorted(views)
        for v in views:
            assert abs(tout[v] - jout[v]) <= 3
            assert tr.view_estimated[v]
            jerrs.append(_pose_errors(jr, gt, v))
            terrs.append(_pose_errors(tr, gt, v))
    _hold_medians(jerrs, terrs)


def _capture(monkeypatch, module, name, store):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        store.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def test_localize_inputs_match_jax(monkeypatch):
    """What reaches RANSAC: the normalized (and, with a known orientation,
    rotated) features, the points and the squared thresholds, in both
    branches and the batch."""
    got, want, want_batch = [], [], []
    for name in ("estimate_absolute_pose_with_known_orientation",
                 "estimate_calibrated_absolute_pose_typed"):
        _capture(monkeypatch, tloc, name, got)
        _capture(monkeypatch, jloc, name, want)
    _capture(monkeypatch, jloc, "_batched_localize_run", want_batch)
    for known in (True, False):
        jr, tr, gt = _scene(9, [6], known_orientation=known)
        kw = dict(assume_known_orientation=known, bundle_adjust_view=False)
        jloc.localize_view_to_reconstruction(6, jloc.LocalizeViewToReconstructionOptions(**kw), jr)
        tloc.localize_view_to_reconstruction(6, tloc.LocalizeViewToReconstructionOptions(**kw),
                                             tr, device="cpu")
    views = [0, 2, 4]
    jr, tr, gt = _scene(9, views)
    jloc.localize_views_to_reconstruction_batch(views, jloc.LocalizeViewToReconstructionOptions(),
                                                jr)
    want = want[:2] + want_batch  # not the batch's vmapped inner call
    tloc.localize_views_to_reconstruction_batch(views, tloc.LocalizeViewToReconstructionOptions(),
                                                tr, device="cpu")
    assert len(got) == len(want) == 3
    for (targs, tkw), (jargs, jkw) in zip(got[:2], want[:2]):
        n = int(jkw["num_data"])
        for a, b in zip(targs[1:3], jargs[1:3]):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b)[:n], rtol=1e-12, atol=1e-12)
        assert targs[3].error_thresh == pytest.approx(jargs[3].error_thresh, rel=1e-14)
    (targs, tkw), (jargs, _) = got[2], want[2]
    jmask = np.asarray(jargs[3])[:len(views)]
    n = targs[1].shape[1]
    np.testing.assert_array_equal(tkw["mask"].numpy(), jmask[:, :n])
    for a, b in zip(targs[1:3], jargs[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:len(views), :n] * jmask[:, :n, None],
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tkw["error_thresh"].numpy(), np.asarray(jargs[4])[:len(views)],
                               rtol=1e-14)
