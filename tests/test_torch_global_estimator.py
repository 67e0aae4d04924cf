"""`GlobalReconstructionEstimator.estimate` whole, the port against the JAX
package, on the CPU: the scenes of `tests/test_global_estimator.py` (8
views, 150 tracks, 0.3 px noise; edges with 0 and 1 deg of rotation and
direction noise), `create_reconstruction_estimator`, and
`pipelines.synthetic_global.run` at 48 views (held to ground truth).

Both run at their defaults: the track estimator and BA in f32 (the JAX
package's `dtype=np.float32` defaults), steps 1-7 in f64. Bars: the same
estimated views; estimated track sets differing in at most 1% of the
tracks; the port's positions, Sim(3)-aligned onto the JAX package's, within
1e-4 x the ring radius (10); the ATE (Sim(3)-aligned to ground truth, mean)
under the JAX test's own bars (0.05 clean, 0.3 at 1 deg). f32 BA
trajectories differ in rounding, so converged states are compared. The
same scenes calibrated (constant intrinsics, XYZW tracks: BA by the dense
Schur) are held to the same bars.

The `slow` tests run `synthetic_global.run()` and `run(calibrated=True)` at
full size (553 views, 50,000 tracks) in both packages and print the JAX
package's CPU results that `chip_smoke.py` holds the card to (phases 5 and
6):

    python -m pytest tests/test_torch_global_estimator.py -m slow -s
"""

import copy
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.models.intrinsics import OptimizeIntrinsicsType as JOI
from pytheiasfm_tpu.pipelines import synthetic_global as jsg
from pytheiasfm_tpu.sfm.estimator_options import ReconstructionEstimatorOptions as JOptions
from pytheiasfm_tpu.sfm.global_estimator import GlobalReconstructionEstimator as JEstimator
from pytheiasfm_tpu.transforms import alignment as jalign
from pytheiasfm_tpu.utils import synthetic as jsyn
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba.lm import TrackParametrizationType as TTP
from pytheiasfm_tpu_torch.models.intrinsics import OptimizeIntrinsicsType as TOI
from pytheiasfm_tpu_torch.pipelines import synthetic_global as tsg
from pytheiasfm_tpu_torch.sfm import estimator_options as topts
from pytheiasfm_tpu_torch.sfm.global_estimator import GlobalReconstructionEstimator
from pytheiasfm_tpu_torch.sfm.reconstruction_estimator import create_reconstruction_estimator
from pytheiasfm_tpu_torch.transforms import alignment as talign
from pytheiasfm_tpu_torch.utils import counters
from pytheiasfm_tpu_torch.utils import synthetic as tsyn
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

RADIUS = 10.0
POSITION_TOL = 1e-4 * RADIUS
TRACK_SHARE_TOL = 0.01
ATE_BAR = {0.0: 0.05, 1.0: 0.3}


def _scene(noise_deg):
    """The JAX test's scene and view graph (`test_global_estimator.py:39-68`)."""
    opt = jsyn.SyntheticSceneOptions(num_views=8, num_tracks=150, pixel_noise=0.3, seed=7)
    recon, gt_ext, _ = jsyn.generate_scene(opt)
    graph = jsyn.add_view_graph_edges(recon, gt_ext, min_shared_tracks=20,
                                      rotation_noise_degrees=noise_deg,
                                      position_noise_degrees=noise_deg, seed=3)
    return recon, graph, gt_ext


def _ate(recon, gt_ext):
    ids = np.nonzero(recon.view_estimated)[0]
    est = torch.as_tensor(recon.view_extrinsics[ids, :3])
    gt = torch.as_tensor(gt_ext[ids, :3])
    R, t, s = talign.align_point_clouds_umeyama(est, gt)
    return float(torch.linalg.norm(talign.sim3_transform_points(est, R, t, s) - gt, dim=-1)
                 .mean())


@pytest.fixture(scope="module", params=[0.0, 1.0])
def runs(request):
    noise = request.param
    recon, graph, gt_ext = _scene(noise)
    trecon, tgraph = convert.reconstruction(recon), convert.view_graph(graph)
    options = dict(min_num_two_view_inliers=20, num_retriangulation_iterations=1)
    jsum = JEstimator(JOptions(**options)).estimate(graph, recon)
    counters.reset()
    est = GlobalReconstructionEstimator(topts.ReconstructionEstimatorOptions(**options),
                                        device="cpu")
    tsum = est.estimate(tgraph, trecon)
    launches = counters.snapshot()
    return noise, gt_ext, (recon, jsum), (trecon, tsum, est, launches)


def test_estimate_matches_jax(runs):
    noise, gt_ext, (jr, jsum), (tr, tsum, est, _) = runs
    assert tsum.success and jsum.success, tsum.message
    assert tsum.estimated_views == jsum.estimated_views
    assert len(tsum.estimated_views) == 8
    sym = tsum.estimated_tracks ^ jsum.estimated_tracks
    assert len(sym) <= TRACK_SHARE_TOL * tr.num_tracks(), len(sym)
    assert len(tsum.estimated_tracks) >= 50
    ids = sorted(tsum.estimated_views)
    mine = torch.as_tensor(tr.view_extrinsics[ids, :3])
    want = torch.as_tensor(jr.view_extrinsics[ids, :3])
    R, t, s = talign.align_point_clouds_umeyama(mine, want)
    gap = float(torch.linalg.norm(talign.sim3_transform_points(mine, R, t, s) - want, dim=-1).max())
    assert gap <= POSITION_TOL, gap
    assert _ate(tr, gt_ext) < ATE_BAR[noise]
    assert tsum.message == f"estimated 8 views, {len(tsum.estimated_tracks)} tracks"


@pytest.fixture(scope="module", params=[0.0, 1.0])
def calibrated_runs(request):
    """The same scenes with constant intrinsics and XYZW tracks: BA takes
    the dense Schur in both packages."""
    noise = request.param
    recon, graph, gt_ext = _scene(noise)
    trecon, tgraph = convert.reconstruction(recon), convert.view_graph(graph)
    options = dict(min_num_two_view_inliers=20, num_retriangulation_iterations=1)
    jsum = JEstimator(JOptions(**options, intrinsics_to_optimize=JOI.NONE,
                               track_parametrization_type=JTP.XYZW)).estimate(graph, recon)
    topt = topts.ReconstructionEstimatorOptions(
        **options, intrinsics_to_optimize=TOI.NONE,
        track_parametrization_type=TTP.XYZW)
    est = GlobalReconstructionEstimator(topt, device="cpu")
    tsum = est.estimate(tgraph, trecon)
    return noise, gt_ext, (recon, jsum), (trecon, tsum, est)


def test_calibrated_estimate_matches_jax(calibrated_runs):
    """Bars of `test_estimate_matches_jax`; every BA round takes the dense
    Schur, and the intrinsics stay as they were."""
    noise, gt_ext, (jr, jsum), (tr, tsum, est) = calibrated_runs
    assert tsum.success and jsum.success, tsum.message
    assert tsum.estimated_views == jsum.estimated_views
    assert len(tsum.estimated_views) == 8
    sym = tsum.estimated_tracks ^ jsum.estimated_tracks
    assert len(sym) <= TRACK_SHARE_TOL * tr.num_tracks(), len(sym)
    ids = sorted(tsum.estimated_views)
    mine = torch.as_tensor(tr.view_extrinsics[ids, :3])
    want = torch.as_tensor(jr.view_extrinsics[ids, :3])
    R, t, s = talign.align_point_clouds_umeyama(mine, want)
    gap = float(torch.linalg.norm(talign.sim3_transform_points(mine, R, t, s) - want, dim=-1).max())
    assert gap <= POSITION_TOL, gap
    assert _ate(tr, gt_ext) < ATE_BAR[noise]
    assert all(r["solver"] == "dense" for r in est.bundle_adjustment_rounds)
    np.testing.assert_array_equal(tr.intrinsics, convert.reconstruction(_scene(noise)[0]).intrinsics)


def test_estimate_reports_its_stages(runs):
    _, _, _, (tr, tsum, est, launches) = runs
    for name in ("rotation_estimation_time", "position_estimation_time",
                 "triangulation_time", "bundle_adjustment_time", "total_time"):
        assert getattr(tsum, name) > 0, name
    assert tsum.pose_estimation_time >= tsum.rotation_estimation_time
    rounds = est.bundle_adjustment_rounds
    assert 1 <= len(rounds) <= 2
    assert all(r["iterations"] >= 1 and r["final_cost"] <= r["initial_cost"] for r in rounds)
    # One BA solve a round; a reprojection pass a round's outlier filter;
    # one triangulation, plus one a retriangulation.
    assert launches["ba_launch"] == len(rounds)
    assert launches["reproject_launch"] == len(rounds)
    assert launches["triangulate_launch"] == 1 + sum(r["retriangulated"] > 0 for r in rounds)


def test_generate_scene_matches_jax():
    opt = dict(num_views=8, num_tracks=150, pixel_noise=0.3, seed=7)
    jr, jext, jpts = jsyn.generate_scene(jsyn.SyntheticSceneOptions(**opt))
    tr, text, tpts = tsyn.generate_scene(tsyn.SyntheticSceneOptions(**opt))
    np.testing.assert_allclose(text, jext, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tpts, jpts)
    np.testing.assert_array_equal(tr.obs_view, jr.obs_view)
    np.testing.assert_array_equal(tr.obs_track, jr.obs_track)
    np.testing.assert_allclose(tr.obs_uv, jr.obs_uv, rtol=0, atol=1e-9)
    for noise in (0.0, 1.0):
        kw = dict(min_shared_tracks=20, rotation_noise_degrees=noise,
                  position_noise_degrees=noise, seed=3)
        jg = jsyn.add_view_graph_edges(jr, jext, **kw)
        tg = tsyn.add_view_graph_edges(tr, text, **kw)
        assert list(tg.edges) == list(jg.edges)
        for key, info in jg.edges.items():
            np.testing.assert_allclose(tg.edges[key].rotation_2, info.rotation_2, atol=1e-12)
            np.testing.assert_allclose(tg.edges[key].position_2, info.position_2, atol=1e-12)
            assert tg.edges[key].num_verified_matches == info.num_verified_matches
    jrr = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=1)
    trr = tsyn.random_reconstruction(num_views=6, num_tracks=40, seed=1)
    np.testing.assert_array_equal(trr.track_estimated, jrr.track_estimated)
    np.testing.assert_allclose(trr.points, jrr.points, atol=0)


def test_alignment_of_reconstructions():
    jr = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=2)
    tr = convert.reconstruction(jr)
    R = np.asarray(jnp.asarray(talign.angle_axis_to_rotation_matrix_np([0.1, -0.2, 0.3])))
    for recon, fn in ((jr, jalign.transform_reconstruction),
                      (tr, talign.transform_reconstruction)):
        fn(recon, R, np.array([1.0, 2.0, -1.0]), 1.7)
    np.testing.assert_allclose(tr.view_extrinsics, jr.view_extrinsics, atol=1e-12)
    np.testing.assert_allclose(tr.points, jr.points, atol=1e-12)
    ref = convert.reconstruction(jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=2))
    jref = copy.deepcopy(jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=2))
    jR, jt, js = jalign.align_reconstructions(jr, jref)
    tR, tt, ts = talign.align_reconstructions(tr, ref)
    np.testing.assert_allclose(tR, jR, atol=1e-10)
    assert ts == pytest.approx(js, rel=1e-10)
    np.testing.assert_allclose(tr.view_extrinsics[:, :3], ref.view_extrinsics[:, :3], atol=1e-9)
    # Robust: one view far off; the same triples from the same numpy seed.
    for recon in (jr, tr):
        recon.view_extrinsics[4, :3] += 50.0
    jR, jt, js = jalign.align_reconstructions_robust(jr, jref, rng=np.random.default_rng(4))
    tR, tt, ts = talign.align_reconstructions_robust(tr, ref, rng=np.random.default_rng(4))
    np.testing.assert_allclose(tR, jR, atol=1e-10)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-9)


def test_create_reconstruction_estimator():
    est = create_reconstruction_estimator(device="cpu")
    assert isinstance(est, GlobalReconstructionEstimator)
    for kind in ("INCREMENTAL", "HYBRID"):
        options = topts.ReconstructionEstimatorOptions(
            reconstruction_estimator_type=topts.ReconstructionEstimatorType[kind])
        with pytest.raises(NotImplementedError, match="C1"):
            create_reconstruction_estimator(options, device="cpu")
    # The calibrated configuration runs, through the dense Schur.
    got = tsg.run(V=24, T=1500, calibrated=True, device="cpu")
    assert got["success"] and got["views"] == 24
    assert got["ba_rounds"] and {r["solver"] for r in got["ba_rounds"]} == {"dense"}
    assert got["median_pos_err"] < 0.01


def test_estimate_stops_without_edges():
    recon, graph, _ = _scene(0.0)
    options = topts.ReconstructionEstimatorOptions(min_num_two_view_inliers=10_000)
    summary = GlobalReconstructionEstimator(options, device="cpu").estimate(
        convert.view_graph(graph), convert.reconstruction(recon))
    assert not summary.success and summary.message == "insufficient view pairs"


SMALL_RUN = dict(V=48, T=4000, seed=0)


def jax_run(**kw):
    """The JAX package's `synthetic_global.run`, with the count of tracks
    its estimator estimated and its BA-round log lines kept."""
    import logging

    from pytheiasfm_tpu.utils.log import logger as jlogger

    kept, lines = {}, []
    estimate = JEstimator.estimate

    def keep_summary(self, view_graph, recon):
        kept["summary"] = estimate(self, view_graph, recon)
        return kept["summary"]

    class Keep(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("BA round"):
                lines.append(record.getMessage())

    handler, level = Keep(), jlogger.level
    JEstimator.estimate = keep_summary
    jlogger.addHandler(handler)
    jlogger.setLevel(logging.INFO)
    try:
        out = jsg.run(**kw)
    finally:
        JEstimator.estimate = estimate
        jlogger.removeHandler(handler)
        jlogger.setLevel(level)
    out["estimated_tracks"] = len(kept["summary"].estimated_tracks)
    out["ba_log"] = lines
    return out


def test_synthetic_global_run_small():
    """`synthetic_global.run` at 48 views, reference-default options, held
    to ground truth (the full-size run is held to the JAX package's by the
    `slow` test below, the estimator at small size by the tests above)."""
    got = tsg.run(**SMALL_RUN, device="cpu")
    assert got["success"] and got["views"] == got["views_total"] == 48
    assert got["estimated_tracks"] >= 0.99 * got["tracks"]
    assert got["median_pos_err"] < 0.01
    assert got["ba_rounds"] and got["ba_rounds"][0]["iterations"] >= 1
    assert set(got["stage_seconds"]) >= {"positions", "triangulation", "bundle adjustment"}
    assert not got["launches"]  # no profiling unless asked


@pytest.mark.slow
def test_full_size_run_matches_jax():
    """553 views, 50,000 tracks, seed 0, in both packages on the CPU; prints
    the JAX package's numbers that `chip_smoke.py` holds the card to."""
    t0 = time.perf_counter()
    want = jax_run()
    t_jax = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = tsg.run(device="cpu")
    t_port = time.perf_counter() - t0
    print(f"\n[553 views] JAX CPU ({t_jax:.1f} s): views {want['views']}, estimated tracks "
          f"{want['estimated_tracks']}, median position error {want['median_pos_err']!r}, "
          f"mean {want['mean_pos_err']!r}; BA: {want['ba_log']}")
    print(f"[553 views] port CPU ({t_port:.1f} s): views {got['views']}, estimated tracks "
          f"{got['estimated_tracks']}, median position error {got['median_pos_err']!r}, mean "
          f"{got['mean_pos_err']!r}; BA rounds: {got['ba_rounds']}")
    assert got["success"] and got["views"] == want["views"] == 553
    assert abs(got["estimated_tracks"] - want["estimated_tracks"]) <= 0.005 * want[
        "estimated_tracks"]
    assert got["median_pos_err"] == pytest.approx(want["median_pos_err"], rel=0.02, abs=1e-6)


@pytest.mark.slow
def test_full_size_calibrated_run_matches_jax():
    """`synthetic_global.run(calibrated=True)` at 553 views in both packages
    on the CPU (the dense Schur; the JAX kernel's one-hot form costs about
    7e12 operations an LM iteration, so minutes); prints the JAX package's
    numbers that `chip_smoke.py` phase 6 holds the card to."""
    t0 = time.perf_counter()
    want = jax_run(calibrated=True)
    t_jax = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = tsg.run(calibrated=True, device="cpu")
    t_port = time.perf_counter() - t0
    print(f"\n[553 views, calibrated] JAX CPU ({t_jax:.1f} s): views {want['views']}, estimated "
          f"tracks {want['estimated_tracks']}, median position error {want['median_pos_err']!r}, "
          f"mean {want['mean_pos_err']!r}; BA: {want['ba_log']}")
    print(f"[553 views, calibrated] port CPU ({t_port:.1f} s): views {got['views']}, estimated "
          f"tracks {got['estimated_tracks']}, median position error {got['median_pos_err']!r}, "
          f"mean {got['mean_pos_err']!r}; BA rounds: {got['ba_rounds']}")
    assert got["success"] and got["views"] == want["views"] == 553
    assert {r["solver"] for r in got["ba_rounds"]} == {"dense"}
    assert abs(got["estimated_tracks"] - want["estimated_tracks"]) <= 0.005 * want[
        "estimated_tracks"]
    assert got["median_pos_err"] == pytest.approx(want["median_pos_err"], rel=0.02, abs=1e-6)
