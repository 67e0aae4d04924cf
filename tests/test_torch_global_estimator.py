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

`estimate` on the 48-view scene with 15% of its edges corrupted
(`tools.global_pose.contaminate`): the same edges removed by each filter,
the same views, tracks within 1% and the median position error within 5%
of the JAX package's.

The `slow` tests run `synthetic_global.run()` and `run(calibrated=True)` at
full size (553 views, 50,000 tracks) in both packages and print the JAX
package's CPU results that `chip_smoke.py` holds the card to (phases 5 and
6); `-k "scale_run or contaminated_full_size or eight_model_rig"` prints
those of phases 8-10 (the JAX package alone: 2152 views, the contaminated
553-view graph, the camera-model rig):

    python -m pytest tests/test_torch_global_estimator.py -m slow -s
"""

import contextlib
import copy
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.ba import iterative_schur as jis
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
from pytheiasfm_tpu_torch.tools import global_sfm
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


@contextlib.contextmanager
def jax_ba_log():
    """The JAX estimator's "BA round" log lines while the block runs."""
    import logging

    from pytheiasfm_tpu.utils.log import logger as jlogger

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("BA round"):
                lines.append(record.getMessage())

    handler, level = Keep(), jlogger.level
    jlogger.addHandler(handler)
    jlogger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        jlogger.removeHandler(handler)
        jlogger.setLevel(level)


def jax_run(**kw):
    """The JAX package's `synthetic_global.run`, with the count of tracks
    its estimator estimated, its BA-round log lines and the iterative
    kernel's size gates of each BA round kept."""
    kept, gates = {}, []
    estimate = JEstimator.estimate
    iterative = jentry.bundle_adjust_iterative

    def keep_summary(self, view_graph, recon):
        kept["summary"] = estimate(self, view_graph, recon)
        return kept["summary"]

    def keep_gates(*args, **kwargs):
        V, T, L = kwargs["num_views"], kwargs["num_tracks"], kwargs["max_track_len"]
        # The JAX kernel's gates (`ba/iterative_schur.py:222-226`; its
        # coarse target of 160 aggregates is a local there).
        group = 16 * max(1, -(-V // (16 * 160)))
        gates.append(dict(V=V, T=T, L=L, use_coarse=V >= 1024, group=group, Vc=-(-V // group),
                          coarse_stride=4 if T * L > jis._SCAN_SLOT_THRESHOLD else 1))
        return iterative(*args, **kwargs)

    JEstimator.estimate = keep_summary
    jentry.bundle_adjust_iterative = keep_gates
    try:
        with jax_ba_log() as lines:
            out = jsg.run(**kw)
    finally:
        JEstimator.estimate = estimate
        jentry.bundle_adjust_iterative = iterative
    out["estimated_tracks"] = len(kept["summary"].estimated_tracks)
    out["ba_log"] = lines
    out["size_gates"] = gates
    return out


def jax_contaminated(monkeypatch, seed=0, **size):
    """The JAX estimator at the reference-default options on the port's
    `build_scene(**size)` carried into the JAX containers and contaminated
    by `tools.global_pose.contaminate`: (views, estimated views, estimated
    tracks, median and mean position error after Umeyama, each filter's
    removed edges, BA log lines)."""
    import test_torch_global_pose as S

    from pytheiasfm_tpu.global_pose import filters as jfilters

    recon, graph, gt_positions, _, _ = S.scene("contaminated", seed=seed, **size)
    removed = {}
    for name, key in (("filter_view_pairs_from_orientation", "orientation filter"),
                      ("filter_view_pairs_from_relative_translation", "1DSfM")):
        def keep(*a, _fn=getattr(jfilters, name), _key=key, **k):
            removed[_key] = _fn(*a, **k)
            return removed[_key]

        monkeypatch.setattr(jfilters, name, keep)
    with jax_ba_log() as lines:
        summary = JEstimator(JOptions(rng_seed=seed)).estimate(graph, recon)
    ids, err = tsg.position_errors(recon, gt_positions)
    return dict(views=len(ids), estimated_views=summary.estimated_views,
                estimated_tracks=len(summary.estimated_tracks),
                median_pos_err=float(np.median(err)), mean_pos_err=float(np.mean(err)),
                removed_edges=removed, ba_log=lines)


CONTAMINATED_SMALL = dict(V=48, T=4000, neighborhood=6)


def test_contaminated_estimate_matches_jax(monkeypatch):
    """`estimate` end to end on the 48-view scene with 15% of its edges
    corrupted (the size the filters are held at in
    `test_torch_global_pose.py`): the same edges removed by each filter,
    the same estimated views, estimated tracks within 1% and the median
    position error within 5% of the JAX package's. No RANSAC draws on this
    path."""
    want = jax_contaminated(monkeypatch, **CONTAMINATED_SMALL)
    got = global_sfm.run_contaminated(device="cpu", **CONTAMINATED_SMALL)
    assert got["success"]
    assert got["removed_edges"]["orientation filter"] == want["removed_edges"][
        "orientation filter"] > 0
    assert got["removed_edges"]["1DSfM"] == want["removed_edges"]["1DSfM"]
    assert got["estimated_views"] == want["estimated_views"]
    assert got["views"] >= 46
    assert abs(got["estimated_tracks"] - want["estimated_tracks"]) <= 0.01 * want[
        "estimated_tracks"]
    assert got["median_pos_err"] == pytest.approx(want["median_pos_err"], rel=0.05)


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


@pytest.mark.slow
def test_scale_run_constants():
    """`synthetic_global.run(V=2152, T=100_000)`, the repository's largest
    scene, in the JAX package on the CPU; prints its numbers that
    `chip_smoke.py` phase 8 holds the card to, with each BA round's size
    gates (the two-level preconditioner switches on at this size). Run it
    with JAX_PLATFORMS=cpu on a host with tens of GiB and several cores
    (about two minutes on the 8 cores of an H100 machine's host)."""
    t0 = time.perf_counter()
    want = jax_run(V=2152, T=100_000, seed=0)
    print(f"\n[2152 views] JAX CPU ({time.perf_counter() - t0:.1f} s): views {want['views']}, "
          f"tracks {want['tracks']}, estimated tracks {want['estimated_tracks']}, median "
          f"position error {want['median_pos_err']!r}, mean {want['mean_pos_err']!r}; BA: "
          f"{want['ba_log']}; size gates {want['size_gates']}")
    assert want["success"] and want["views"] >= 2150
    assert all(g["use_coarse"] for g in want["size_gates"])


@pytest.mark.slow
def test_contaminated_full_size_constants(monkeypatch):
    """`estimate` on the 553-view scene with 15% of its edges corrupted, in
    the JAX package on the CPU; prints its numbers that `chip_smoke.py`
    phase 9 holds the card to."""
    t0 = time.perf_counter()
    want = jax_contaminated(monkeypatch, V=553, T=50_000)
    print(f"\n[553 views, contaminated] JAX CPU ({time.perf_counter() - t0:.1f} s): views "
          f"{want['views']}, estimated tracks {want['estimated_tracks']}, median position "
          f"error {want['median_pos_err']!r}, mean {want['mean_pos_err']!r}; removed edges "
          f"{want['removed_edges']}; BA: {want['ba_log']}")
    assert want["views"] >= 550


@pytest.mark.slow
def test_eight_model_rig_constants():
    """The camera-model rig of `tools.camera_rig` (the eight models, 64
    views and 4,000 tracks a model, 0.5 px noise), perturbed,
    bundle-adjusted by the JAX package on the CPU in `camera_rig.RIG_DTYPE`
    (f64) with free focal length and radial distortion; prints its numbers
    that `chip_smoke.py` phase 10 holds the card to (cost, LM iterations,
    each group's median position error)."""
    import test_torch_global_pose as S

    from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JBAOptions
    from pytheiasfm_tpu_torch.sfm.view_graph import ViewGraph
    from pytheiasfm_tpu_torch.tools import camera_rig

    rig = camera_rig.build_rig()
    free = camera_rig.perturb(rig)
    before = camera_rig.group_position_errors(rig, rig.recon.view_extrinsics)
    jrecon, _ = S.to_jax(rig.recon, ViewGraph())
    tracks = [int(t) for t in np.nonzero(jrecon.track_estimated)[0]]
    t0 = time.perf_counter()
    js = jentry.bundle_adjust_partial_reconstruction(
        JBAOptions(intrinsics_to_optimize=JOI.FOCAL_LENGTH | JOI.RADIAL_DISTORTION), free,
        tracks, jrecon, dtype=camera_rig.RIG_DTYPE)
    seconds = time.perf_counter() - t0
    after = camera_rig.group_position_errors(rig, jrecon.view_extrinsics)
    print(f"\n[rig] {jrecon.num_views()} views, {jrecon.num_tracks()} tracks, "
          f"{jrecon.num_observations()} observations; JAX CPU ({seconds:.1f} s): success "
          f"{bool(js.success)}, {int(js.num_iterations)} LM iterations, cost "
          f"{float(js.initial_cost)!r} -> {float(js.final_cost)!r}")
    for m, b, a in zip(rig.models, before, after):
        print(f"  {m.name}: median position error {b!r} -> {a!r}")
    assert bool(js.success)
