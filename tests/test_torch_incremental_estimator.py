"""The port's incremental and hybrid estimators
(`pytheiasfm_tpu_torch/sfm/incremental_estimator.py`, `hybrid_estimator.py`)
against the JAX package's on the CPU, end to end.

Scenes: those of `tests/test_incremental_estimator.py` (7 views, 300
tracks, 0.3 px noise, seed 5; edges between views sharing 100 tracks, seed
1) and `tests/test_hybrid_and_builder.py` (seed 9; edges seed 2), with the
JAX tests' options. Each package localizes with its own random stream
(`jax.random` keys against a torch generator; `tests/test_torch_localize.py`
holds the layers below on common draws), so the bars are the JAX tests' and
the JAX run's: the port estimates at least as many views, its mean position
error after a Umeyama Sim(3) alignment (ATE) is below 0.1 and at most 1.25x
the JAX package's plus 1e-3. `ReconstructionBuilder` with INCREMENTAL and
HYBRID runs end to end on the builder scene of
`tests/test_torch_reconstruction_builder.py`, held the same way.
"""

import numpy as np
import pytest

from pytheiasfm_tpu.sfm.estimator_options import (
    ReconstructionEstimatorOptions as JOptions,
    ReconstructionEstimatorType as JType,
)
from pytheiasfm_tpu.sfm.hybrid_estimator import HybridReconstructionEstimator as JHybrid
from pytheiasfm_tpu.sfm.incremental_estimator import (
    IncrementalReconstructionEstimator as JIncremental,
)
from pytheiasfm_tpu.sfm.reconstruction_builder import (
    ReconstructionBuilder as JBuilder,
    ReconstructionBuilderOptions as JBOptions,
)
from pytheiasfm_tpu.utils.synthetic import (
    SyntheticSceneOptions,
    add_view_graph_edges,
    generate_scene,
)
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.sfm import estimator_options as topts
from pytheiasfm_tpu_torch.sfm.hybrid_estimator import HybridReconstructionEstimator
from pytheiasfm_tpu_torch.sfm.incremental_estimator import IncrementalReconstructionEstimator
from pytheiasfm_tpu_torch.sfm.reconstruction_builder import (
    ReconstructionBuilder as TBuilder,
    ReconstructionBuilderOptions as TBOptions,
)
from pytheiasfm_tpu_torch.tools import incremental_sfm
from test_hybrid_and_builder import _ate as _ate_by_name
from test_incremental_estimator import _ate
from test_torch_reconstruction_builder import _run, _scene
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

ATE_RATIO = 1.25
ATE_SLACK = 1e-3
MAX_ATE = 0.1
# The options of the JAX tests (`tests/test_incremental_estimator.py:40-48`).
OPTIONS = dict(
    min_num_absolute_pose_inliers=30,
    full_bundle_adjustment_growth_percent=30.0,
    max_num_iterations=20,
    ransac_max_iterations=256,
)
SCENES = {"incremental": (5, 1), "hybrid": (9, 2)}  # (scene seed, edge seed)


def _hold(got, want, got_views, want_views):
    assert got_views >= want_views
    assert got < MAX_ATE and got <= ATE_RATIO * want + ATE_SLACK, (got, want)


@pytest.fixture(scope="module", params=["incremental", "hybrid"])
def runs(request):
    kind = request.param
    seed, edge_seed = SCENES[kind]
    recon, gt_ext, _ = generate_scene(
        SyntheticSceneOptions(num_views=7, num_tracks=300, pixel_noise=0.3, seed=seed))
    graph = add_view_graph_edges(recon, gt_ext, min_shared_tracks=100, seed=edge_seed)
    trecon, tgraph = convert.reconstruction(recon), convert.view_graph(graph)
    jcls, tcls = {"incremental": (JIncremental, IncrementalReconstructionEstimator),
                  "hybrid": (JHybrid, HybridReconstructionEstimator)}[kind]
    want = jcls(JOptions(**OPTIONS)).estimate(graph, recon)
    estimator = tcls(topts.ReconstructionEstimatorOptions(**OPTIONS), device="cpu")
    got = estimator.estimate(tgraph, trecon)
    return kind, (recon, want), (trecon, got, estimator), gt_ext


def test_estimator_matches_jax(runs):
    kind, (jr, want), (tr, got, _), gt_ext = runs
    assert want.success and got.success, got.message
    assert len(got.estimated_views) >= 6
    (ate_t, n_t), (ate_j, n_j) = _ate(tr, gt_ext), _ate(jr, gt_ext)
    _hold(ate_t, ate_j, n_t, n_j)
    # The estimated tracks, as the JAX run's within 5% (every track of the
    # scene is seen by at least two views).
    assert abs(len(got.estimated_tracks) - len(want.estimated_tracks)) <= 0.05 * jr.num_tracks()


def test_estimator_counts_its_calls(runs):
    kind, _, (tr, got, estimator), _ = runs
    assert estimator.localization_passes >= 1 and estimator.bundle_adjustment_calls >= 2
    assert 0.0 <= estimator.view_scoring_time <= got.pose_estimation_time
    assert got.total_time >= got.bundle_adjustment_time + got.triangulation_time
    if kind == "hybrid":
        # One localization call or two (the full-pose fallback) a view tried.
        assert estimator.localization_passes >= len(got.estimated_views) - 2


@pytest.mark.parametrize("kind", ["INCREMENTAL", "HYBRID"])
def test_builder_matches_jax(kind):
    views, matches = _scene(13, "a_")
    want = _run(JBuilder(JBOptions(
        min_num_inlier_matches=30,
        reconstruction_estimator_options=JOptions(reconstruction_estimator_type=JType[kind]))),
        views, matches, to_port=False)
    got = _run(TBuilder(TBOptions(
        min_num_inlier_matches=30,
        reconstruction_estimator_options=topts.ReconstructionEstimatorOptions(
            reconstruction_estimator_type=topts.ReconstructionEstimatorType[kind])),
        device="cpu"), views, matches, to_port=True)
    assert len(got) == len(want) >= 1
    src, gt_ext, _ = generate_scene(
        SyntheticSceneOptions(num_views=6, num_tracks=250, pixel_noise=0.2, seed=13))
    gt = {f"a_{src.view_names[v]}": gt_ext[v, :3] for v in range(6)}
    (ate_t, n_t), (ate_j, n_j) = _ate_by_name(got[0], gt), _ate_by_name(want[0], gt)
    assert n_t >= 5
    _hold(ate_t, ate_j, n_t, n_j)


def test_incremental_sfm_tool_on_the_cpu():
    """The card tool's run at a small size: every view, the bookkeeping."""
    res = incremental_sfm.run("incremental", views=8, tracks=300, seed=5, device="cpu")
    assert res["success"] and res["views"] == 8 and res["median_pos_err"] < 0.01
    assert res["localization_passes"] >= 1 and res["counters"]["localize_batch_launch"] >= 1
    lines = incremental_sfm.describe("cpu", res)
    assert "8/8 views" in lines[0] and "BA calls" in lines[1]


def test_builder_inputs_round_trip(tmp_path):
    """`record_builder_inputs` -> `save_builder_inputs` -> `load_builder_inputs`
    gives the builder the same scene: the same models from the same
    estimator."""
    views, matches = _scene(13, "a_")
    with incremental_sfm.record_builder_inputs() as rec:
        first = _run(TBuilder(TBOptions(min_num_inlier_matches=30), device="cpu"), views,
                     matches, to_port=True)
    assert len(rec["views"]) == 6 and len(rec["matches"]) == len(matches)
    incremental_sfm.save_builder_inputs(tmp_path / "g.npz", rec, np.zeros((6, 6)))
    lviews, lmatches, ext = incremental_sfm.load_builder_inputs(tmp_path / "g.npz")
    assert [n for n, _ in lviews] == [n for n, _ in views] and ext.shape == (6, 6)
    again = incremental_sfm.build_from_inputs(lviews, lmatches, "global", device="cpu")
    assert len(again) == len(first) == 1
    np.testing.assert_array_equal(again[0].view_estimated, first[0].view_estimated)
    np.testing.assert_allclose(again[0].view_extrinsics, first[0].view_extrinsics, atol=1e-9)
