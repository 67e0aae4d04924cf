"""Steps 1-7 of global SfM whole: `pytheiasfm_tpu_torch.tools.global_pose`
against the JAX estimator's own methods and functions in `estimate`'s order
(`test_torch_global_pose.jax_steps`), on the CPU in f64.

Bars, end to end: the same edge set after each filter; orientations within
1e-8 rad; positions within 1e-8 x the median distance of the positions from
their centroid; the ground-truth medians within 1% (+1e-6) of the JAX
package's.

The `slow` test runs the full-size scene (553 views, 50,000 tracks) the same
way and prints the JAX package's ground-truth medians and removal counts,
the constants `chip_smoke.py` holds the card to. There the contaminated
scene's positions are held to 1e-8 x the median radius as at the small
size, the clean scene's to 1e-4: on the clean scene LUD's 200 fixed ADMM
steps turn rounding-level differences into 1.8e-5 (JAX against the port)
and 1.6e-5 (the JAX function against itself with its input directions
scaled by 1 + 1e-15); after 150 steps 4.5e-10 and 7.2e-8. The test
measures and prints both at 150 and 200 steps, and holds the port to 1e-8
at 150. Run:

    python -m pytest tests/test_torch_global_pose_pipeline.py -m slow -s
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_global_pose as S
from pytheiasfm_tpu.global_pose import filters as jfilters
from pytheiasfm_tpu.global_pose import position_estimator as jpos
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.global_pose import filters as tfilters
from pytheiasfm_tpu_torch.global_pose import position_estimator as tpos
from pytheiasfm_tpu_torch.global_pose import rotation_estimator as trot
from pytheiasfm_tpu_torch.mvs import view_selection_mvsnet
from pytheiasfm_tpu_torch.pipelines import fountain
from pytheiasfm_tpu_torch.sfm.global_estimator import GlobalReconstructionEstimator
from pytheiasfm_tpu_torch.tools import global_pose as gp
from pytheiasfm_tpu_torch.tools import minimal_solvers
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


# Full size only; see above.
FULL_SIZE_POSITION_TOL_REL = {"clean": 1e-4, "contaminated": S.POSITION_TOL_REL}


def _compare(kind, position_tol=S.POSITION_TOL_REL, options=None, **size):
    recon, graph, gt_positions, gt_aa, bad = S.scene(kind, **size)
    ref = S.jax_steps(recon, graph, options and S.jax_options(gp.estimator_options(**options)))
    mine = convert.reconstruction(recon)
    res = gp.run_global_pose(convert.view_graph(graph), mine,
                             options and gp.estimator_options(**options), device="cpu")
    assert res.success
    assert res.edges["initial filter"] == set(ref["graph_initial"].edges)
    assert res.edges["orientation filter"] == set(ref["graph_orientation"].edges)
    assert res.edges["1DSfM"] == set(ref["graph_1dsfm"].edges)
    assert res.removed["orientation filter"] == len(ref["removed_orientation"])
    assert res.removed["1DSfM"] == len(ref["removed_1dsfm"])
    rot_diff = S.rotation_angle_diff(res.orientations, ref["orientations"])
    pos_diff = S.position_diff_rel(res.positions, ref["positions"])
    assert rot_diff <= S.ORIENTATION_TOL_RAD
    assert pos_diff <= position_tol
    mine_err = gp.ground_truth_errors(res.orientations, res.positions, gt_aa, gt_positions)
    want = S.jax_ground_truth_errors(ref["orientations"], ref["positions"], gt_aa, gt_positions)
    for m, w in zip(mine_err, want):
        assert abs(m - w) <= 0.01 * w + 1e-6
    # The reconstruction changes as `estimate` changes it (step 7).
    for v in range(mine.num_views()):
        assert mine.view_estimated[v] == (v in res.positions)
        if v in res.positions:
            np.testing.assert_array_equal(mine.view_extrinsics[v, :3], res.positions[v])
            np.testing.assert_array_equal(mine.view_extrinsics[v, 3:], res.orientations[v])
    return res, ref, mine_err, want, bad, rot_diff, pos_diff


@pytest.mark.parametrize("kind", ["clean", "contaminated"])
def test_steps_1_to_7_match_jax(kind):
    res, ref, _, _, bad, _, _ = _compare(kind)
    assert len(res.positions) == S.SMALL["V"]
    if kind == "contaminated":
        assert set(ref["removed_orientation"]) == bad
    assert set(res.seconds) == set(gp.STAGES)


def test_steps_1_to_7_with_the_rigid_subgraph_match_jax():
    """`extract_maximal_rigid_subgraph` on (the contaminated scene): the
    step sits between the orientation filter and the component step in
    both packages, and the edge sets, orientations and positions agree at
    the bars above."""
    res, ref, _, _, _, _, _ = _compare("contaminated", options=dict(rigid_subgraph=True))
    assert len(res.positions) == S.SMALL["V"] - ref["rigid_removed_views"]


def test_steps_1_to_7_stop_where_estimate_stops():
    """A view graph whose edges all fall below `min_num_two_view_inliers`
    stops at step 1, as `estimate` does, with nothing estimated."""
    recon, graph, _, _, _ = S.scene("clean", V=12, T=600, neighborhood=3)
    g = convert.view_graph(graph)
    for info in g.edges.values():
        info.num_verified_matches = 29
    mine = convert.reconstruction(recon)
    res = gp.run_global_pose(g, mine, device="cpu")
    assert not res.success and not res.positions and not mine.view_estimated.any()
    assert res.removed["initial filter"] == graph.num_edges() and g.num_edges() == 0
    assert list(res.seconds) == ["initial filter"]


def test_entry_points_run_on_the_card_unless_asked():
    """Without `device`, the entry points take the CUDA card, and raise
    where there is none."""
    recon, graph, _, _, _ = S.scene("clean", V=12, T=600, neighborhood=3)
    g = convert.view_graph(graph)
    calls = [
        lambda: gp.run_global_pose(copy.deepcopy(g), convert.reconstruction(recon)),
        lambda: trot.estimate_rotations(g),
        lambda: tpos.estimate_positions(g, {v: np.zeros(3) for v in g.view_ids()}),
        lambda: tfilters.filter_view_pairs_from_orientation(
            copy.deepcopy(g), {v: np.zeros(3) for v in g.view_ids()}),
        lambda: tfilters.filter_view_graph_cycles_by_rotation(copy.deepcopy(g)),
        lambda: tfilters.extract_maximally_parallel_rigid_subgraph(
            {v: np.zeros(3) for v in g.view_ids()}, copy.deepcopy(g)),
        lambda: minimal_solvers.main(["--only", "plane"]),
        lambda: fountain.evaluate(fountain_path="absent.recon", gt_path="absent.recon"),
        lambda: view_selection_mvsnet(convert.reconstruction(recon), 3),
    ]
    if torch.cuda.is_available():
        assert GlobalReconstructionEstimator().device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["clean", "contaminated"])
def test_full_size_steps_1_to_7_match_jax(kind):
    res, ref, mine, want, bad, rot_diff, pos_diff = _compare(
        kind, FULL_SIZE_POSITION_TOL_REL[kind], V=553, T=50_000)
    print(f"\n[{kind}] 553 views: JAX CPU median rotation error {want[0]!r} deg, median "
          f"position error {want[1]!r}; port CPU {mine[0]!r}, {mine[1]!r}; edges "
          f"{len(ref['graph_initial'].edges)}, removed by the orientation filter "
          f"{len(ref['removed_orientation'])}, by 1DSfM {len(ref['removed_1dsfm'])}; "
          f"corrupted {len(bad)}, surviving step 6 {len(bad & set(ref['graph_1dsfm'].edges))}; "
          f"port vs JAX: orientations {rot_diff:.3e} rad, positions {pos_diff:.3e} rel")
    assert len(res.positions) == 553
    # The same 1DSfM filter on 15% of directions corrupted after step 5.
    jg = copy.deepcopy(ref["graph_pairwise"])
    corrupted = S.contaminate(jg, rotations=False)
    before = set(jg.edges)
    tg = convert.view_graph(jg)
    kw = dict(num_iterations=48, translation_projection_tolerance=0.1)
    jfilters.filter_view_pairs_from_relative_translation(
        jg, ref["orientations_after_filter"], rng=np.random.default_rng(0), **kw)
    tfilters.filter_view_pairs_from_relative_translation(
        tg, ref["orientations_after_filter"], rng=np.random.default_rng(0), device="cpu", **kw)
    removed = before - set(jg.edges)
    print(f"[{kind}] 1DSfM on {len(corrupted)} directions corrupted after step 5: JAX CPU "
          f"removes {len(removed)}, {len(removed & corrupted)} of them corrupted")
    assert set(tg.edges) == set(jg.edges)
    _lud_sensitivity(kind, ref["graph_1dsfm"], ref["orientations"])


def _lud_sensitivity(kind, graph, orientations):
    """LUD on the JAX run's own last graph: the JAX function against the
    port and against itself with its directions scaled by 1 + 1e-15, after
    150 and after the default 200 ADMM steps."""
    ids = graph.view_ids()
    index = {v: i for i, v in enumerate(ids)}
    v1, v2, _, rel_pos, _ = graph.edge_arrays()
    ei = np.array([index[v] for v in v1], np.int32)
    ej = np.array([index[v] for v in v2], np.int32)
    free = np.arange(len(ids)) > 0
    t_world = np.asarray(jpos.relative_translations_to_world(
        jnp.asarray(np.stack([orientations[v] for v in ids])), jnp.asarray(ei),
        jnp.asarray(rel_pos)))

    def jax_lud(tw, steps):
        return np.asarray(jpos.least_unsquared_deviation_positions(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(tw), jnp.asarray(free), len(ids),
            outer_iters=steps))

    def rel(a, b):
        return np.linalg.norm(a - b, axis=-1).max() / np.median(
            np.linalg.norm(b - b.mean(0), axis=-1))

    for steps in (150, 200):
        want = jax_lud(t_world, steps)
        got = tpos.least_unsquared_deviation_positions(
            *(torch.as_tensor(a.astype(np.int64)) for a in (ei, ej)),
            torch.as_tensor(t_world), torch.as_tensor(free), len(ids), outer_iters=steps,
        ).numpy()
        itself = rel(jax_lud(t_world * (1 + 1e-15), steps), want)
        print(f"[{kind}] LUD after {steps} steps: port against JAX {rel(got, want):.3e}, JAX "
              f"against itself with directions x (1 + 1e-15) {itself:.3e} (x the median radius)")
        if steps == 150:
            assert rel(got, want) <= S.POSITION_TOL_REL

