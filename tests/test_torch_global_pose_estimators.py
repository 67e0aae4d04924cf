"""The port's other global-pose estimators and filters, each against the JAX
function on the same numpy-seeded inputs: the rotation estimators NONLINEAR
and LINEAR, the position estimators NONLINEAR, LINEAR_TRIPLET, LiGT and
BATA, the `estimate_rotations` / `estimate_positions` dispatch of every
type, the rotation-cycle filter, the maximal parallel-rigid subgraph and
the triplet baseline ratios. Scenes: those of `tests/test_global_pose.py`,
`tests/test_sdp_and_positions.py`, `tests/test_aux_parity.py` (the 9-view
ring) and `tests/test_triplet_baseline.py`. CPU, f64.

Bars. Where nothing random separates the packages: orientations 1e-8 rad,
positions 1e-8 x the median distance from their centroid, removed edge and
view sets equal, baselines 1e-10. Where the JAX package draws a start from
`jax.random` (LINEAR rotations, LINEAR_TRIPLET, LiGT), the function takes
that draw (`start`) and is held at those bars; through the entries, which
draw from the port's generator, LINEAR rotations (aligned to the MST start
in both) are held at 1e-6 rad and LINEAR_TRIPLET at the JAX test's bar.

Three functions are chaotic in rounding in the JAX package itself, which
the tests measure by scaling the JAX function's input by 1 + 1e-15:
- BATA: 100 rounds of nearly singular solves move the JAX result by 8e-5,
  its error against ground truth over 4e-5 to 1e-3. Two rounds stay within
  1e-7 and are held there; the default run by the JAX test's bar and 1.25x
  the largest error of four such JAX runs (through the entry: 1.25x the JAX
  run's + 1e-4 x the scene's scale).
- LiGT at its default 200 CG steps a solve on exact data: CG runs past
  convergence, and the JAX result moves by 3e-7. At 20 steps the packages
  agree to 3e-16, held at 1e-8; the default by the JAX test's bar.
- NONLINEAR positions: the scale of the solution is free and the first LM
  steps solve a damped, nearly singular system; the JAX result moves by up
  to 9e-7 x the median radius after one step, 3e-10 after 50. Held at 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.global_pose import filters as jfilters
from pytheiasfm_tpu.global_pose import position_estimator as jpos
from pytheiasfm_tpu.global_pose import rotation_estimator as jrot
from pytheiasfm_tpu.global_pose.triplet_baseline import (
    compute_triplet_baseline_ratios as jbaseline,
)
from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo
from pytheiasfm_tpu.utils.synthetic import (
    SyntheticSceneOptions,
    add_view_graph_edges,
    generate_scene,
)
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.global_pose import filters as tfilters
from pytheiasfm_tpu_torch.global_pose import position_estimator as tpos
from pytheiasfm_tpu_torch.global_pose import rotation_estimator as trot
from pytheiasfm_tpu_torch.global_pose.triplet_baseline import (
    compute_triplet_baseline_ratios as tbaseline,
)
from test_global_pose import make_scene, position_error, rotation_error_deg
from test_sdp_and_positions import _aa_to_R, _rand_aa, _sim3_position_error
from test_torch_global_pose import position_diff_rel, rotation_angle_diff
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)
from test_triplet_baseline import _triplet

T = torch.as_tensor
ORIENTATION_TOL_RAD = 1e-8
OWN_START_ORIENTATION_TOL_RAD = 1e-6
POSITION_TOL_REL = 1e-8
NONLINEAR_POSITION_TOL_REL = 1e-6
GT_RATIO, GT_SLACK = 1.25, 1e-4


def _jax_start(shape):
    """The JAX package's random start: `jax.random.normal(PRNGKey(0))`."""
    return T(np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64)))


def _rel(a, b):
    """Largest row distance of a from b over the median distance of b's
    rows from their centroid."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.median(np.linalg.norm(b - b.mean(0), axis=-1)))


# ---------------------------------------------------------- rotations


@pytest.fixture(scope="module")
def rotation_scene():
    """`TestLinearNonlinearRotation`'s graph: 20 views, 60 edges, 0.3 deg."""
    gt_aa, _, graph = make_scene(20, 60, 0.3, 0.01, np.random.default_rng(42))
    want = {k: jrot.estimate_rotations(graph, k) for k in (1, 2, 3, 4)}
    return gt_aa, graph, want


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_estimate_rotations_every_type_matches_jax(rotation_scene, kind):
    """NONLINEAR starts from the MST with view 0 fixed in both packages;
    LINEAR, LAGRANGE_DUAL and HYBRID draw their starts apart and are aligned
    to the MST start in both."""
    gt_aa, graph, want = rotation_scene
    got = trot.estimate_rotations(convert.view_graph(graph), kind, device="cpu")
    tol = ORIENTATION_TOL_RAD if kind == 1 else OWN_START_ORIENTATION_TOL_RAD
    assert rotation_angle_diff(got, want[kind]) <= tol
    assert rotation_error_deg(gt_aa, got) < 2.0


def test_linear_rotation_averaging_with_the_jax_start(rotation_scene):
    _, graph, _ = rotation_scene
    v1, v2, rel, _, w = graph.edge_arrays()  # view ids are 0..19
    want = np.asarray(jrot.linear_rotation_averaging(
        jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(rel), jnp.asarray(w), 20))
    got = trot.linear_rotation_averaging(T(v1).long(), T(v2).long(), T(rel), T(w), 20,
                                         start=_jax_start((20, 3, 3)))
    rel_R = trot.rotops.angle_axis_to_rotation_matrix(got) @ (
        trot.rotops.angle_axis_to_rotation_matrix(T(want)).mT)
    assert float(torch.linalg.norm(trot.rotops.rotation_matrix_to_angle_axis(rel_R), dim=-1)
                 .max()) <= ORIENTATION_TOL_RAD


def test_nonlinear_rotations_from_segment_sums(rotation_scene, monkeypatch):
    """Above `_DENSE_INCIDENCE_MAX` entries NONLINEAR applies the incidence
    by gathers and segment sums: the same operator as the dense matrix."""
    _, graph, want = rotation_scene
    monkeypatch.setattr(trot, "_DENSE_INCIDENCE_MAX", 0)
    got = trot.estimate_rotations(convert.view_graph(graph), 1, device="cpu")
    assert rotation_angle_diff(got, want[1]) <= ORIENTATION_TOL_RAD


# ---------------------------------------------------------- positions


@pytest.fixture(scope="module")
def position_scene():
    """`TestPositionEstimation.test_linear`'s scene: 15 views, 60 edges,
    exact rotations, 0.01 direction noise."""
    gt_aa, gt_pos, graph = make_scene(15, 60, 0.0, 0.01, np.random.default_rng(42))
    orient = {i: gt_aa[i] for i in range(15)}
    want = {k: jpos.estimate_positions(graph, orient, k) for k in (0, 1, 2, 3, 4)}
    return gt_pos, graph, orient, want


@pytest.mark.parametrize("kind", [0, 1, 3, 4])
def test_estimate_positions_every_type_matches_jax(position_scene, kind):
    """NONLINEAR (LUD start, √weights), LINEAR_TRIPLET, LIGT (which runs LUD
    in both packages) and BATA through the entry."""
    gt_pos, graph, orient, want = position_scene
    tg = convert.view_graph(graph)
    got = tpos.estimate_positions(tg, orient, kind, device="cpu")
    scale = np.linalg.norm(gt_pos - gt_pos.mean(0), axis=-1).mean()
    if kind == 0:
        assert position_diff_rel(got, want[0]) <= NONLINEAR_POSITION_TOL_REL
    elif kind == 1:
        # Another random start: the JAX test's bar, as JAX's own run meets it.
        assert position_error(gt_pos, want[1]) < 0.1 * scale
        assert position_error(gt_pos, got) < 0.1 * scale
    elif kind == 3:
        assert position_diff_rel(got, want[3]) <= POSITION_TOL_REL
        lud = tpos.estimate_positions(tg, orient, 2, device="cpu")
        assert all(np.array_equal(got[v], lud[v]) for v in lud)
    else:
        err, want_err = position_error(gt_pos, got), position_error(gt_pos, want[4])
        assert err <= GT_RATIO * want_err + GT_SLACK * scale
    assert set(got) == set(want[kind])


def _bata_scene():
    """`test_bata_positions`' scene: 12 views, exact directions."""
    rng = np.random.default_rng(46)
    V = 12
    centers = rng.uniform(-3, 3, (V, 3))
    ei, ej = [], []
    for j in range(1, V):
        ei.append(rng.integers(0, j))
        ej.append(j)
    for _ in range(3 * V):
        a, b = rng.integers(0, V, 2)
        if a != b:
            ei.append(min(a, b))
            ej.append(max(a, b))
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)
    t = centers[ej] - centers[ei]
    return centers, ei, ej, t / np.linalg.norm(t, axis=1, keepdims=True)


# The scales of the JAX BATA run's input directions: 1 and three 1e-15
# perturbations, which move its error against ground truth over 4e-5 to 1e-3.
BATA_SCALES = (1.0, 1.0 + 1e-15, 1.0 + 2e-15, 1.0 + 3e-15)


@pytest.fixture(scope="module")
def bata_scene():
    centers, ei, ej, t = _bata_scene()
    free = np.ones(12, bool)

    def run(scale, n):
        return np.asarray(jpos.bata_positions(jnp.asarray(ei), jnp.asarray(ej),
                                              jnp.asarray(t * scale), jnp.asarray(free), 12,
                                              outer_iters=n))

    spread = [_sim3_position_error(centers, run(s, 100)) for s in BATA_SCALES]
    return centers, (T(ei).long(), T(ej).long(), T(t), T(free), 12), run(1.0, 2), spread


def test_bata_positions_match_jax(bata_scene):
    """Two rounds at 1e-7; the default run by the JAX test's bar and within
    1.25x the largest error of the JAX run under its own rounding spread."""
    centers, args, want_two, spread = bata_scene
    assert _rel(tpos.bata_positions(*args, outer_iters=2), want_two) <= 1e-7
    err = _sim3_position_error(centers, tpos.bata_positions(*args).numpy())
    assert err < 1e-2  # the JAX test's bar
    assert err <= GT_RATIO * max(spread)


def test_linear_triplet_positions_with_the_jax_start():
    centers, ei, ej, t = _bata_scene()
    w = np.arange(len(ei)) % 5 + 1.0
    want = np.asarray(jpos.linear_triplet_positions(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(t), jnp.asarray(w), 12))
    got = tpos.linear_triplet_positions(T(ei).long(), T(ej).long(), T(t), T(w), 12,
                                        start=_jax_start((12, 3)))
    assert _rel(got, want) <= POSITION_TOL_REL


def test_nonlinear_positions_match_jax():
    """From a perturbed start, view 0 fixed, weights 1-5 (square-rooted as
    the entry passes them)."""
    centers, ei, ej, t = _bata_scene()
    sw = np.sqrt(np.arange(len(ei)) % 5 + 1.0)
    init = centers + np.random.default_rng(3).normal(size=centers.shape) * 0.3
    free = np.ones(12, bool)
    free[0] = False
    want = np.asarray(jpos.nonlinear_positions(
        jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(t), jnp.asarray(sw),
        jnp.asarray(free), 12))
    got = tpos.nonlinear_positions(T(init), T(ei).long(), T(ej).long(), T(t), T(sw), T(free), 12)
    assert _rel(got, want) <= NONLINEAR_POSITION_TOL_REL
    np.testing.assert_array_equal(got[0].numpy(), init[0])
    assert _sim3_position_error(centers, got.numpy()) < 1e-6


def _ligt_scene():
    """`test_ligt_positions`' scene: 8 views, 60 tracks of 4 exact bearings."""
    rng = np.random.default_rng(45)
    V, n_tracks = 8, 60
    centers = rng.uniform(-2, 2, (V, 3))
    aa = _rand_aa(rng, V, 0.4)
    R = _aa_to_R(aa)
    pts = rng.uniform(-3, 3, (n_tracks, 3)) + np.array([0, 0, 10.0])
    obs_view, obs_track, bearings = [], [], []
    for t in range(n_tracks):
        for v in rng.choice(V, size=4, replace=False):
            b = R[v] @ (pts[t] - centers[v])
            bearings.append(b / np.linalg.norm(b))
            obs_view.append(v)
            obs_track.append(t)
    return (centers, np.asarray(obs_view, np.int32), np.asarray(obs_track, np.int32),
            np.asarray(bearings), aa)


def test_ligt_positions_match_jax():
    centers, ov, ot, b, aa = _ligt_scene()
    jargs = (jnp.asarray(ov), jnp.asarray(ot), jnp.asarray(b), jnp.asarray(aa), 8, 60)
    targs = (T(ov).long(), T(ot).long(), T(b), T(aa), 8, 60)
    want = np.asarray(jpos.ligt_positions(*jargs, power_iterations=20))
    got = tpos.ligt_positions(*targs, power_iterations=20, start=_jax_start((8, 3)))
    assert _rel(got, want) <= POSITION_TOL_REL
    got = tpos.ligt_positions(*targs).numpy()
    assert _sim3_position_error(centers, got) < 1e-3  # the JAX test's bar


# ---------------------------------------------------------- filters


def test_cycle_filter_matches_jax():
    """`TestFilters.test_cycle_filter`'s graph: 12 views, 50 edges, 10%
    outliers."""
    _, _, graph = make_scene(12, 50, 0.1, 0.01, np.random.default_rng(42),
                             outlier_fraction=0.1)
    tg = convert.view_graph(graph)
    want = jfilters.filter_view_graph_cycles_by_rotation(graph, 3.0)
    got = tfilters.filter_view_graph_cycles_by_rotation(tg, 3.0, device="cpu")
    assert got == want > 0
    assert set(tg.edges) == set(graph.edges)


def _ring(num_views, dangling):
    """The ring of `test_extract_maximally_parallel_rigid_subgraph`, with
    two views hung on view 0 by one edge each if `dangling`."""
    recon, ext, _ = generate_scene(SyntheticSceneOptions(num_views=num_views))
    vg = add_view_graph_edges(recon, ext, min_shared_tracks=10)
    orientations = {v: ext[v, 3:].copy() for v in vg.view_ids()}
    if dangling:
        info = TwoViewInfo(rotation_2=np.zeros(3), position_2=np.array([1.0, 0.0, 0.0]))
        vg.add_edge(0, 100, info)
        vg.add_edge(100, 101, info)
        orientations[100] = np.zeros(3)
        orientations[101] = np.zeros(3)
    return vg, orientations


@pytest.mark.parametrize("num_views,dangling", [(9, False), (9, True), (10, True)])
def test_rigid_subgraph_matches_jax(num_views, dangling, monkeypatch):
    """The same views removed as the JAX filter, the same graph left; the
    10-view ring is even (antipodal views coincide in one dimension, a
    degeneracy of the test in the reference too) and loses one of its own
    views in both. The membership scan in chunks of one fixed view gives
    the same result."""
    vg, orientations = _ring(num_views, dangling)
    tg = convert.view_graph(vg)
    want = jfilters.extract_maximally_parallel_rigid_subgraph(dict(orientations), vg)
    got = tfilters.extract_maximally_parallel_rigid_subgraph(dict(orientations), tg,
                                                             device="cpu")
    assert got == want
    assert set(tg.edges) == set(vg.edges) and set(tg.view_ids()) == set(vg.view_ids())
    if dangling:
        assert not tg.has_view(100) and not tg.has_view(101)
    monkeypatch.setattr(tfilters, "_PARALLEL_CHUNK_ENTRIES", 1)
    tg = convert.view_graph(_ring(num_views, dangling)[0])
    assert tfilters.extract_maximally_parallel_rigid_subgraph(
        dict(orientations), tg, device="cpu") == want


def test_rigid_subgraph_of_fewer_constraints_than_unknowns():
    """A chain of three views (two edges: 6 rows, 9 unknowns): the null
    space comes from the padded matrix, as from the JAX package's full SVD."""
    vg, orientations = _ring(9, False)
    chain = copy.deepcopy(vg)
    for key in list(chain.edges):
        if key not in ((0, 1), (1, 2)):
            chain.remove_edge(*key)
    tg = convert.view_graph(chain)
    want = jfilters.extract_maximally_parallel_rigid_subgraph(dict(orientations), chain)
    got = tfilters.extract_maximally_parallel_rigid_subgraph(dict(orientations), tg,
                                                             device="cpu")
    assert got == want
    assert set(tg.view_ids()) == set(chain.view_ids())


# ---------------------------------------------------------- triplet baseline


@pytest.mark.parametrize("case", ["exact", "noisy", "degenerate"])
def test_triplet_baseline_ratios_match_jax(case):
    """The cases of `tests/test_triplet_baseline.py` (`rng` seed 42)."""
    rng = np.random.default_rng(42)
    if case == "exact":
        infos, feats = _triplet(rng, c2=(1.0, 0.0, 0.0), c3=(3.0, 0.3, 0.0))
    elif case == "noisy":
        infos, feats = _triplet(rng, c2=(0.8, 0.1, 0.0), c3=(2.0, -0.2, 0.1), noise=5e-4)
    else:
        infos, feats = _triplet(rng, c2=(1.0, 0, 0), c3=(2.0, 0, 0), n=16)
        feats = [np.zeros_like(feats[0])] * 3
    mask = np.ones(len(feats[0]), bool)
    mask[::7] = False
    want_b, want_n = jbaseline(*(jnp.asarray(a) for a in infos),
                               *(jnp.asarray(f) for f in feats), jnp.asarray(mask))
    got_b, got_n = tbaseline(*(T(a) for a in infos), *(T(f) for f in feats), T(mask))
    assert int(got_n) == int(want_n)
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() <= 1e-10
    if case == "degenerate":
        assert int(got_n) == 0 and float(got_b[1]) == 0.0
    else:
        assert int(got_n) > 40
