"""The port's global-pose functions, each against the JAX function on the
same inputs (the JAX run's own state before that stage), on the small
synthetic scene, clean and with 15% of its edges corrupted in rotation and
direction (`tools.global_pose.contaminate`). CPU, f64.

In the pipeline the orientation filter takes every corrupted edge, and the
pairwise refinement (step 5) rewrites every direction from the shared
tracks, so the 1DSfM filter meets no outlier there and removes nothing, in
both packages. Its test therefore also corrupts the directions of 15% of the
edges of its input graph (directions only) and holds the two packages'
removed sets equal on that.

Bars: orientations within 1e-8 rad; pairwise directions with 1 - |cos| <=
1e-10 and `ok` flags equal; positions within 1e-8 x the median distance of
the positions from their centroid; removed edge sets equal.

The scene, the JAX reference run (`jax_steps`: steps 1-7 of the JAX
estimator's `estimate`, `pytheiasfm_tpu/sfm/global_estimator.py:67-166`,
with its own methods and functions in the same order, keeping each stage's
inputs and outputs) and the comparisons are defined here and shared with
`test_torch_global_pose_pipeline.py`.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.global_pose import filters as jfilters
from pytheiasfm_tpu.global_pose import position_estimator as jpos
from pytheiasfm_tpu.global_pose import rotation_estimator as jrot
from pytheiasfm_tpu.ops import rotation as jrotops
from pytheiasfm_tpu.sfm import global_estimator as jge
from pytheiasfm_tpu.sfm.estimator_options import ReconstructionEstimatorOptions
from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JaxPrior
from pytheiasfm_tpu.sfm.reconstruction import Reconstruction as JaxReconstruction
from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo as JaxTwoViewInfo
from pytheiasfm_tpu.sfm.view_graph import ViewGraph as JaxViewGraph
from pytheiasfm_tpu.transforms import alignment as jalign
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.global_pose import filters as tfilters
from pytheiasfm_tpu_torch.global_pose import position_estimator as tpos
from pytheiasfm_tpu_torch.global_pose import rotation_estimator as trot
from pytheiasfm_tpu_torch.global_pose.pairwise_translation import (
    optimize_relative_positions_with_known_rotations,
)
from pytheiasfm_tpu_torch.ops import rotation as rotops
from pytheiasfm_tpu_torch.ops import triangulation as tri
from pytheiasfm_tpu_torch.ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from pytheiasfm_tpu_torch.pipelines import synthetic_global as tsg
from pytheiasfm_tpu_torch.sfm import global_estimator as tge
from pytheiasfm_tpu_torch.sfm.global_estimator import GlobalReconstructionEstimator
from pytheiasfm_tpu_torch.tools.global_pose import contaminate
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

SMALL = dict(V=48, T=4000, neighborhood=6)

# Parity bars (f64 on both sides; the solvers run the same fixed-step
# iterations and differ only in the order of sums).
ORIENTATION_TOL_RAD = 1e-8
DIRECTION_TOL = 1e-10  # 1 - |cos| between refined pairwise directions
POSITION_TOL_REL = 1e-8  # times the median distance of the positions from their centroid


def to_jax(recon, graph):
    """The JAX package's `Reconstruction` and `ViewGraph` holding copies of a
    port scene's fields (the inverse of `pytheiasfm_tpu_torch.convert`)."""
    out = JaxReconstruction(recon.dtype)
    for name, value in vars(recon).items():
        if name == "view_priors":
            value = [JaxPrior(**dataclasses.asdict(p)) for p in value]
        setattr(out, name, copy.deepcopy(value))
    g = JaxViewGraph()
    for (a, b), info in graph.edges.items():
        g.add_edge(a, b, JaxTwoViewInfo(**copy.deepcopy(dataclasses.asdict(info))))
    return out, g


def scene(kind, **size):
    """(JAX recon, JAX view graph, gt positions, gt angle-axis, corrupted
    edge keys) for `kind` in {"clean", "contaminated"}: the port's
    `build_scene` (held equal to the JAX one by
    `test_torch_synthetic_scene.py`) carried into the JAX containers, then
    contaminated by `tools.global_pose.contaminate` (15% of the edges)."""
    size = size or SMALL
    recon, graph, gt_positions = tsg.build_scene(**size)
    _, _, gt_aa = tsg._look_at_ring(size["V"], np.random.default_rng(size.get("seed", 0)))
    recon, graph = to_jax(recon, graph)
    bad = contaminate(graph) if kind == "contaminated" else set()
    return recon, graph, gt_positions, np.asarray(gt_aa), bad


def jax_options(options):
    """The JAX package's `ReconstructionEstimatorOptions` with a port options
    object's estimator types, rigid-subgraph switch and seed."""
    return ReconstructionEstimatorOptions(
        global_rotation_estimator_type=int(options.global_rotation_estimator_type),
        global_position_estimator_type=int(options.global_position_estimator_type),
        extract_maximal_rigid_subgraph=options.extract_maximal_rigid_subgraph,
        rng_seed=options.rng_seed,
    )


def jax_steps(recon, graph, options=None):
    """Steps 1-7 of the JAX estimator in `estimate`'s order, on copies.
    Returns a dict of each stage's graph (a copy after the stage), the
    orientations and positions, the removed edge sets, and the inputs and
    outputs of `optimize_relative_positions_with_known_rotations`."""
    opt = options or ReconstructionEstimatorOptions()
    est = jge.GlobalReconstructionEstimator(opt)
    recon = copy.deepcopy(recon)
    g = copy.deepcopy(graph)
    out = {}
    assert est._filter_initial_view_graph(g, recon)
    out["graph_initial"] = copy.deepcopy(g)
    recon.set_camera_intrinsics_from_priors()
    out["recon"] = copy.deepcopy(recon)
    out["mst"] = jrot.orientations_from_maximum_spanning_tree(g)
    orientations = jrot.estimate_rotations(g, int(opt.global_rotation_estimator_type))
    out["rotations"] = dict(orientations)

    before = set(g.edges)
    jfilters.filter_view_pairs_from_orientation(
        g, orientations, opt.rotation_filtering_max_difference_degrees
    )
    out["removed_orientation"] = before - set(g.edges)
    if opt.extract_maximal_rigid_subgraph:
        out["rigid_removed_views"] = jfilters.extract_maximally_parallel_rigid_subgraph(
            orientations, g)
        for v in list(orientations):
            if not g.has_view(v):
                orientations.pop(v)
    for v in g.remove_disconnected_view_pairs():
        orientations.pop(v, None)
    out["graph_orientation"] = copy.deepcopy(g)
    out["orientations_after_filter"] = dict(orientations)

    recorded = {}
    real = jge.optimize_relative_positions_with_known_rotations

    def record(*args):
        recorded["inputs"] = [np.asarray(a) for a in args]
        result = real(*args)
        recorded["outputs"] = [np.asarray(a) for a in result]
        return result

    jge.optimize_relative_positions_with_known_rotations = record
    try:
        est._optimize_pairwise_translations(g, orientations, recon)
    finally:
        jge.optimize_relative_positions_with_known_rotations = real
    out["pairwise"] = recorded
    out["graph_pairwise"] = copy.deepcopy(g)

    before = set(g.edges)
    jfilters.filter_view_pairs_from_relative_translation(
        g, orientations,
        num_iterations=opt.translation_filtering_num_iterations,
        translation_projection_tolerance=opt.translation_filtering_projection_tolerance,
        rng=np.random.default_rng(opt.rng_seed),
    )
    out["removed_1dsfm"] = before - set(g.edges)
    for v in g.remove_disconnected_view_pairs():
        orientations.pop(v, None)
    out["graph_1dsfm"] = copy.deepcopy(g)
    out["orientations"] = dict(orientations)
    out["positions"] = jpos.estimate_positions(
        g, orientations, int(opt.global_position_estimator_type)
    )
    return out


def jax_ground_truth_errors(orientations, positions, gt_aa, gt_positions):
    """The JAX package's own measure of a result: median rotation error in
    degrees after `align_orientations`, median position error after its
    Umeyama alignment."""
    import jax
    import jax.numpy as jnp

    ids = sorted(v for v in orientations if v in positions)
    gt = jnp.asarray(gt_aa[ids])
    aligned = jrotops.align_orientations(gt, jnp.asarray(np.stack([orientations[v] for v in ids])))
    R = jax.vmap(jrotops.angle_axis_to_rotation_matrix)
    loop = jnp.einsum("nij,nkj->nik", R(aligned), R(gt))
    rot_err = np.degrees(np.linalg.norm(
        np.asarray(jax.vmap(jrotops.rotation_matrix_to_angle_axis)(loop)), axis=-1
    ))
    est = jnp.asarray(np.stack([positions[v] for v in ids]))
    Ra, ta, s = jalign.align_point_clouds_umeyama(est, jnp.asarray(gt_positions[ids]))
    aligned_pos = np.asarray(jalign.sim3_transform_points(est, Ra, ta, s))
    pos_err = np.linalg.norm(aligned_pos - gt_positions[ids], axis=-1)
    return float(np.median(rot_err)), float(np.median(pos_err))


def rotation_angle_diff(a: dict, b: dict) -> float:
    """Largest angle (rad) between the rotations of two orientation dicts
    over the same views."""
    assert set(a) == set(b)
    ids = sorted(a)
    Ra = angle_axis_to_rotation_matrix_np(np.stack([a[v] for v in ids]))
    Rb = angle_axis_to_rotation_matrix_np(np.stack([b[v] for v in ids]))
    return float(np.max(np.linalg.norm(rotation_matrix_to_angle_axis_np(Ra @ Rb.transpose(0, 2, 1)), axis=-1)))


def position_diff_rel(a: dict, b: dict) -> float:
    """Largest position difference over the median distance of `b`'s
    positions from their centroid."""
    assert set(a) == set(b)
    ids = sorted(a)
    pa = np.stack([a[v] for v in ids])
    pb = np.stack([b[v] for v in ids])
    radius = np.median(np.linalg.norm(pb - pb.mean(0), axis=-1))
    return float(np.max(np.linalg.norm(pa - pb, axis=-1)) / radius)


KINDS = ["clean", "contaminated"]


@pytest.fixture(scope="module", params=KINDS)
def ref(request):
    recon, graph, gt_positions, gt_aa, bad = scene(request.param)
    out = jax_steps(recon, graph)
    out["kind"], out["bad"] = request.param, bad
    return out


def test_maximum_spanning_tree_orientations(ref):
    got = trot.orientations_from_maximum_spanning_tree(convert.view_graph(ref["graph_initial"]))
    assert rotation_angle_diff(got, ref["mst"]) <= ORIENTATION_TOL_RAD


def test_estimate_rotations(ref):
    got = trot.estimate_rotations(convert.view_graph(ref["graph_initial"]), device="cpu")
    assert rotation_angle_diff(got, ref["rotations"]) <= ORIENTATION_TOL_RAD


def test_rotation_operator_from_segment_sums(ref, monkeypatch):
    """Above `_DENSE_INCIDENCE_MAX` entries the Laplacian and A, Aᵀ come from
    segment sums: the same operator as the dense incidence matrix (a short
    run of each; the default run is held to the JAX package above)."""
    g = convert.view_graph(ref["graph_initial"])
    short = trot.RobustRotationEstimatorOptions(
        max_num_l1_iterations=2, max_num_irls_iterations=3, cg_iterations=20,
        admm_iterations=10,
    )
    dense = trot.estimate_rotations(g, options=short, device="cpu")
    monkeypatch.setattr(trot, "_DENSE_INCIDENCE_MAX", 0)
    sparse = trot.estimate_rotations(g, options=short, device="cpu")
    assert rotation_angle_diff(sparse, dense) <= ORIENTATION_TOL_RAD


def test_orientation_filter(ref):
    g = convert.view_graph(ref["graph_initial"])
    before = set(g.edges)
    n = tfilters.filter_view_pairs_from_orientation(g, ref["rotations"], 5.0, device="cpu")
    removed = before - set(g.edges)
    assert removed == ref["removed_orientation"] and n == len(removed)
    if ref["kind"] == "contaminated":
        # The filter catches corrupted rotations, and nothing else.
        assert removed == ref["bad"]
    else:
        assert not removed


def test_pairwise_translations(ref):
    """The function on the JAX estimator's own gathered inputs, then the
    estimator step (gather + function) on the same graph."""
    inputs, (want_t, want_ok) = ref["pairwise"]["inputs"], ref["pairwise"]["outputs"]
    t, ok = optimize_relative_positions_with_known_rotations(
        *(torch.as_tensor(a) for a in inputs)
    )
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    cos = np.sum(t.numpy() * want_t, axis=-1)
    assert np.max(1.0 - np.abs(cos)) <= DIRECTION_TOL
    # Signs agree too (both take the same cheirality vote).
    assert np.all(cos > 0)

    g = convert.view_graph(ref["graph_orientation"])
    GlobalReconstructionEstimator(device="cpu")._optimize_pairwise_translations(
        g, ref["orientations_after_filter"], convert.reconstruction(ref["recon"])
    )
    want = ref["graph_pairwise"]
    assert set(g.edges) == set(want.edges)
    cos = np.array([
        np.dot(g.edges[k].position_2, want.edges[k].position_2) for k in want.edges
    ])
    assert np.max(1.0 - cos) <= DIRECTION_TOL


def test_pairwise_translations_where_no_sign_has_a_majority(ref, monkeypatch):
    """Step 5 from wrong orientations (random draws), as after a rotation
    estimator that failed: the same line for every edge in both packages,
    and the same sign wherever one sign puts a majority of the shared
    points in front of both cameras. Where neither does, the vote of both
    packages keeps the eigenvector's sign or flips it by the count for that
    sign, and the eigenvector's sign is the eigen-solver's: LAPACK's in
    JAX, PyTorch's, cuSOLVER's on the card, so the sign may differ there."""
    rng = np.random.default_rng(5)
    orientations = {v: rng.normal(size=3) for v in ref["orientations_after_filter"]}
    want = copy.deepcopy(ref["graph_orientation"])
    jge.GlobalReconstructionEstimator(ReconstructionEstimatorOptions())\
        ._optimize_pairwise_translations(want, dict(orientations), copy.deepcopy(ref["recon"]))
    seen = {}

    def keep(*args):
        seen["args"], seen["out"] = args, optimize_relative_positions_with_known_rotations(*args)
        return seen["out"]

    monkeypatch.setattr(tge, "optimize_relative_positions_with_known_rotations", keep)
    g = convert.view_graph(ref["graph_orientation"])
    GlobalReconstructionEstimator(device="cpu")._optimize_pairwise_translations(
        g, dict(orientations), convert.reconstruction(ref["recon"]))
    rot1, rot2, x1, x2, mask, _ = seen["args"]
    t, ok = seen["out"]
    assert ok.all()
    R_rel = rotops.angle_axis_to_rotation_matrix(rot2) @ rotops.angle_axis_to_rotation_matrix(
        rot1).mT
    half = mask.sum(-1) // 2
    majority = torch.zeros_like(half, dtype=torch.bool)
    for sign in (1.0, -1.0):
        front = tri.is_triangulated_point_in_front_of_cameras(
            x1, x2, R_rel[:, None], sign * t[:, None])
        majority |= (front & mask).sum(-1) > half
    cos = np.array([np.dot(g.edges[k].position_2, want.edges[k].position_2) for k in g.edges])
    assert np.max(1.0 - np.abs(cos)) <= DIRECTION_TOL
    assert np.all(cos[majority.numpy()] > 0)
    assert not majority.all()  # the case this test is about occurs


def _one_dsfm(filter_fn, g, orientations, **kw):
    before = set(g.edges)
    n = filter_fn(g, orientations, num_iterations=48, translation_projection_tolerance=0.1,
                  rng=np.random.default_rng(0), **kw)
    removed = before - set(g.edges)
    assert n == len(removed)
    return removed


def test_relative_translation_filter(ref):
    orientations = ref["orientations_after_filter"]
    removed = _one_dsfm(tfilters.filter_view_pairs_from_relative_translation,
                        convert.view_graph(ref["graph_pairwise"]), orientations, device="cpu")
    assert removed == ref["removed_1dsfm"] == set()
    # The same filter on directions corrupted after step 5.
    jg = copy.deepcopy(ref["graph_pairwise"])
    bad = contaminate(jg, rotations=False)
    removed = _one_dsfm(tfilters.filter_view_pairs_from_relative_translation,
                        convert.view_graph(jg), orientations, device="cpu")
    assert removed == _one_dsfm(jfilters.filter_view_pairs_from_relative_translation,
                                jg, orientations)
    # The filter has outliers to act on here; how many it catches is the
    # JAX package's own result, held above, not a bar of this test.
    assert removed & bad


def test_estimate_positions(ref):
    got = tpos.estimate_positions(
        convert.view_graph(ref["graph_1dsfm"]), ref["orientations"], device="cpu"
    )
    assert position_diff_rel(got, ref["positions"]) <= POSITION_TOL_REL


def test_contaminate_corrupts_its_fixed_share_the_same_on_both_packages():
    """`contaminate` turns 15% of the edges, picked by `default_rng(1)`,
    by 15-180 degrees and gives them random unit directions; the same
    edges and values on the port's view graph and the JAX package's."""
    jrecon, jg, _, _, _ = scene("clean")
    tg = convert.view_graph(jg)
    clean = copy.deepcopy(jg)
    bad = contaminate(jg)
    assert contaminate(tg) == bad
    assert len(bad) == round(0.15 * clean.num_edges())
    for k, info in jg.edges.items():
        mine = tg.edges[k]
        np.testing.assert_array_equal(mine.rotation_2, info.rotation_2)
        np.testing.assert_array_equal(mine.position_2, info.position_2)
        if k not in bad:
            np.testing.assert_array_equal(info.rotation_2, clean.edges[k].rotation_2)
            continue
        turn = angle_axis_to_rotation_matrix_np(info.rotation_2) @ (
            angle_axis_to_rotation_matrix_np(clean.edges[k].rotation_2).T)
        angle = np.rad2deg(np.linalg.norm(rotation_matrix_to_angle_axis_np(turn)))
        assert 15.0 - 1e-9 <= angle <= 180.0 + 1e-9
        assert abs(np.linalg.norm(info.position_2) - 1.0) <= 1e-12


def test_unported_variants_raise():
    """No variant is left unported: a device mesh runs (a 1-rank mesh here,
    on one device's trajectory; 4 ranks in `test_torch_mesh_sfm.py`), and
    every estimator type runs (each held to the JAX package in
    `test_torch_global_pose_estimators.py`)."""
    from torch_mesh_cases import one_rank_mesh

    g = convert.view_graph(scene("clean", V=12, T=600, neighborhood=3)[1])
    orientations = trot.estimate_rotations(g, device="cpu")
    positions = tpos.estimate_positions(g, orientations, device="cpu")
    with one_rank_mesh() as mesh:
        on_mesh = trot.estimate_rotations(g, mesh=mesh, device="cpu")
        on_mesh_pos = tpos.estimate_positions(g, orientations, mesh=mesh, device="cpu")
    for v in orientations:
        np.testing.assert_allclose(on_mesh[v], orientations[v], rtol=0, atol=1e-12)
        np.testing.assert_allclose(on_mesh_pos[v], positions[v], rtol=0, atol=1e-12)
    for kind in (1, 2, 3, 4):
        assert set(trot.estimate_rotations(g, kind, device="cpu")) == set(g.view_ids())
    for kind in (0, 1, 3, 4):
        assert set(tpos.estimate_positions(g, orientations, kind, device="cpu")) == set(
            g.view_ids())
