"""The port's Sim(3) alignment and pose graph
(`pytheiasfm_tpu_torch/transforms/pose_graph_sim3.py`) against the JAX
package's, on the CPU in f64.

`optimize_alignment_sim3` under all three alignment types and
`optimize_sim3_pose_graph` with a fixed node (exact and noisy edges, with
and without sqrt-information; the problem builder of `tools.file_scene`)
match the JAX functions at 1e-8 (a cost at rounding level, where the edges
are exact, to 1e-20 absolute); `find_common_tracks_by_feature_in_reconstructions`
gives the same correspondences; the tests of `tests/test_aux_parity.py`
(alignment, pose graph, `align_overlap_reconstructions_with_points_and_poses_robust`)
hold on the port with their bars.

The JAX functions take 2-15 s each to trace here, so their outputs on these
inputs are recorded in `tests/data/torch_pose_graph_sim3_jax.npz` by
`JAX_PLATFORMS=cpu python tests/torch_io_reference.py record`, and the
`slow` test `test_record_is_the_jax_package_s` computes them again.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytheiasfm_tpu import transforms as jt
from pytheiasfm_tpu.utils.synthetic import random_reconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch import transforms as tt
from pytheiasfm_tpu_torch.ops import lie
from pytheiasfm_tpu_torch.tools import file_scene
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-8
CPU = "cpu"


def _random_sim3(rng, scale=1.7):
    """`tests/test_aux_parity.py::_random_sim3` with the port's Lie group."""
    xi = np.concatenate([rng.normal(size=3) * 2.0, rng.normal(size=3) * 0.4, [np.log(scale)]])
    s, R, t = lie.sim3_exp(torch.tensor(xi))
    return xi, float(s), R.numpy(), t.numpy()


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b))), np.max(np.abs(a - b))


KINDS = ("POINT_TO_POINT", "ROBUST_POINT_TO_POINT", "POINT_TO_PLANE")
RECORD = Path(__file__).resolve().parent / "data" / "torch_pose_graph_sim3_jax.npz"


def _alignment_inputs():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(80, 3))
    _, s, R, t = _random_sim3(rng, scale=0.8)
    tgt = s * src @ R.T + t
    tgt[:8] += rng.normal(size=(8, 3)) * 5.0  # 10% outliers
    normals = rng.normal(size=(80, 3))
    return src, tgt, normals / np.linalg.norm(normals, axis=1, keepdims=True)


def _alignment_options(module, kind, normals):
    return module.Sim3AlignmentOptions(alignment_type=module.Sim3AlignmentType[kind],
                                       huber_threshold=0.05, max_iterations=30,
                                       target_normals=normals)


def _pose_graph_inputs(noisy):
    """`tests/test_aux_parity.py::test_optimize_sim3_pose_graph`'s graph; with
    `noisy`, edge noise of 1e-2 and diagonal sqrt-information on the self
    edges, and a second cross edge."""
    rng = np.random.default_rng(5)
    N = 6
    gt = np.stack([_random_sim3(rng, scale=float(np.exp(rng.normal() * 0.2)))[0]
                   for _ in range(N)])
    S = [lie.sim3_exp(torch.tensor(g)) for g in gt]
    pairs = [(i, i + 1) for i in range(N - 1)] + [(0, N - 1), (1, 4)]
    self_edges = [(i, j, lie.sim3_log(*lie.sim3_multiply(*lie.sim3_inverse(*S[i]), *S[j])).numpy())
                  for i, j in pairs]
    cross_edges = [(0, gt[0])]
    if noisy:
        self_edges = [(i, j, e + rng.normal(size=7) * 1e-2, np.diag(rng.uniform(0.5, 2, 7)))
                      for i, j, e in self_edges]
        cross_edges.append((3, gt[3] + rng.normal(size=7) * 1e-2, np.eye(7) * 2.0))
    init = gt + rng.normal(size=gt.shape) * 0.05
    init[0] = gt[0]
    return gt, S, init, self_edges, cross_edges


def _graph_cases():
    """name -> (nodes, self edges, cross edges, fixed nodes, iterations):
    exact and noisy edges, no cross edges (the placeholder), and
    `tools.file_scene.pose_graph_problem` on a 24-view scene."""
    out = {}
    for noisy in (False, True):
        _, _, init, self_edges, cross_edges = _pose_graph_inputs(noisy)
        out["noisy" if noisy else "exact"] = (init, self_edges, cross_edges, [0], 30)
    out["defaults"] = (out["exact"][0], out["exact"][1], (), [0], 30)
    _, gt, graph = file_scene.scene(V=24, T=1500)
    init, self_edges, cross_edges, fixed, _ = file_scene.pose_graph_problem(gt, graph)
    out["file_scene"] = (init, self_edges, cross_edges, fixed, 3)
    return out


def jax_outputs():
    """The JAX functions on every case of this module, with the inputs
    that identify them."""
    src, tgt, normals = _alignment_inputs()
    rec = {"align/src": src, "align/tgt": tgt}
    for kind in KINDS:
        s = jt.optimize_alignment_sim3(src, tgt, _alignment_options(jt, kind, normals))
        rec[f"align/{kind}/params"] = s.sim3_params
        rec[f"align/{kind}/scalars"] = np.array(
            [s.final_cost, s.alignment_error, s.success, s.num_iterations], np.float64)
    for name, (init, self_edges, cross_edges, fixed, iters) in _graph_cases().items():
        nodes, cost = jt.optimize_sim3_pose_graph(init, self_edges, cross_edges,
                                                  fixed_nodes=fixed, iters=iters)
        rec[f"graph/{name}/init"] = init
        rec[f"graph/{name}/nodes"] = nodes
        rec[f"graph/{name}/cost"] = np.float64(cost)
    return rec


def save_record(path=RECORD):
    np.savez_compressed(path, **jax_outputs())


@pytest.fixture(scope="module")
def record():
    with np.load(RECORD) as z:
        rec = dict(z)
    # The record was made on these very inputs.
    src, tgt, _ = _alignment_inputs()
    np.testing.assert_array_equal(rec["align/src"], src)
    np.testing.assert_array_equal(rec["align/tgt"], tgt)
    for name, case in _graph_cases().items():
        np.testing.assert_array_equal(rec[f"graph/{name}/init"], case[0])
    return rec


def _cost_close(cost, ref_cost):
    assert abs(cost - ref_cost) <= TOL * ref_cost + 1e-20, (cost, ref_cost)


@pytest.mark.parametrize("kind", KINDS)
def test_optimize_alignment_sim3_matches_jax(record, kind):
    src, tgt, normals = _alignment_inputs()
    got = tt.optimize_alignment_sim3(src, tgt, _alignment_options(tt, kind, normals), device=CPU)
    _close(got.sim3_params, record[f"align/{kind}/params"])
    cost, err, success, iters = record[f"align/{kind}/scalars"]
    assert got.success == bool(success) and got.num_iterations == int(iters)
    assert abs(got.final_cost - cost) <= TOL * max(1.0, cost)
    assert abs(got.alignment_error - err) <= TOL * max(1.0, err)


def test_optimize_alignment_sim3_point_to_point():
    """`tests/test_aux_parity.py::test_optimize_alignment_sim3_point_to_point`
    on the port, and from a given start."""
    rng = np.random.default_rng(3)
    src = rng.normal(size=(60, 3))
    xi, s, R, t = _random_sim3(rng)
    tgt = s * src @ R.T + t
    summary = tt.optimize_alignment_sim3(src, tgt, tt.Sim3AlignmentOptions(max_iterations=20),
                                         device=CPU)
    assert summary.success and summary.alignment_error < 1e-8
    start = tt.Sim3AlignmentOptions(initial_sim3_params=xi + 0.05, max_iterations=20)
    assert tt.optimize_alignment_sim3(src, tgt, start, device=CPU).alignment_error < 1e-8
    assert not tt.optimize_alignment_sim3(src[:2], tgt[:2], device=CPU).success


def test_optimize_alignment_sim3_robust_outliers():
    """`tests/test_aux_parity.py::test_optimize_alignment_sim3_robust_outliers`
    on the port."""
    src, tgt, _ = _alignment_inputs()
    summary = tt.optimize_alignment_sim3(src, tgt, tt.Sim3AlignmentOptions(
        alignment_type=tt.Sim3AlignmentType.ROBUST_POINT_TO_POINT, huber_threshold=0.05,
        max_iterations=30), device=CPU)
    assert summary.success
    s, R, t = lie.sim3_exp(torch.tensor(summary.sim3_params))
    aligned = float(s) * src[8:] @ R.numpy().T + t.numpy()
    assert np.max(np.linalg.norm(aligned - tgt[8:], axis=-1)) < 1e-3


@pytest.mark.parametrize("name", ["exact", "noisy", "defaults", "file_scene"])
def test_optimize_sim3_pose_graph_matches_jax(record, name):
    init, self_edges, cross_edges, fixed, iters = _graph_cases()[name]
    got, cost = tt.optimize_sim3_pose_graph(init, self_edges, cross_edges, fixed_nodes=fixed,
                                            iters=iters, device=CPU)
    _close(got, record[f"graph/{name}/nodes"])
    _cost_close(cost, float(record[f"graph/{name}/cost"]))
    np.testing.assert_array_equal(got[0], init[0])  # the fixed node


def test_optimize_sim3_pose_graph():
    """`tests/test_aux_parity.py::test_optimize_sim3_pose_graph` on the port,
    with its bars."""
    gt, S, init, self_edges, cross_edges = _pose_graph_inputs(False)
    out, cost = tt.optimize_sim3_pose_graph(init, self_edges, cross_edges, fixed_nodes=[0],
                                            iters=30, device=CPU)
    assert cost < 1e-10
    for i in range(len(gt)):
        err = lie.sim3_log(*lie.sim3_multiply(*lie.sim3_inverse(*lie.sim3_exp(
            torch.tensor(out[i]))), *S[i]))
        assert torch.linalg.norm(err) < 1e-4


def test_file_scene_pose_graph_reaches_ground_truth():
    """`tools.file_scene.pose_graph_problem` on a 24-view scene: 20 steps
    take the median node error below a quarter of the start's."""
    _, gt, graph = file_scene.scene(V=24, T=1500)
    init, self_edges, cross_edges, fixed, gt_nodes = file_scene.pose_graph_problem(gt, graph)
    final, _ = tt.optimize_sim3_pose_graph(init, self_edges, cross_edges, fixed, iters=20,
                                           device=CPU)
    before = np.median(file_scene.node_errors(init, gt_nodes))
    assert np.median(file_scene.node_errors(final, gt_nodes)) < 0.25 * before


@pytest.mark.slow
def test_record_is_the_jax_package_s():
    """The JAX package on the record's inputs gives the record (1e-10: its
    rounding on another CPU)."""
    with np.load(RECORD) as z:
        rec = dict(z)
    for key, value in jax_outputs().items():
        np.testing.assert_allclose(rec[key], value, rtol=1e-10, atol=1e-20, err_msg=key)


def _two_copies():
    """`tests/test_aux_parity.py::test_align_overlap_reconstructions`' scene:
    two copies of one reconstruction, the query moved by a Sim(3)."""
    ref = convert.reconstruction(random_reconstruction(num_views=6, num_tracks=80, seed=7))
    qry = convert.reconstruction(random_reconstruction(num_views=6, num_tracks=80, seed=7))
    _, s, R, t = _random_sim3(np.random.default_rng(8), scale=2.5)
    tt.transform_reconstruction(qry, R, t, s)
    return ref, qry, [(v, v) for v in range(3)]


def test_find_common_tracks_matches_jax():
    ref, qry, matches = _two_copies()
    qry.track_estimated[5] = False
    jref = random_reconstruction(num_views=6, num_tracks=80, seed=7)
    jqry = random_reconstruction(num_views=6, num_tracks=80, seed=7)
    for name in ("points", "view_extrinsics", "track_estimated"):
        setattr(jqry, name, getattr(qry, name).copy())
    want = jt.find_common_tracks_by_feature_in_reconstructions(jref, jqry, matches)
    got = tt.find_common_tracks_by_feature_in_reconstructions(ref, qry, matches)
    assert got[2] == want[2] and len(got[2]) >= 30
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_align_overlap_reconstructions():
    """`tests/test_aux_parity.py::test_align_overlap_reconstructions` on the
    port, with its bars."""
    ref, qry, matches = _two_copies()
    _, _, pairs = tt.find_common_tracks_by_feature_in_reconstructions(ref, qry, matches)
    assert len(pairs) >= 30
    summary = tt.align_overlap_reconstructions_with_points_and_poses_robust(
        ref, qry, matches, ba_iterations=10, device=CPU)
    assert summary.success
    err = np.linalg.norm(ref.view_extrinsics[:3, :3] - qry.view_extrinsics[:3, :3], axis=-1)
    assert np.max(err) < 0.05
    # The prior the reference's pose installs on each overlap view.
    np.testing.assert_array_equal(qry.view_priors[1].position, ref.view_extrinsics[1, :3])
    np.testing.assert_array_equal(qry.view_priors[1].position_sqrt_information, np.eye(3) * 100)


def test_split_recovers_the_known_sim3():
    """`tools.file_scene.split` on a 24-view ground truth: the robust Sim(3)
    of the common tracks is the inverse of the known one."""
    _, gt, _ = file_scene.scene(V=24, T=1500)
    ref, qry, matches = file_scene.split(gt, 13, 10)
    p_ref, p_qry, pairs = tt.find_common_tracks_by_feature_in_reconstructions(ref, qry, matches)
    summary = tt.optimize_alignment_sim3(p_qry, p_ref, tt.Sim3AlignmentOptions(
        alignment_type=tt.Sim3AlignmentType.ROBUST_POINT_TO_POINT), device=CPU)
    s, R, t = file_scene.split_sim3()
    np.testing.assert_allclose(summary.sim3_params[3:6], -file_scene.SPLIT_ANGLE_AXIS, atol=1e-9)
    assert abs(summary.sim3_params[6] + np.log(s)) < 1e-9
    np.testing.assert_allclose(lie.sim3_exp(torch.tensor(summary.sim3_params))[1].numpy(), R.T,
                               atol=1e-9)


def test_align_overlap_keeps_shared_priors_apart():
    """`tools.file_scene.split` of a 24-view ground truth whose views share
    one prior object (as `build_scene` adds them): only the overlap views
    get pose priors, and the aligned part lands on the ground truth. The
    JAX function writes into the shared object (ROADMAP.md, section 3)."""
    _, gt, _ = file_scene.scene(V=24, T=1500)
    assert gt.view_priors[0] is gt.view_priors[23]
    ref, qry, matches = file_scene.split(gt, 13, 10)
    tt.align_overlap_reconstructions_with_points_and_poses_robust(ref, qry, matches, device=CPU)
    overlap = {q for _, q in matches}
    assert all((qry.view_priors[v].position is not None) == (v in overlap)
               for v in range(qry.num_views()))
    assert gt.view_priors[0].position is None
    assert np.median(file_scene.part_position_errors(qry, gt, 10)) < 0.02
