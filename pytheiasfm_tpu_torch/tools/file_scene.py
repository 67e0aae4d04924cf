"""The synthetic 553-view scene as files, and the auxiliaries' problems on it.

`pipelines.synthetic_global.build_scene` (553 views, 50,000 tracks, seed
0) written as the reference's `.recon` archives: its feature tracks with
their intrinsics priors (`tracks.recon`), its ground truth (`gt.recon`:
every view and track estimated at its true pose and position) and its view
graph (`graph.vg`); the Sim(3) alignment problem of two overlapping parts of
the ground truth (`split`); and a Sim(3) pose graph over the views
(`pose_graph_problem`). `chip_smoke.py` phase 17 runs
`pipelines.fountain.evaluate`, `mvs.view_selection_mvsnet` and the Sim(3)
functions on them on the card and holds them to the JAX package's CPU runs
on the same inputs (`tests/torch_io_reference.py`).
"""

from __future__ import annotations

import copy
import hashlib
import os
import time

import numpy as np
import torch

from ..ops import lie
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np
from ..pipelines import synthetic_global
from ..transforms.alignment import transform_reconstruction

__all__ = ["scene", "write_files", "sha256", "split", "part_position_errors",
           "pose_graph_problem", "node_errors"]

FILES = ("tracks.recon", "gt.recon", "graph.vg")
# The two overlapping parts of the ground truth (views [0, 300) and
# [250, V)) and the Sim(3) that moves the second: x' = s R x + t.
SPLIT = (300, 250)
SPLIT_ANGLE_AXIS = np.array([0.2, -0.3, 0.4])
SPLIT_TRANSLATION = np.array([2.0, -1.0, 0.5])
SPLIT_SCALE = 1.7
# The pose graph: nodes at the ground truth plus this noise in the tangent
# (node 0 exact and fixed), each view-graph edge's relative Sim(3) and a
# cross edge to the ground truth every CROSS_EVERY views with EDGE_NOISE.
NODE_NOISE = 1e-2
EDGE_NOISE = 1e-3
CROSS_EVERY = 10
POSE_GRAPH_ITERATIONS = 20


def scene(V=553, T=50_000, seed=0):
    """(the scene's tracks with their priors, its ground truth, its view
    graph). The ground truth holds the true poses (the look-at ring of
    `build_scene`) and points, every view and track estimated."""
    recon, graph, positions = synthetic_global.build_scene(V=V, T=T, seed=seed)
    rng = np.random.default_rng(seed)
    _, _, aa = synthetic_global._look_at_ring(V, rng)
    points = rng.uniform(-3, 3, size=(T, 3))  # the next draws of build_scene
    gt = copy.deepcopy(recon)
    gt.view_extrinsics[:] = np.concatenate([positions, aa], axis=1)
    gt.view_estimated[:] = True
    gt.points[:] = np.concatenate([points, np.ones((T, 1))], axis=1)
    gt.track_estimated[:] = True
    return recon, gt, graph


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_files(directory, recon, gt, graph, writers=None):
    """Write the three files into `directory` with `writers` (the port's
    `write_theia_reconstruction` / `write_theia_view_graph` by default).
    Returns ({name: path}, {name: seconds})."""
    if writers is None:
        from ..io.theia_recon import write_theia_reconstruction, write_theia_view_graph

        writers = (write_theia_reconstruction, write_theia_view_graph)
    paths = {name: os.path.join(directory, name) for name in FILES}
    seconds = {}
    for name, obj, write in zip(FILES, (recon, gt, graph), (writers[0], writers[0], writers[1])):
        t0 = time.perf_counter()
        write(obj, paths[name])
        seconds[name] = time.perf_counter() - t0
    return paths, seconds


def split_sim3():
    """(s, R, t) of the known Sim(3) that moves the second part."""
    return SPLIT_SCALE, angle_axis_to_rotation_matrix_np(SPLIT_ANGLE_AXIS), SPLIT_TRANSLATION


def split(gt, first=SPLIT[0], second=SPLIT[1], transform=transform_reconstruction):
    """Two overlapping parts of a ground-truth reconstruction (either
    package's): views [0, first) and [second, V), the second moved by
    `split_sim3()` with `transform`. Returns (part 1, part 2, the overlap's
    view pairs (part 1 id, part 2 id))."""
    V = gt.num_views()
    ref = gt.get_sub_reconstruction(list(range(first)))
    qry = gt.get_sub_reconstruction(list(range(second, V)))
    s, R, t = split_sim3()
    transform(qry, R, t, s)
    return ref, qry, [(v, v - second) for v in range(second, first)]


def part_position_errors(qry, gt, second=SPLIT[1]):
    """The second part's position errors against the ground truth, in the
    ground truth's frame (after its alignment)."""
    n = qry.num_views()
    return np.linalg.norm(qry.view_extrinsics[:n, :3]
                          - gt.view_extrinsics[second:second + n, :3], axis=-1)


def _nodes(extrinsics):
    """World->camera Sim(3)s (s = 1, R, t = -R c) of extrinsics [V, 6], in
    log coordinates [V, 7]."""
    R = torch.as_tensor(angle_axis_to_rotation_matrix_np(extrinsics[:, 3:]))
    t = -(R @ torch.as_tensor(extrinsics[:, :3])[..., None])[..., 0]
    return lie.sim3_log(torch.ones(len(extrinsics), dtype=torch.float64), R, t)


def pose_graph_problem(gt, graph, views=None, seed=0):
    """A Sim(3) pose graph over the first `views` views (default all):
    nodes at the ground truth plus NODE_NOISE in the tangent (node 0 exact
    and fixed), a self edge for each view-graph edge between them (its
    relative Sim(3) log(S_i^-1 S_j) plus EDGE_NOISE), a cross edge to the
    ground truth (plus EDGE_NOISE) every CROSS_EVERY views. Returns
    (initial nodes [N, 7], self edges, cross edges, fixed nodes, ground-truth
    nodes [N, 7])."""
    V = gt.num_views() if views is None else views
    nodes = _nodes(gt.view_extrinsics[:V])
    rng = np.random.default_rng(seed)
    init = nodes.numpy() + rng.normal(size=(V, 7)) * NODE_NOISE
    init[0] = nodes[0].numpy()
    keys = np.asarray([k for k in sorted(graph.edges) if k[1] < V], np.int64).reshape(-1, 2)
    i, j = torch.as_tensor(keys[:, 0]), torch.as_tensor(keys[:, 1])
    rel = lie.sim3_log(*lie.sim3_multiply(*lie.sim3_inverse(*lie.sim3_exp(nodes[i])),
                                          *lie.sim3_exp(nodes[j]))).numpy()
    rel = rel + rng.normal(size=rel.shape) * EDGE_NOISE
    self_edges = [(int(a), int(b), rel[e], None) for e, (a, b) in enumerate(keys)]
    cross_views = range(0, V, CROSS_EVERY)
    cross = nodes.numpy()[list(cross_views)] + rng.normal(size=(len(cross_views), 7)) * EDGE_NOISE
    cross_edges = [(v, cross[k], None) for k, v in enumerate(cross_views)]
    return init, self_edges, cross_edges, [0], nodes.numpy()


def node_errors(nodes, gt_nodes):
    """||log(S_gt^-1 S)|| of each node [N]."""
    a = lie.sim3_exp(torch.as_tensor(np.array(gt_nodes, np.float64)))
    b = lie.sim3_exp(torch.as_tensor(np.array(nodes, np.float64)))
    err = lie.sim3_log(*lie.sim3_multiply(*lie.sim3_inverse(*a), *b))
    return torch.linalg.norm(err, dim=-1).numpy()
