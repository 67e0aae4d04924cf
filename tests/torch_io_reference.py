"""The JAX package's side of the port's I/O, fountain pipeline and Sim(3)
and MVS auxiliaries: the records that `tests/test_torch_fountain.py` and
`tests/test_torch_pose_graph_sim3.py` compare with, and the constants of
`chip_smoke.py` phase 17. Not a test.

    JAX_PLATFORMS=cpu python tests/torch_io_reference.py record
    JAX_PLATFORMS=cpu python tests/torch_io_reference.py phase17 [--views V --tracks T]
        [--pose-graph-views K ...] [--out DIR]
    JAX_PLATFORMS=cpu python tests/torch_io_reference.py pose-graph --pose-graph-views K ...

- `record` writes `tests/data/torch_fountain_jax.npz` and
  `tests/data/torch_pose_graph_sim3_jax.npz` (x64; a few minutes, the JAX
  traces; each module's `slow` test computes its record again).
- `phase17` runs the JAX package on the files of `tools.file_scene` (the
  553-view synthetic scene, built by the port and carried to the JAX
  containers field by field, written by the JAX writer): the SHA-256 of
  each file, `evaluate` (tracks -> reconstruction -> ATE, the global
  estimator at the reference defaults), `view_selection_mvsnet(gt, 10)`
  (written to `DIR/torch_phase17_jax.npz`), the Sim(3) alignment of the two
  overlapping parts of the ground truth, and the pose graph over the first
  K views for each `--pose-graph-views K` (its final cost after 20 steps).
  It prints the constants `chip_smoke.py` holds phase 17 to: minutes of
  CPU at full size, so on the chip machine's CPU, never on a small host.
- `pose-graph` runs only the pose graphs (the JAX function's dense
  Jacobian over K nodes: 7 x edges x 7K f64).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def record():
    jax.config.update("jax_enable_x64", True)
    import test_torch_fountain
    import test_torch_pose_graph_sim3

    for module in (test_torch_fountain, test_torch_pose_graph_sim3):
        t0 = time.perf_counter()
        module.save_record()
        print(f"wrote {module.RECORD} in {time.perf_counter() - t0:.1f} s", flush=True)


def to_jax(recon):
    """The JAX package's `Reconstruction` with every field of the port's."""
    from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType
    from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction

    out = Reconstruction(recon.dtype)
    for name, value in vars(recon).items():
        if name == "view_priors":
            value = [CameraIntrinsicsPrior(**{
                f.name: (CameraIntrinsicsModelType(int(getattr(p, f.name)))
                         if f.name == "camera_intrinsics_model_type" else getattr(p, f.name))
                for f in dataclasses.fields(p)}) for p in value]
        elif name == "group_model":
            value = [CameraIntrinsicsModelType(int(m)) for m in value]
        elif name == "_track_obs":
            value = [list(rows) for rows in value]
        elif name == "_view_track_to_obs":
            value = [dict(d) for d in value]
        elif isinstance(value, (dict, list)):
            value = type(value)(value)
        elif isinstance(value, np.ndarray):
            value = value.copy()
        setattr(out, name, value)
    return out


def graph_to_jax(graph):
    from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo, ViewGraph

    out = ViewGraph()
    for (a, b), info in graph.edges.items():
        out.add_edge(a, b, TwoViewInfo(**{f.name: getattr(info, f.name)
                                          for f in dataclasses.fields(info)}))
    return out


def phase17(views=553, tracks=50_000, pose_graph_views=(128,), out_dir="."):
    jax.config.update("jax_enable_x64", True)
    from pytheiasfm_tpu.io import theia_recon as J
    from pytheiasfm_tpu.mvs import view_selection_mvsnet
    from pytheiasfm_tpu.pipelines import fountain
    from pytheiasfm_tpu.transforms import (
        align_overlap_reconstructions_with_points_and_poses_robust,
    )
    from pytheiasfm_tpu.transforms.alignment import transform_reconstruction
    from pytheiasfm_tpu_torch.tools import file_scene

    out = {}
    recon, gt, graph = file_scene.scene(views, tracks)
    with tempfile.TemporaryDirectory() as tmp:
        paths, sec = file_scene.write_files(tmp, to_jax(recon), to_jax(gt), graph_to_jax(graph),
                                            (J.write_theia_reconstruction,
                                             J.write_theia_view_graph))
        out["sha256"] = {name: file_scene.sha256(p) for name, p in paths.items()}
        print(f"[files] JAX writer {sec}; sha256 {out['sha256']}", flush=True)
        t0 = time.perf_counter()
        res = fountain.evaluate(fountain_path=paths["tracks.recon"], gt_path=paths["gt.recon"])
        res = {k: v for k, v in res.items() if k != "dispatch_counts"}
        out["evaluate"] = res
        print(f"[evaluate] {time.perf_counter() - t0:.1f} s: {res}", flush=True)
        jgt = J.read_theia_reconstruction(paths["gt.recon"])

    t0 = time.perf_counter()
    sel = view_selection_mvsnet(jgt, 10)
    ids = np.full((views, 10), -1, np.int32)
    scores = np.zeros((views, 10))
    for v, nbrs in sel.items():
        for k, (score, n) in enumerate(nbrs):
            ids[v, k], scores[v, k] = n, score
    path = os.path.join(out_dir, "torch_phase17_jax.npz")
    np.savez_compressed(path, ids=ids, scores=scores)
    print(f"[views] view_selection_mvsnet(gt, 10) {time.perf_counter() - t0:.1f} s; wrote "
          f"{path} (sha256 {file_scene.sha256(path)})", flush=True)

    t0 = time.perf_counter()
    first, second = (round(views * k / 553) for k in file_scene.SPLIT)
    ref, qry, matches = file_scene.split(jgt, first, second, transform=transform_reconstruction)
    summary = align_overlap_reconstructions_with_points_and_poses_robust(ref, qry, matches)
    out["sim3"] = dict(params=summary.sim3_params.tolist(), median_position_error=float(
        np.median(file_scene.part_position_errors(qry, jgt, second))))
    print(f"[sim3] {time.perf_counter() - t0:.1f} s: {out['sim3']}", flush=True)

    out["pose_graph"] = pose_graphs(jgt, graph, pose_graph_views)
    print(json.dumps(out))
    return out


def pose_graphs(gt, graph, pose_graph_views):
    """The JAX pose graph over the first K views for each K: {K: final cost,
    median node error, self edges}."""
    from pytheiasfm_tpu.transforms import optimize_sim3_pose_graph
    from pytheiasfm_tpu_torch.tools import file_scene

    out = {}
    for K in pose_graph_views:
        t0 = time.perf_counter()
        init, self_edges, cross_edges, fixed, gt_nodes = file_scene.pose_graph_problem(
            gt, graph, views=K)
        nodes, cost = optimize_sim3_pose_graph(init, self_edges, cross_edges, fixed,
                                               iters=file_scene.POSE_GRAPH_ITERATIONS)
        out[K] = dict(cost=cost, median_node_error=float(
            np.median(file_scene.node_errors(nodes, gt_nodes))), edges=len(self_edges))
        print(f"[pose graph {K}] {time.perf_counter() - t0:.1f} s: {out[K]}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["record", "phase17", "pose-graph"])
    ap.add_argument("--views", type=int, default=553)
    ap.add_argument("--tracks", type=int, default=50_000)
    ap.add_argument("--pose-graph-views", type=int, nargs="+", default=[128])
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    if args.what == "record":
        record()
    elif args.what == "phase17":
        phase17(args.views, args.tracks, args.pose_graph_views, args.out)
    else:
        jax.config.update("jax_enable_x64", True)
        from pytheiasfm_tpu_torch.tools import file_scene

        _, gt, graph = file_scene.scene(args.views, args.tracks)
        print(json.dumps(pose_graphs(gt, graph, args.pose_graph_views)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
