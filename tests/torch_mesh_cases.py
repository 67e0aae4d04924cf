"""One rank of the CPU mesh of `tests/test_torch_parallel.py` and
`tests/test_torch_mesh_sfm.py`. Not a test.

    python tests/torch_mesh_cases.py SUITE RANK WORLD STORE OUT

Joins a gloo group of WORLD ranks through a `FileStore` at STORE (nodes of
two ranks, so that a 2-D hosts x chips mesh exists), runs every case of
SUITE ("parallel": the port's `parallel/` modules; "sfm": the estimators on
a mesh) on the mesh on one CPU thread, and pickles {case: {name: numpy
array or value}} to OUT/rank<RANK>.pkl. `run_suite` starts the ranks and,
while they run, computes every case on one device in its own process (a
case called with `mesh=None`). The inputs are those of the JAX package's
record, `tests/data/torch_mesh_jax.npz` (`tests/torch_mesh_reference.py`);
nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import torch_mesh_reference as ref  # noqa: E402  (numpy only at import)

from pytheiasfm_tpu_torch.parallel import multihost  # noqa: E402
from pytheiasfm_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_shards,
    local_shard,
    make_mesh,
    mesh_axis,
    replicated,
    shard_observations,
)

CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ----------------------------------------------------------------- parallel


def case_mesh(mesh, inputs):
    from torch.distributed.tensor import Replicate, Shard

    ax = mesh_axis(mesh)
    x = torch.arange(10.0) + 100 * ax.index
    return dict(
        size=ax.size, index=ax.index, dim_names=tuple(mesh.mesh_dim_names),
        replicated=replicated(mesh) == (Replicate(),),
        sharded=shard_observations(mesh) == (Shard(0),),
        shard=_np(local_shard(torch.arange(10), mesh)),
        gathered=_np(gather_shards(local_shard(torch.arange(10), mesh), mesh, 10)),
        numpy_shard=local_shard(np.arange(10.0), mesh),
        decided=mesh_axis(mesh).decide(torch.tensor(ax.index == 0)),
        summed=_np(ax.sum(x)),
        broadcast=_np(ax.broadcast(x)),
    )


def case_segsum(mesh, inputs):
    from pytheiasfm_tpu_torch.ops.segment import segment_sum
    from pytheiasfm_tpu_torch.parallel.distributed import sharded_segment_sum

    v, ids = _t(inputs["segsum__values"]), _t(inputs["segsum__ids"])
    S = ref.SEGSUM["S"]
    if mesh is None:
        return dict(out=_np(segment_sum(v, ids, S)))
    return dict(out=_np(sharded_segment_sum(v, ids, S, mesh)))


def case_blocks(mesh, inputs):
    from pytheiasfm_tpu_torch.ops.segment import segment_sum
    from pytheiasfm_tpu_torch.parallel.distributed import distributed_normal_equation_blocks

    Jc, Jp, r, ov, ot = (_t(inputs[f"blocks__{k}"]) for k in ("Jc", "Jp", "r", "ov", "ot"))
    V, T = ref.BLOCKS["V"], ref.BLOCKS["T"]
    if mesh is not None:
        return dict(zip(("U", "Vt", "bc", "bp"), map(_np, distributed_normal_equation_blocks(
            Jc, Jp, r, ov, ot, V, T, mesh))))
    return dict(
        U=_np(segment_sum(Jc.mT @ Jc, ov, V)),
        Vt=_np(segment_sum(Jp.mT @ Jp, ot, T)),
        bc=_np(-segment_sum(torch.sum(Jc * r[..., None], dim=1), ov, V)),
        bp=_np(-segment_sum(torch.sum(Jp * r[..., None], dim=1), ot, T)),
    )


def case_multihost(mesh, inputs):
    import torch.distributed as dist

    node, nodes, local, world = multihost.process_info()
    mesh2 = multihost.global_mesh_2d()
    g = multihost.global_mesh()
    # This rank's block of 0..15: the psum over both axes of the 2-D mesh,
    # one axis after the other and over the flattened mesh.
    ax2 = mesh_axis(mesh2)
    part = ax2.shard(torch.arange(16.0)).sum().reshape(1)
    x = part.clone()
    for name in ("host", "chip"):
        dist.all_reduce(x, group=mesh2.get_group(name))
    return dict(
        initialized=multihost.is_initialized(), info=(node, nodes, local, world),
        shape2=tuple(mesh2.shape), names2=tuple(mesh2.mesh_dim_names),
        sum2=float(x[0]), sum_flat=float(ax2.sum(part)[0]), global_size=mesh_axis(g).size,
        coordinate=tuple(mesh2.get_coordinate()),
    )


def _dense_port(p, iterations, mesh, T=None):
    from pytheiasfm_tpu_torch.ba.dense_schur import bundle_adjust_dense
    from pytheiasfm_tpu_torch.ba.lm import BundleAdjustmentOptions

    V, L = p["V"], p["L"]
    T = p["T"] if T is None else T
    ext, _, pts, s = bundle_adjust_dense(
        _t(p["ext"]), _t(p["intr"]), _t(p["pts"][:T]), _t(p["view_group"]),
        _t(p["group_model_idx"]), _t(p["track_views"][:T]),
        _t(p["uv"].reshape(-1, L, 2)[:T]), _t(p["info"].reshape(-1, L, 2)[:T]),
        _t(p["mask"].reshape(-1, L)[:T]), _t(p["cam_free"]), _t(p["pt_free"][:T]),
        present_models=(0,), num_views=V, num_tracks=T, max_track_len=L, num_groups=1,
        options=BundleAdjustmentOptions(max_num_iterations=iterations), mesh=mesh)
    return dict(ext=_np(ext), pts=_np(pts), cost=s.final_cost, iterations=s.num_iterations)


def case_two_process(mesh, inputs):
    p = ref.problem(inputs, "two_process")
    return _dense_port(p, ref.TWO_PROCESS["iterations"],
                       None if mesh is None else multihost.global_mesh())


# ---------------------------------------------------------------------- sfm


def case_flat(mesh, inputs):
    from pytheiasfm_tpu_torch.ba.lm import BundleAdjustmentOptions, bundle_adjust

    args = [_t(inputs[f"flat__{k}"]) for k in ref.FLAT_ARGS]
    options = BundleAdjustmentOptions(max_num_iterations=ref.FLAT["iterations"],
                                      function_tolerance=0.0, mesh=mesh)
    ext, _, pts, s = bundle_adjust(*args, present_models=(0,), num_views=ref.FLAT["V"],
                                   num_tracks=ref.FLAT["T"], num_groups=1, options=options)
    return dict(ext=_np(ext), pts=_np(pts), cost=s.final_cost,
                pcg=s.num_linear_solver_iterations)


def case_matcher(mesh, inputs):
    from pytheiasfm_tpu_torch.matching.brute_force import match_descriptors_batch_auto

    d1, d2 = _t(inputs["matcher__d1"]), _t(inputs["matcher__d2"])
    P = d1.shape[0]
    m = torch.ones(d1.shape[:2], dtype=torch.bool)
    ratio = ref.MATCHER["ratio"]
    if mesh is None:
        idx, dist = match_descriptors_batch_auto(d1, d2, m, m, ratio)
        return dict(idx=_np(idx), dist=_np(dist), pairs=P)
    local = [local_shard(a, mesh) for a in (d1, d2, m, m)]
    idx, dist = match_descriptors_batch_auto(*local, ratio)
    return dict(idx=_np(gather_shards(idx, mesh, P)), dist=_np(gather_shards(dist, mesh, P)),
                pairs=len(local[0]))


def _entry(case, mesh):
    from pytheiasfm_tpu_torch.ba.entry import bundle_adjust_partial_reconstruction
    from pytheiasfm_tpu_torch.ba.lm import BundleAdjustmentOptions
    from pytheiasfm_tpu_torch.models.intrinsics import OptimizeIntrinsicsType as OI
    from pytheiasfm_tpu_torch.utils import synthetic

    free = case == "entry_iterative"
    cfg = ref.ENTRY_ITERATIVE if free else ref.ENTRY_DENSE
    r = ref.perturbed_entry_scene(synthetic, cfg["views"], cfg["tracks"], cfg["seed"], free)
    options = BundleAdjustmentOptions(
        max_num_iterations=cfg["iterations"],
        intrinsics_to_optimize=OI.FOCAL_LENGTH if free else OI.NONE, mesh=mesh)
    s = bundle_adjust_partial_reconstruction(
        options, list(range(2, cfg["views"])), list(range(cfg["tracks"])), r,
        dtype=np.float64, device=CPU)
    return dict(ext=r.view_extrinsics.copy(), points=r.points.copy(),
                intrinsics=r.intrinsics.copy(), cost=s.final_cost, success=s.success,
                solver=s.linear_solver, iterations=s.num_iterations)


def case_entry_dense(mesh, inputs):
    return _entry("entry_dense", mesh)


def case_entry_iterative(mesh, inputs):
    return _entry("entry_iterative", mesh)


def case_estimate(mesh, inputs):
    from pytheiasfm_tpu_torch.pipelines import synthetic_global as sg
    from pytheiasfm_tpu_torch.sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from pytheiasfm_tpu_torch.sfm.reconstruction_estimator import (
        create_reconstruction_estimator,
    )

    cfg = ref.ESTIMATE
    recon, graph, gt = sg.build_scene(**{k: v for k, v in cfg.items() if k != "iterations"})
    est = create_reconstruction_estimator(ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType.GLOBAL, mesh=mesh,
        max_num_iterations=cfg["iterations"]), device=CPU)
    summary = est.estimate(graph, recon)
    orientations, positions = est.estimated_poses
    ids = sorted(positions)
    return dict(
        success=summary.success, views=sorted(summary.estimated_views),
        tracks=sorted(summary.estimated_tracks), ext=recon.view_extrinsics.copy(),
        points=recon.points.copy(), gt=gt, pose_ids=ids,
        orientations=np.stack([orientations[v] for v in ids]),
        positions=np.stack([positions[v] for v in ids]),
        rounds=[(r["solver"], r["iterations"]) for r in est.bundle_adjustment_rounds],
    )


def _graph(inputs, name):
    from pytheiasfm_tpu_torch.sfm.view_graph import TwoViewInfo, ViewGraph

    g = ViewGraph()
    for (i, j), rot, pos, nm in zip(inputs[f"{name}__edges"], inputs[f"{name}__rotation_2"],
                                    inputs[f"{name}__position_2"], inputs[f"{name}__matches"]):
        g.add_edge(int(i), int(j), TwoViewInfo(rotation_2=rot, position_2=pos,
                                               num_verified_matches=int(nm)))
    return g


def case_rotations(mesh, inputs):
    from pytheiasfm_tpu_torch.global_pose import rotation_estimator as re

    g = _graph(inputs, "rotations")
    V = ref.GRAPH["views"]
    est = re.estimate_rotations(g, mesh=mesh, device=CPU)
    out = dict(out=np.stack([est[v] for v in range(V)]))
    if mesh is not None:
        # The sparse operator (gathers and segment sums) on the mesh too.
        dense_max = re._DENSE_INCIDENCE_MAX
        re._DENSE_INCIDENCE_MAX = 0
        try:
            est = re.estimate_rotations(g, mesh=mesh, device=CPU)
        finally:
            re._DENSE_INCIDENCE_MAX = dense_max
        out["sparse"] = np.stack([est[v] for v in range(V)])
    return out


def case_positions(mesh, inputs):
    from pytheiasfm_tpu_torch.global_pose import position_estimator as pe

    g = _graph(inputs, "positions")
    gt_aa = inputs["positions__gt_aa"]
    orient = {i: gt_aa[i] for i in range(len(gt_aa))}
    est = pe.estimate_positions(g, orient, mesh=mesh, device=CPU)
    return dict(out=np.stack([est[v] for v in range(ref.GRAPH["views"])]))


def case_triangulation(mesh, inputs):
    from pytheiasfm_tpu_torch.sfm.track_estimator import TrackEstimatorOptions, estimate_all_tracks
    from pytheiasfm_tpu_torch.utils import synthetic

    r = ref.triangulation_scene(synthetic)
    s = estimate_all_tracks(r, TrackEstimatorOptions(mesh=mesh), dtype=np.float64, device=CPU)
    return dict(points=r.points.copy(), estimated=sorted(s.estimated_tracks))


def case_dense(mesh, inputs):
    p = ref.problem(inputs, "dense")
    it = ref.DENSE["iterations"]
    return {"64": _dense_port(p, it, mesh), "62": _dense_port(p, it, mesh, T=62)}


SUITES = {
    "parallel": (case_mesh, case_segsum, case_blocks, case_multihost, case_two_process),
    "sfm": (case_estimate, case_positions, case_rotations, case_flat, case_entry_iterative,
            case_entry_dense, case_triangulation, case_matcher, case_dense),
}
# The cases that only exist on a mesh.
MESH_ONLY = (case_mesh, case_multihost)


def main(suite, rank, world, store, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world_size=world, rank=rank, backend="gloo",
                         local_world_size=2, timeout_s=120)
    mesh = make_mesh()
    inputs = dict(np.load(ref.RECORD))
    results = {}
    for case in SUITES[suite]:
        t0 = time.perf_counter()
        results[case.__name__[5:]] = case(mesh, inputs)
        results[case.__name__[5:]]["seconds"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_mesh():
    """A 1-D mesh over a 1-rank gloo group in this process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def run_suite(suite: str, tmp: Path, world: int = 4, timeout_s: float = 600.0):
    """Start WORLD ranks of `suite` as processes, compute the cases on one
    device meanwhile, wait for the ranks, and return (each rank's results, a
    list by rank; the results on one device). A rank that fails fails the
    run; the group's timeout bounds a rank that waits on one that failed."""
    import os
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    env.pop("XLA_FLAGS", None)
    store = tmp / "store"
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), suite, str(r), str(world),
                               str(store), str(tmp)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    # The same cases on one device, here, while the ranks run.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = dict(np.load(ref.RECORD))
        single = {case.__name__[5:]: case(None, inputs)
                  for case in SUITES[suite] if case not in MESH_ONLY}
    finally:
        torch.set_num_threads(threads)
    outs = []
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=timeout_s)
            log.seek(0)
            outs.append(log.read())
            log.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {suite} exited {p.returncode}:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, single


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
