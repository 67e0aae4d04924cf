"""Global SfM and its kernels on a device mesh of several ranks.

    python -m pytheiasfm_tpu_torch.tools.mesh_sfm [--ranks 2] [--views 553 --tracks 50000]

Starts `--ranks` processes (`torch.multiprocessing`, start method `spawn`)
joined in one process group on the CUDA cards (rank r on
`cuda:(r % device_count)`; ranks that share a card use gloo, which carries
CUDA tensors through the host, `backend="cpu:gloo,cuda:gloo"`: NCCL refuses
two ranks on one device), and on a 1-D mesh over them runs:

  estimate    `pipelines.synthetic_global.run()` (the reference-default
              options: rotations, LUD, triangulation and the iterative
              Schur sharded), with the collectives counted and timed;
  calibrated  `run(calibrated=True)` (the dense Schur's sharded
              off-diagonal product);
  blocks      `parallel.distributed.sharded_segment_sum` and
              `distributed_normal_equation_blocks` on the observations of
              the 2152-view scene (`run(V=2152, T=100_000)`'s), against
              `segment_sum` on one rank;
  matcher     the ring scene's 496 pairs split over the ranks, each rank's
              share through `matching.brute_force.match_descriptors_batch_auto`
              (one launch of the fused top-2 kernel a rank), gathered;
  nccl        rank 0 alone in a 1-rank NCCL group: triangulation and the
              dense Schur on the calibrated run's reconstruction.

Each rank writes `rank<r>.json` (seconds and peak device memory of each
step, counts, the collectives of `estimate`, SHA-256 digests of the
returned reconstructions) and `rank<r>.npz` (what the caller holds to a
run on one device: orientations and positions of steps 3-7, estimated
tracks, the matcher's gathered outputs) to a directory, and the command
prints each rank's lines. A rank's exception ends the run with an error
(`mp.spawn` raises it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import socket
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BACKEND_SHARED_CARD = "cpu:gloo,cuda:gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _poses(res):
    orientations, positions = res["poses"]
    ids = sorted(positions)
    return (np.asarray(ids, np.int64), np.stack([orientations[v] for v in ids]),
            np.stack([positions[v] for v in ids]))


def _run_sfm(mesh, calibrated, views, tracks, out, arrays, label):
    from ..parallel import sharding
    from ..pipelines import synthetic_global
    from ..sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )

    options = ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType.GLOBAL, rng_seed=0, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    sharding.reset_collective_stats(timing=label == "estimate")
    t0 = time.perf_counter()
    res = synthetic_global.run(V=views, T=tracks, calibrated=calibrated, options=options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recon = res["reconstruction"]
    ids, orient, pos = _poses(res)
    arrays[f"{label}_pose_ids"], arrays[f"{label}_orientations"] = ids, orient
    arrays[f"{label}_positions"] = pos
    arrays[f"{label}_tracks"] = np.nonzero(recon.track_estimated)[0]
    out[label] = dict(
        seconds=wall, stage_seconds=res["stage_seconds"], views=res["views"],
        success=res["success"], estimated_tracks=res["estimated_tracks"],
        median_pos_err=res["median_pos_err"], mean_pos_err=res["mean_pos_err"],
        ba_rounds=[{k: r[k] for k in ("solver", "iterations", "pcg_iterations", "initial_cost",
                                      "final_cost", "outliers")}
                   for r in res["ba_rounds"]],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        collectives=dict(sharding.collective_stats),
        digest=_digest(recon.view_extrinsics, recon.intrinsics, recon.points,
                       recon.view_estimated, recon.track_estimated),
    )
    sharding.reset_collective_stats()
    return recon


def _blocks(mesh, out, seed=0):
    """The distributed reduction on the 2152-view scene's observations
    against `segment_sum` on this rank, each held at f32 rounding: the
    largest difference over the largest sum of magnitudes."""
    from ..ops.segment import segment_sum
    from ..parallel.distributed import distributed_normal_equation_blocks, sharded_segment_sum
    from ..pipelines.synthetic_global import build_scene

    torch.cuda.reset_peak_memory_stats()
    recon, _, _ = build_scene(V=2152, T=100_000, seed=0)
    V, T, O = recon.num_views(), recon.num_tracks(), recon.num_observations()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(seed)
    Jc, Jp, r = (torch.randn(s, generator=g).to(dev) for s in ((O, 2, 6), (O, 2, 3), (O, 2)))
    ov = torch.as_tensor(recon.obs_view, device=dev).long()
    ot = torch.as_tensor(recon.obs_track, device=dev).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = (sharded_segment_sum(Jc.reshape(O, 12), ov, V, mesh),
           *distributed_normal_equation_blocks(Jc, Jp, r, ov, ot, V, T, mesh))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    terms = ((Jc.reshape(O, 12), ov, V), (Jc.mT @ Jc, ov, V), (Jp.mT @ Jp, ot, T),
             (torch.sum(Jc * r[..., None], dim=1), ov, V),
             (torch.sum(Jp * r[..., None], dim=1), ot, T))
    signs = (1, 1, 1, -1, -1)
    rel = []
    for x, (vals, ids, n), sign in zip(got, terms, signs):
        want = sign * segment_sum(vals, ids, n)
        scale = segment_sum(vals.abs(), ids, n).max()
        rel.append(float((x - want).abs().max() / scale))
    out["blocks"] = dict(observations=O, views=V, tracks=T, seconds=wall, rel_err=rel,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _matcher(mesh, out, arrays):
    from ..matching.brute_force import match_descriptors_batch_auto
    from ..matching.options import FeatureMatcherOptions
    from ..matching import streaming_matcher as sm
    from ..parallel.sharding import gather_shards, local_shard
    from . import ring_scene as rs

    torch.cuda.reset_peak_memory_stats()
    views, _, _ = rs.ring_scene()
    dev = torch.device("cuda", torch.cuda.current_device())
    desc = torch.as_tensor(np.stack([d for _, d in views]), dtype=torch.float32, device=dev)
    n = len(views)
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)])
    ia, ib = (local_shard(torch.as_tensor(pairs[:, k], device=dev), mesh) for k in (0, 1))
    d1, d2 = desc[ia], desc[ib]
    m = torch.ones(d1.shape[:2], dtype=torch.bool, device=dev)
    sm.streaming_top2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = match_descriptors_batch_auto(d1, d2, m, m, FeatureMatcherOptions().lowes_ratio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sm.streaming_top2.launches
    arrays["matcher_idx"] = gather_shards(idx, mesh, len(pairs)).cpu().numpy()
    arrays["matcher_dist"] = gather_shards(dist, mesh, len(pairs)).cpu().numpy()
    out["matcher"] = dict(pairs=len(pairs), rank_pairs=int(d1.shape[0]), k1_launches=launches,
                          seconds=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _nccl(recon, out, port):
    """Rank 0 alone in a 1-rank NCCL group: triangulation and the dense
    Schur on a mesh of one, against the same calls without a mesh."""
    import copy

    import torch.distributed as dist

    from ..ba.entry import bundle_adjust_reconstruction
    from ..ba.lm import BundleAdjustmentOptions
    from ..parallel import make_mesh, multihost
    from ..sfm.track_estimator import TrackEstimatorOptions, estimate_all_tracks

    torch.cuda.reset_peak_memory_stats()
    multihost.initialize(f"tcp://localhost:{port}", world_size=1, rank=0, backend="nccl",
                         timeout_s=300)
    try:
        mesh = make_mesh()
        res, points = {}, {}
        for label, m in (("mesh", mesh), ("single", None)):
            r = copy.deepcopy(recon)
            r.track_estimated[:] = False
            t0 = time.perf_counter()
            s = estimate_all_tracks(r, TrackEstimatorOptions(mesh=m))
            b = bundle_adjust_reconstruction(BundleAdjustmentOptions(mesh=m), r)
            torch.cuda.synchronize()
            res[label] = dict(tracks=sorted(s.estimated_tracks), solver=b.linear_solver,
                              iterations=b.num_iterations, cost=b.final_cost,
                              seconds=time.perf_counter() - t0)
            est = r.track_estimated
            points[label] = r.points[est, :3] / r.points[est, 3:]
        same = res["mesh"].pop("tracks") == res["single"].pop("tracks")
        gap = float(np.abs(points["mesh"] - points["single"]).max()) if same else float("inf")
        out["nccl"] = dict(backend=dist.get_backend(), same_tracks=same, tracks=int(est.sum()),
                           point_gap=gap, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           **res)
    finally:
        dist.destroy_process_group()


def rank_main(rank, world, init_method, out_dir, cfg):
    """One rank: join the group, run the steps, write
    `out_dir/rank<rank>.json` and `.npz`."""
    import torch.distributed as dist

    from ..matching import streaming_matcher as sm
    from ..parallel import make_mesh, multihost
    from . import exp_matcher_roofline as k2

    sm.streaming_top2.launches = k2.matmul_rowmin.launches = 0
    t0 = time.perf_counter()
    multihost.initialize(init_method, world_size=world, rank=rank,
                         backend=BACKEND_SHARED_CARD, timeout_s=600)
    mesh = make_mesh()
    out = dict(rank=rank, world=world, device=str(torch.cuda.current_device()),
               backend=dist.get_backend(), t_join_s=time.perf_counter() - t0)
    arrays = {}
    _run_sfm(mesh, False, cfg["views"], cfg["tracks"], out, arrays, "estimate")
    recon = _run_sfm(mesh, True, cfg["views"], cfg["tracks"], out, arrays, "calibrated")
    _blocks(mesh, out)
    _matcher(mesh, out, arrays)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        _nccl(recon, out, cfg["nccl_port"])
    out["t_total_s"] = time.perf_counter() - t0
    out["k1_launches"], out["k2_launches"] = sm.streaming_top2.launches, k2.matmul_rowmin.launches
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def launch(out_dir, ranks: int = 2, views: int = 553, tracks: int = 50_000):
    """Run `ranks` ranks of `rank_main` to their end and return their JSON
    results (a list by rank) and arrays (npz files, by rank)."""
    import torch.multiprocessing as mp

    cfg = dict(views=views, tracks=tracks, nccl_port=free_port())
    init = f"tcp://localhost:{free_port()}"
    mp.spawn(rank_main, args=(ranks, init, str(out_dir), cfg), nprocs=ranks, join=True,
             start_method="spawn")
    results, arrays = [], []
    for r in range(ranks):
        with open(Path(out_dir) / f"rank{r}.json") as f:
            results.append(json.load(f))
        arrays.append(dict(np.load(Path(out_dir) / f"rank{r}.npz")))
    return results, arrays


def describe(results) -> list[str]:
    """The lines a run prints, rank by rank."""
    lines = []
    for res in results:
        r = res["rank"]
        head = (f"[mesh rank {r}] {res['backend']} on cuda:{res['device']}, joined in "
                f"{res['t_join_s']:.2f} s, total {res['t_total_s']:.2f} s")
        lines.append(head)
        for label in ("estimate", "calibrated"):
            if label in res:
                x = res[label]
                st = ", ".join(f"{k} {v:.3f} s" for k, v in x["stage_seconds"].items())
                c = x["collectives"]
                lines.append(
                    f"[mesh rank {r}] {label}: {x['seconds']:.3f} s ({st}); {x['views']} views, "
                    f"{x['estimated_tracks']} tracks, median position error "
                    f"{x['median_pos_err']!r}; BA rounds {x['ba_rounds']}; peak device memory "
                    f"{x['peak_gib']:.2f} GiB; collectives: {c['all_reduce']} all_reduce, "
                    f"{c['broadcast']} broadcast, {c['all_gather']} all_gather"
                    + (f", {c['seconds']:.3f} s in them (timed from a device synchronize "
                       f"before to one after each)" if c["seconds"] else ""))
        if "blocks" in res:
            b = res["blocks"]
            lines.append(f"[mesh rank {r}] blocks: {b['observations']} observations, "
                         f"{b['views']} views, {b['tracks']} tracks: {b['seconds']:.3f} s, peak "
                         f"device memory {b['peak_gib']:.2f} GiB; |delta| / max sum of "
                         f"magnitudes {b['rel_err']}")
        if "matcher" in res:
            m = res["matcher"]
            lines.append(f"[mesh rank {r}] matcher: {m['rank_pairs']} of {m['pairs']} pairs, "
                         f"{m['k1_launches']} K1 launch(es), {m['seconds'] * 1e3:.3f} ms (the "
                         f"kernel's library loaded in it), peak device memory "
                         f"{m['peak_gib']:.2f} GiB")
        if "nccl" in res:
            n = res["nccl"]
            lines.append(f"[mesh rank {r}] 1-rank {n['backend']} group: mesh {n['mesh']}, "
                         f"one device {n['single']}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--views", type=int, default=553)
    ap.add_argument("--tracks", type=int, default=50_000)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        results, _ = launch(tmp, args.ranks, args.views, args.tracks)
    for line in describe(results):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
