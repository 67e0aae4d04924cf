"""Global SfM end to end on the CUDA card: the synthetic ring scene.

    python -m pytheiasfm_tpu_torch.tools.global_sfm [--calibrated] [--profile]
        [--views V] [--tracks T] [--seed S]

Runs `pipelines.synthetic_global.run()` (by default 553 views, 50,000
tracks, seed 0; `--views 2152 --tracks 100000` is the repository's largest
scene, where the iterative Schur's two-level preconditioner switches on)
at the reference-default options (free focal + radial intrinsics,
XYZW_MANIFOLD tracks, so the iterative Schur; with `--calibrated` constant
intrinsics and XYZW tracks, so the dense Schur) on the card twice, a first
and a warm run, and prints each stage's seconds, each bundle-adjustment
round (LM iterations, PCG steps, cost before and after, outliers removed,
seconds, and the iterative kernel's size gates), the peak device memory and
the accuracy against ground truth. With `--profile` a third run goes under
`torch.profiler`: each stage's kernel launches and their device time, and
the share of the stage the device was busy.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .. import default_device
from ..pipelines import synthetic_global
from ..sfm.estimator_options import ReconstructionEstimatorOptions
from ..sfm.global_estimator import POSE_STAGES, GlobalReconstructionEstimator
from ..utils.timing import StageTimer
from .global_pose import contaminate

STAGES = POSE_STAGES + ("triangulation", "bundle adjustment")


def describe(label, res) -> list[str]:
    """The lines a run prints: stage seconds, BA rounds, accuracy."""
    sec = res["stage_seconds"]
    lines = [f"[{label}] " + ", ".join(f"{k} {sec[k]:.3f} s" for k in STAGES if k in sec)
             + f"; estimate {res['t_total_s']:.3f} s"]
    for r in res["ba_rounds"]:
        solve = ("direct solves" if r["solver"] == "dense"
                 else f"{r['pcg_iterations']} PCG steps")
        lines.append(
            f"[{label}] BA round {r['round']} ({r['solver']} kernel): {r['iterations']} LM "
            f"iterations ({solve}), cost "
            f"{r['initial_cost']!r} -> {r['final_cost']!r}, {r['outliers']} outliers removed, "
            f"{r['retriangulated']} tracks retriangulated; solve {r['solve_s']:.3f} s, "
            f"outlier filter {r['filter_s']:.3f} s")
        if r.get("size_gates"):
            lines.append(f"[{label}] BA round {r['round']} size gates: " + ", ".join(
                f"{k} {v}" for k, v in r["size_gates"].items()))
    lines.append(
        f"[{label}] {res['views']}/{res['views_total']} views, {res['estimated_tracks']}/"
        f"{res['tracks']} tracks estimated; position error after Umeyama: median "
        f"{res['median_pos_err']!r}, mean {res['mean_pos_err']!r}")
    if res["launches"]:
        for k in STAGES:
            if k in res["launches"]:
                busy = res["device_seconds"][k]
                lines.append(f"[{label}] {k}: {res['launches'][k]} kernel launches, device busy "
                             f"{busy:.3f} s ({busy / sec[k]:.1%} of the stage)")
    return lines


def run_contaminated(V=553, T=50_000, seed=0, device=None, **scene):
    """`estimate` at the reference-default options on
    `synthetic_global.build_scene`'s view graph (`scene`: its other
    arguments) after `contaminate` (15% of its edges corrupted in rotation
    and direction). Returns the run's counts, accuracy and seconds:
    `run()`'s keys that apply, plus `estimated_views`, `removed_edges`
    (each filter's count) and `corrupted` (the corrupted edges)."""
    device = default_device(device)
    recon, graph, gt_positions = synthetic_global.build_scene(V=V, T=T, seed=seed, **scene)
    corrupted = contaminate(graph)
    estimator = GlobalReconstructionEstimator(ReconstructionEstimatorOptions(rng_seed=seed),
                                              device=device)
    timer = StageTimer(device)
    t0 = time.perf_counter()
    summary = estimator.estimate(graph, recon, timer)
    t_total = time.perf_counter() - t0
    est_ids, err = synthetic_global.position_errors(recon, gt_positions)
    return dict(success=bool(summary.success), views=len(est_ids), views_total=V,
                estimated_views=summary.estimated_views,
                tracks=recon.num_tracks(), estimated_tracks=len(summary.estimated_tracks),
                t_total_s=t_total, median_pos_err=float(np.median(err)),
                mean_pos_err=float(np.mean(err)), ba_rounds=estimator.bundle_adjustment_rounds,
                removed_edges=estimator.removed_edges, corrupted=corrupted, launches={},
                stage_seconds=timer.seconds)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calibrated", action="store_true",
                        help="constant intrinsics and XYZW tracks (BA by the dense Schur)")
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time a stage")
    parser.add_argument("--views", type=int, default=553, help="views of the scene")
    parser.add_argument("--tracks", type=int, default=50_000, help="tracks of the scene")
    parser.add_argument("--seed", type=int, default=0, help="the scene's and estimator's seed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("global_sfm: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    runs = [("first", False), ("warm", False)] + ([("profiled", True)] if args.profile else [])
    for label, profile in runs:
        torch.cuda.reset_peak_memory_stats()
        res = synthetic_global.run(V=args.views, T=args.tracks, seed=args.seed,
                                   calibrated=args.calibrated, profile=profile)
        for line in describe(label, res):
            print(line, flush=True)
        print(f"[{label}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
