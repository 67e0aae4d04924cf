"""Global SfM end to end on the CUDA card: the synthetic ring scene.

    python -m pytheiasfm_tpu_torch.tools.global_sfm [--calibrated] [--profile]
        [--views V] [--tracks T] [--seed S]
        [--rotation TYPE] [--position TYPE] [--rigid-subgraph]

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
the share of the stage the device was busy. `--rotation`, `--position` and
`--rigid-subgraph` set the estimator types and
`extract_maximal_rigid_subgraph` as `tools/global_pose.py` does.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..pipelines import synthetic_global
from ..sfm.global_estimator import POSE_STAGES
from .global_pose import POSITION_TYPES, ROTATION_TYPES, estimator_options

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
    """`synthetic_global.run` at the reference-default options on the
    contaminated graph (phase 9 of `chip_smoke.py`)."""
    return synthetic_global.run(V=V, T=T, seed=seed, device=device, contaminated=True, **scene)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calibrated", action="store_true",
                        help="constant intrinsics and XYZW tracks (BA by the dense Schur)")
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time a stage")
    parser.add_argument("--views", type=int, default=553, help="views of the scene")
    parser.add_argument("--tracks", type=int, default=50_000, help="tracks of the scene")
    parser.add_argument("--seed", type=int, default=0, help="the scene's and estimator's seed")
    parser.add_argument("--rotation", choices=sorted(ROTATION_TYPES),
                        help="the rotation estimator (default ROBUST_L1L2)")
    parser.add_argument("--position", choices=sorted(POSITION_TYPES),
                        help="the position estimator (default LEAST_UNSQUARED_DEVIATION)")
    parser.add_argument("--rigid-subgraph", action="store_true",
                        help="keep only the maximal parallel-rigid subgraph after step 4")
    args = parser.parse_args(argv)
    options = estimator_options(args.rotation, args.position, args.rigid_subgraph,
                                rng_seed=args.seed)
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
                                   calibrated=args.calibrated, profile=profile, options=options)
        for line in describe(label, res):
            print(line, flush=True)
        print(f"[{label}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
