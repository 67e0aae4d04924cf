"""How far global SfM's result moves between bundle adjustments on the card.

    python -m pytheiasfm_tpu_torch.tools.ba_spread [--repeats N] [--reference-default]

Runs `pipelines.synthetic_global.run(calibrated=True)` (553 views, 50,000
tracks, seed 0: BA by the dense Schur; with `--reference-default`, `run()`:
the iterative Schur) `--repeats` times on the card and keeps each run's
state before bundle adjustment. For each kept state it prints the median
position error after Umeyama against ground truth before BA, and after one
`bundle_adjust_reconstruction` at the run's BA options from that state: on
the card in f32 (twice), on the card in f64 and on the CPU in f32. The
spread across states is that of steps 1-8 (LUD on the card sums by
atomics); the spread across BA runs from one state is BA's own.
"""

from __future__ import annotations

import argparse
import copy
import subprocess

import numpy as np
import torch

from ..ba.entry import bundle_adjust_reconstruction
from ..pipelines import synthetic_global
from ..sfm.estimator_options import set_bundle_adjustment_options
from ..sfm.global_estimator import GlobalReconstructionEstimator
from ..sfm.reconstruction_estimator_utils import num_estimated_views
from ..transforms.alignment import align_point_clouds_umeyama


def median_position_error(recon, gt_positions) -> float:
    ids = np.nonzero(recon.view_estimated)[0]
    est = torch.as_tensor(recon.view_extrinsics[ids, :3], dtype=torch.float64)
    gt = torch.as_tensor(gt_positions[ids], dtype=torch.float64)
    R, t, s = align_point_clouds_umeyama(est, gt)
    aligned = float(s) * est @ R.T + t
    return float(torch.median(torch.linalg.norm(aligned - gt, dim=-1)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--reference-default", action="store_true",
                        help="free focal + radial intrinsics, XYZW_MANIFOLD tracks")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ba_spread: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    _, _, gt_positions = synthetic_global.build_scene()
    kept = []
    loop = GlobalReconstructionEstimator._bundle_adjustment_loop

    def keep(self, recon):
        options = set_bundle_adjustment_options(self.options, num_estimated_views(recon))
        kept.append((copy.deepcopy(recon), options))
        return loop(self, recon)

    GlobalReconstructionEstimator._bundle_adjustment_loop = keep
    try:
        for _ in range(args.repeats):
            synthetic_global.run(calibrated=not args.reference_default)
    finally:
        GlobalReconstructionEstimator._bundle_adjustment_loop = loop
    for i, (state, options) in enumerate(kept):
        row = [f"state {i}: before BA {median_position_error(state, gt_positions)!r}"]
        for label, device, dtype in (("card f32", "cuda", np.float32),
                                     ("card f32 again", "cuda", np.float32),
                                     ("card f64", "cuda", np.float64),
                                     ("CPU f32", "cpu", np.float32)):
            recon = copy.deepcopy(state)
            s = bundle_adjust_reconstruction(options, recon, dtype, device=device)
            row.append(f"{label} {median_position_error(recon, gt_positions)!r} "
                       f"({s.linear_solver} kernel, {s.num_iterations} LM iterations, "
                       f"cost {s.final_cost!r})")
        print("; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
