"""Steps 1-7 of global SfM: a connected view graph in, a pose for every view out.

    python -m pytheiasfm_tpu_torch.tools.global_pose [--profile]

`run_global_pose` runs steps 1-7 of `GlobalReconstructionEstimator.estimate`
(the JAX package's `sfm/global_estimator.py:67-166`) through the
estimator's own `_estimate_poses`, the code `estimate` runs:

  1. filter the initial view graph (min inliers, largest component);
  2. set the camera intrinsics from the priors;
  3. MST initialisation + robust rotation averaging;
  4. the orientation filter, then the largest component;
  5. pairwise-translation refinement;
  6. the 1DSfM filter, then the largest component;
  7. LUD positions, written into the reconstruction.

Each stage is timed by host clock ending in a device synchronize. With
`profile=True` each also runs under `torch.profiler`, which counts the
kernels it launched and sums their device time (the profiler's own cost is
in those stage seconds, so time and profile in separate runs).

The command line builds `pipelines.synthetic_global.build_scene` at its
defaults (553 views, 50,000 tracks, seed 0) and runs the steps on the CUDA
card twice (a first and a warm run), printing the stage seconds; with
`--profile` a third run is profiled.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from .. import default_device
from ..ops import rotation as rotops
from ..ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from ..sfm.estimator_options import ReconstructionEstimatorOptions
from ..sfm.global_estimator import POSE_STAGES, GlobalReconstructionEstimator
from ..transforms.alignment import align_point_clouds_umeyama, sim3_transform_points
from ..utils.timing import StageTimer

__all__ = [
    "STAGES",
    "GlobalPoseResult",
    "run_global_pose",
    "contaminate",
    "ground_truth_errors",
]

STAGES = POSE_STAGES


@dataclasses.dataclass
class GlobalPoseResult:
    """What steps 1-7 gave. `edges` holds the view graph's edge set after
    each filter stage (the 1DSfM entry also after its component step);
    `removed` the edges each filter itself removed; `launches` and
    `device_seconds` a stage's kernel launches and their device time, from
    a profiled run."""

    success: bool
    orientations: dict
    positions: dict
    seconds: dict
    edges: dict
    removed: dict
    launches: dict = dataclasses.field(default_factory=dict)
    device_seconds: dict = dataclasses.field(default_factory=dict)


def run_global_pose(
    view_graph, recon, options: ReconstructionEstimatorOptions | None = None,
    device=None, profile: bool = False,
) -> GlobalPoseResult:
    """Steps 1-7 on `view_graph` and `recon` (both changed in place, as
    `estimate` changes them), through the estimator's own
    `_estimate_poses`. `device`: None means the CUDA card."""
    device = default_device(device)
    estimator = GlobalReconstructionEstimator(options, device=device)
    stage = StageTimer(device, profile)
    edges, removed = {}, {}
    poses = estimator._estimate_poses(view_graph, recon, stage, edges, removed)
    orientations, positions = poses if poses is not None else ({}, {})
    return GlobalPoseResult(poses is not None, orientations, positions, stage.seconds, edges,
                            removed, stage.launches, stage.device_seconds)


# The share of a contaminated scene's edges that `contaminate` corrupts,
# and the seed of `np.random.default_rng` that picks them and draws each.
CONTAMINATED_SHARE = 0.15
CONTAMINATION_SEED = 1


def contaminate(graph, rotations=True):
    """Corrupt `CONTAMINATED_SHARE` of the view graph's edges, chosen by
    `np.random.default_rng(CONTAMINATION_SEED)`: each gets its relative
    rotation turned about a random axis by an angle uniform in [15, 180]
    degrees (unless `rotations` is False; the draws are the same either
    way) and a random unit `position_2`. The outliers a contaminated scene
    holds; works on either package's view graph. Returns the corrupted edge
    keys."""
    rng = np.random.default_rng(CONTAMINATION_SEED)
    keys = sorted(graph.edges)
    chosen = np.sort(rng.choice(len(keys), int(round(CONTAMINATED_SHARE * len(keys))),
                             replace=False))
    for k in chosen:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = np.deg2rad(rng.uniform(15.0, 180.0))
        info = graph.edges[keys[k]]
        if rotations:
            R = angle_axis_to_rotation_matrix_np(axis * angle) @ (
                angle_axis_to_rotation_matrix_np(info.rotation_2)
            )
            info.rotation_2 = rotation_matrix_to_angle_axis_np(R)
        pos = rng.normal(size=3)
        info.position_2 = pos / np.linalg.norm(pos)
    return {keys[k] for k in chosen}


def ground_truth_errors(orientations: dict, positions: dict, gt_aa, gt_positions):
    """(median rotation error in degrees after `align_orientations`, median
    position error after a Umeyama Sim(3) alignment) of the views that have
    both estimates, against the ground-truth angle-axis [V, 3] and
    positions [V, 3] indexed by view id."""
    ids = sorted(v for v in orientations if v in positions)
    f64 = torch.float64
    gt_aa = torch.as_tensor(np.asarray(gt_aa)[ids], dtype=f64)
    est_aa = torch.as_tensor(np.stack([orientations[v] for v in ids]), dtype=f64)
    aligned = rotops.align_orientations(gt_aa, est_aa)
    loop = rotops.angle_axis_to_rotation_matrix(aligned) @ rotops.angle_axis_to_rotation_matrix(
        gt_aa
    ).mT
    rot_err = torch.rad2deg(torch.linalg.norm(rotops.rotation_matrix_to_angle_axis(loop), dim=-1))
    est = torch.as_tensor(np.stack([positions[v] for v in ids]), dtype=f64)
    gt = torch.as_tensor(np.asarray(gt_positions)[ids], dtype=f64)
    R, t, s = align_point_clouds_umeyama(est, gt)
    pos_err = torch.linalg.norm(sim3_transform_points(est, R, t, s) - gt, dim=-1)
    # numpy's median: the mean of the middle two of an even count
    # (`torch.median` takes the lower one).
    return float(np.median(rot_err.numpy())), float(np.median(pos_err.numpy()))


def main(argv=None) -> int:
    from ..pipelines.synthetic_global import build_scene

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time a stage")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("global_pose: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    runs = [("first", False), ("warm", False)] + ([("profiled", True)] if args.profile else [])
    for label, profile in runs:
        recon, graph, _ = build_scene()
        res = run_global_pose(graph, recon, profile=profile)
        for name in STAGES:
            line = f"[{label}] {name}: {res.seconds[name]:.3f} s"
            if profile:
                busy = res.device_seconds[name]
                line += (f", {res.launches[name]} kernel launches, device busy {busy:.3f} s "
                         f"({busy / res.seconds[name]:.1%} of the stage)")
            print(line, flush=True)
        print(f"[{label}] total {sum(res.seconds.values()):.3f} s; {len(res.positions)} views "
              f"posed; edges after each filter: "
              + ", ".join(f"{k} {len(v)}" for k, v in res.edges.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
