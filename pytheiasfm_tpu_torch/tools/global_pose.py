"""Steps 1-7 of global SfM: a connected view graph in, a pose for every view out.

    python -m pytheiasfm_tpu_torch.tools.global_pose [--profile]
        [--rotation TYPE] [--position TYPE] [--rigid-subgraph]

`run_global_pose` runs steps 1-7 of `GlobalReconstructionEstimator.estimate`
(the JAX package's `sfm/global_estimator.py:67-166`) through the
estimator's own `_estimate_poses`, the code `estimate` runs:

  1. filter the initial view graph (min inliers, largest component);
  2. set the camera intrinsics from the priors;
  3. MST initialisation + rotation averaging (ROBUST_L1L2 by default);
  4. the orientation filter (and, if asked, the maximal parallel-rigid
     subgraph), then the largest component;
  5. pairwise-translation refinement;
  6. the 1DSfM filter, then the largest component;
  7. positions (LUD by default), written into the reconstruction.

Each stage is timed by host clock ending in a device synchronize. With
`profile=True` each also runs under `torch.profiler`, which counts the
kernels it launched and sums their device time (the profiler's own cost is
in those stage seconds, so time and profile in separate runs).

The command line builds `pipelines.synthetic_global.build_scene` at its
defaults (553 views, 50,000 tracks, seed 0) and runs the steps on the CUDA
card twice (a first and a warm run), printing the stage seconds, the peak
device memory and the accuracy against ground truth; with `--profile` a
third run is profiled. `--rotation` and `--position` name the estimator
types of `ReconstructionEstimatorOptions` (`global_rotation_estimator_type`,
`global_position_estimator_type`; positions also take BATA), and
`--rigid-subgraph` sets `extract_maximal_rigid_subgraph`.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from .. import default_device
from ..global_pose.position_estimator import GlobalPositionEstimatorType
from ..global_pose.rotation_estimator import GlobalRotationEstimatorType
from ..models import camera as cam
from ..ops import rotation as rotops
from ..pipelines.synthetic_global import contaminate
from ..sfm.estimator_options import ReconstructionEstimatorOptions
from ..sfm.global_estimator import POSE_STAGES, GlobalReconstructionEstimator
from ..transforms.alignment import align_point_clouds_umeyama, sim3_transform_points
from ..utils.timing import StageTimer

__all__ = [
    "STAGES",
    "ROTATION_TYPES",
    "POSITION_TYPES",
    "ESTIMATOR_RUNS",
    "GlobalPoseResult",
    "estimator_options",
    "run_global_pose",
    "contaminate",
    "ground_truth_errors",
    "scene_bearings",
]

STAGES = POSE_STAGES

# The estimator types by name, as the options take them.
ROTATION_TYPES = {k: v for k, v in vars(GlobalRotationEstimatorType).items() if k.isupper()}
POSITION_TYPES = {k: v for k, v in vars(GlobalPositionEstimatorType).items() if k.isupper()}

# Steps 1-7 with each estimator other than the defaults, and with the rigid
# subgraph: (label, `estimator_options` arguments).
ESTIMATOR_RUNS = (
    ("rotations NONLINEAR", dict(rotation="NONLINEAR")),
    ("rotations LINEAR", dict(rotation="LINEAR")),
    ("rotations LAGRANGE_DUAL", dict(rotation="LAGRANGE_DUAL")),
    ("rotations HYBRID", dict(rotation="HYBRID")),
    ("positions NONLINEAR", dict(position="NONLINEAR")),
    ("positions LINEAR_TRIPLET", dict(position="LINEAR_TRIPLET")),
    ("positions BATA", dict(position="BATA")),
    ("positions LIGT", dict(position="LIGT")),
    ("rigid subgraph", dict(rigid_subgraph=True)),
)


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


def estimator_options(rotation: str | None = None, position: str | None = None,
                      rigid_subgraph: bool = False, **fields) -> ReconstructionEstimatorOptions:
    """`ReconstructionEstimatorOptions(**fields)` with the rotation and
    position estimator types named (keys of `ROTATION_TYPES` and
    `POSITION_TYPES`; None keeps the default) and
    `extract_maximal_rigid_subgraph`."""
    opt = ReconstructionEstimatorOptions(**fields)
    if rotation is not None:
        opt.global_rotation_estimator_type = ROTATION_TYPES[rotation]
    if position is not None:
        opt.global_position_estimator_type = POSITION_TYPES[position]
    opt.extract_maximal_rigid_subgraph = rigid_subgraph
    return opt


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


def scene_bearings(recon):
    """(obs_view [O], obs_track [O], unit camera-frame bearings [O, 3]) of
    every observation of a reconstruction (numpy, f64): the inputs of
    `ligt_positions`. The pixels lose their intrinsics by their group's
    camera model on the CPU."""
    bearings = np.zeros((recon.num_observations(), 3))
    groups = recon.view_group[recon.obs_view]
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        ray = cam.pixel_to_normalized_batch(
            torch.as_tensor(recon.intrinsics[g], dtype=torch.float64),
            torch.as_tensor(recon.obs_uv[rows], dtype=torch.float64), recon.group_model[g],
        ).numpy()
        bearings[rows] = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    return recon.obs_view.astype(np.int64), recon.obs_track.astype(np.int64), bearings


def main(argv=None) -> int:
    from ..pipelines.synthetic_global import _look_at_ring, build_scene

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time a stage")
    parser.add_argument("--rotation", choices=sorted(ROTATION_TYPES),
                        help="the rotation estimator (default ROBUST_L1L2)")
    parser.add_argument("--position", choices=sorted(POSITION_TYPES),
                        help="the position estimator (default LEAST_UNSQUARED_DEVIATION)")
    parser.add_argument("--rigid-subgraph", action="store_true",
                        help="keep only the maximal parallel-rigid subgraph after step 4")
    args = parser.parse_args(argv)
    options = estimator_options(args.rotation, args.position, args.rigid_subgraph)
    if not torch.cuda.is_available():
        raise SystemExit("global_pose: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    runs = [("first", False), ("warm", False)] + ([("profiled", True)] if args.profile else [])
    _, _, gt_aa = _look_at_ring(553, np.random.default_rng(0))
    for label, profile in runs:
        recon, graph, gt_positions = build_scene()
        torch.cuda.reset_peak_memory_stats()
        res = run_global_pose(graph, recon, options, profile=profile)
        for name in STAGES:
            line = f"[{label}] {name}: {res.seconds[name]:.3f} s"
            if profile:
                busy = res.device_seconds[name]
                line += (f", {res.launches[name]} kernel launches, device busy {busy:.3f} s "
                         f"({busy / res.seconds[name]:.1%} of the stage)")
            print(line, flush=True)
        rot_err, pos_err = ground_truth_errors(res.orientations, res.positions, gt_aa,
                                               gt_positions)
        print(f"[{label}] total {sum(res.seconds.values()):.3f} s; {len(res.positions)} views "
              f"posed; edges after each filter: "
              + ", ".join(f"{k} {len(v)}" for k, v in res.edges.items())
              + f"; median rotation error {rot_err!r} deg, median position error {pos_err!r}; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
