"""Incremental and hybrid SfM end to end on the CUDA card.

    python -m pytheiasfm_tpu_torch.tools.incremental_sfm --estimator incremental|hybrid
        [--views 128] [--tracks 6000] [--seed 5] [--profile]

Builds `utils.synthetic.generate_scene(views, tracks, pixel_noise=0.3,
seed)` (every camera on a ring looks at the centre, so a track is seen by
most views) and its view graph (`add_view_graph_edges(min_shared_tracks=100,
seed=1)`: ground-truth relative poses of every pair sharing 100 tracks), and
runs the estimator at its default options through
`create_reconstruction_estimator` on the card twice, a first and a warm run.
Each run prints the views and tracks estimated, the median position error
after a Umeyama Sim(3) alignment onto ground truth, the summary's pose,
triangulation and BA seconds (and, inside the pose seconds, the view
ranking by visibility pyramids), the localization passes, the BA calls, the
launch counters and the peak device memory. With `--profile` a third run
goes under `torch.profiler`: its kernel launches and their device time.

`record_builder_inputs`, `save_builder_inputs` and `load_builder_inputs`
capture what a `ReconstructionBuilder` is given (priors and verified
matches), so that an estimator can be run again on the same view graph.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import subprocess
import time

import numpy as np
import torch

from ..pipelines.synthetic_global import position_errors
from ..sfm.estimator_options import ReconstructionEstimatorOptions, ReconstructionEstimatorType
from ..sfm.reconstruction_builder import (
    ImagePairMatch,
    ReconstructionBuilder,
    ReconstructionBuilderOptions,
)
from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.reconstruction_estimator import create_reconstruction_estimator
from ..sfm.view_graph import TwoViewInfo
from ..utils import counters
from ..utils.synthetic import SyntheticSceneOptions, add_view_graph_edges, generate_scene
from ..utils.timing import StageTimer

ESTIMATORS = ("incremental", "hybrid")


def build_scene(views=128, tracks=6000, seed=5):
    """(reconstruction, view graph, ground-truth extrinsics [V, 6]) of the
    ring scene that every view of which looks at the centre."""
    recon, gt_ext, _ = generate_scene(SyntheticSceneOptions(
        num_views=views, num_tracks=tracks, pixel_noise=0.3, seed=seed))
    graph = add_view_graph_edges(recon, gt_ext, min_shared_tracks=100, seed=1)
    return recon, graph, gt_ext


def run(estimator="incremental", views=128, tracks=6000, seed=5, device=None, profile=False,
        scene=None):
    """Build the scene (or take `scene`, a `build_scene` result that the run
    changes) and run `estimator` at its default options on `device` (None:
    the CUDA card). Returns one dict: counts, accuracy, the summary's
    seconds, `scoring_s` (the view ranking, inside `t_pose_s`),
    `localization_passes`, `ba_calls`, the launch counters and, with
    `profile`, `launches` and `device_s` of the whole `estimate`."""
    t0 = time.perf_counter()
    recon, graph, gt_ext = scene or build_scene(views, tracks, seed)
    t_build = time.perf_counter() - t0
    options = ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType[estimator.upper()])
    est = create_reconstruction_estimator(options, device=device)
    timer = StageTimer(est.device, profile)
    counters.reset()
    with timer("estimate"):
        summary = est.estimate(graph, recon)
    _, err = position_errors(recon, gt_ext[:, :3])
    return dict(
        estimator=estimator, success=bool(summary.success), message=summary.message,
        views=len(summary.estimated_views), views_total=recon.num_views(),
        tracks=recon.num_tracks(),
        estimated_tracks=len(summary.estimated_tracks), observations=recon.num_observations(),
        edges=graph.num_edges(), t_build_s=t_build, t_total_s=timer.seconds["estimate"],
        t_pose_s=summary.pose_estimation_time, t_triangulation_s=summary.triangulation_time,
        t_ba_s=summary.bundle_adjustment_time, scoring_s=est.view_scoring_time,
        localization_passes=est.localization_passes, ba_calls=est.bundle_adjustment_calls,
        counters=counters.snapshot(), median_pos_err=float(np.median(err)),
        mean_pos_err=float(np.mean(err)), launches=timer.launches.get("estimate"),
        device_s=timer.device_seconds.get("estimate"),
    )


def describe(label, res) -> list[str]:
    """The lines a run prints."""
    lines = [
        f"[{label}] {res['estimator']}: {res['views']}/{res['views_total']} views, "
        f"{res['estimated_tracks']}/{res['tracks']} tracks estimated ({res['observations']} "
        f"observations, {res['edges']} edges, scene ready in {res['t_build_s']:.1f} s); "
        f"median position error {res['median_pos_err']!r}, mean {res['mean_pos_err']!r}",
        f"[{label}] estimate {res['t_total_s']:.3f} s: pose {res['t_pose_s']:.3f} s (view "
        f"ranking {res['scoring_s']:.3f} s), triangulation {res['t_triangulation_s']:.3f} s, BA "
        f"{res['t_ba_s']:.3f} s; {res['localization_passes']} localization passes, "
        f"{res['ba_calls']} BA calls; launch counters {res['counters']}",
    ]
    if res["launches"] is not None:
        lines.append(f"[{label}] {res['launches']} kernel launches, device busy "
                     f"{res['device_s']:.3f} s ({res['device_s'] / res['t_total_s']:.1%})")
    return lines


@contextlib.contextmanager
def record_builder_inputs():
    """Record, while the block runs, what every `ReconstructionBuilder` is
    given: yields {"views": [(name, prior)], "matches": [ImagePairMatch]}
    (copies taken before the builder sees them)."""
    rec = {"views": [], "matches": []}
    add_image = ReconstructionBuilder.add_image_with_camera_intrinsics_prior
    add_match = ReconstructionBuilder.add_two_view_match

    def image(self, name, prior, *args, **kwargs):
        rec["views"].append((name, copy.deepcopy(prior)))
        return add_image(self, name, prior, *args, **kwargs)

    def match(self, image1, image2, m):
        rec["matches"].append(copy.deepcopy(m))
        return add_match(self, image1, image2, m)

    ReconstructionBuilder.add_image_with_camera_intrinsics_prior = image
    ReconstructionBuilder.add_two_view_match = match
    try:
        yield rec
    finally:
        ReconstructionBuilder.add_image_with_camera_intrinsics_prior = add_image
        ReconstructionBuilder.add_two_view_match = add_match


_INFO_FIELDS = ("focal_length_1", "focal_length_2", "position_2", "rotation_2",
                "num_verified_matches", "num_homography_inliers", "visibility_score",
                "scale_estimate")


def save_builder_inputs(path, rec, extrinsics):
    """Write a record of `record_builder_inputs` (pinhole priors) and the
    ground-truth extrinsics [V, 6] to an .npz."""
    views, matches = rec["views"], rec["matches"]
    sizes = [len(m.correspondences1) for m in matches]
    arrays = dict(
        view_names=np.asarray([n for n, _ in views]),
        image_size=np.asarray([(p.image_width, p.image_height) for _, p in views]),
        focal_length=np.asarray([p.focal_length for _, p in views], np.float64),
        principal_point=np.asarray([p.principal_point for _, p in views], np.float64),
        image1=np.asarray([m.image1 for m in matches]),
        image2=np.asarray([m.image2 for m in matches]),
        offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        c1=np.concatenate([np.asarray(m.correspondences1, np.float64).reshape(-1, 2)
                           for m in matches]),
        c2=np.concatenate([np.asarray(m.correspondences2, np.float64).reshape(-1, 2)
                           for m in matches]),
        extrinsics=np.asarray(extrinsics, np.float64),
    )
    for f in _INFO_FIELDS:
        arrays["info_" + f] = np.asarray([getattr(m.twoview_info, f) for m in matches])
    np.savez(path, **arrays)


def load_builder_inputs(path):
    """(views [(name, prior fields)], matches [dict: image1, image2, info
    fields, c1, c2], extrinsics) of an .npz of `save_builder_inputs`, as
    plain values that either package's classes take."""
    z = np.load(path)
    views = [(str(n), dict(image_width=int(s[0]), image_height=int(s[1]), focal_length=float(f),
                           principal_point=(float(p[0]), float(p[1]))))
             for n, s, f, p in zip(z["view_names"], z["image_size"], z["focal_length"],
                                   z["principal_point"])]
    matches = []
    for k in range(len(z["image1"])):
        a, b = z["offsets"][k], z["offsets"][k + 1]
        info = {f: z["info_" + f][k] for f in _INFO_FIELDS}
        info = {f: (np.array(v) if np.ndim(v) else v.item()) for f, v in info.items()}
        matches.append(dict(image1=str(z["image1"][k]), image2=str(z["image2"][k]), info=info,
                            c1=np.array(z["c1"][a:b]), c2=np.array(z["c2"][a:b])))
    return views, matches, np.array(z["extrinsics"])


def build_from_inputs(views, matches, estimator: str, device=None):
    """Run the port's `ReconstructionBuilder` with `estimator` at the images
    pipeline's builder options on recorded inputs (`load_builder_inputs`'s
    form). Returns the models."""
    builder = ReconstructionBuilder(ReconstructionBuilderOptions(
        min_num_inlier_matches=30,
        reconstruction_estimator_options=ReconstructionEstimatorOptions(
            reconstruction_estimator_type=ReconstructionEstimatorType[estimator.upper()])),
        device=device)
    for name, prior in views:
        builder.add_image_with_camera_intrinsics_prior(name, CameraIntrinsicsPrior(**prior))
    for m in matches:
        builder.add_two_view_match(m["image1"], m["image2"], ImagePairMatch(
            image1=m["image1"], image2=m["image2"], twoview_info=TwoViewInfo(**m["info"]),
            correspondences1=m["c1"], correspondences2=m["c2"]))
    return builder.build_reconstruction()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--estimator", choices=ESTIMATORS, default="incremental")
    parser.add_argument("--views", type=int, default=128, help="views of the scene")
    parser.add_argument("--tracks", type=int, default=6000, help="tracks of the scene")
    parser.add_argument("--seed", type=int, default=5, help="the scene's seed")
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("incremental_sfm: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    runs = [("first", False), ("warm", False)] + ([("profiled", True)] if args.profile else [])
    base = build_scene(args.views, args.tracks, args.seed)
    for label, profile in runs:
        torch.cuda.reset_peak_memory_stats()
        res = run(args.estimator, profile=profile, scene=copy.deepcopy(base))
        for line in describe(label, res):
            print(line, flush=True)
        print(f"[{label}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
