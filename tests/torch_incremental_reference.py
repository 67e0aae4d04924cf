"""The JAX package's incremental and hybrid estimators at the sizes of
`chip_smoke.py` phases 13 and 14: the constants that those phases hold
the port to. Not a test: each run takes minutes of CPU.

    # Phase 13: the 128-view `generate_scene`, one estimator a process.
    JAX_PLATFORMS=cpu python tests/torch_incremental_reference.py scene \\
        --estimator incremental [--views 128 --tracks 6000]

    # Phase 14, step 1 (needs the CUDA card): the port's verified view graph
    # of the rendered 32-view scene, saved to an .npz with its SHA-256.
    python tests/torch_incremental_reference.py capture --out graph.npz

    # Phase 14, step 2: the JAX `ReconstructionBuilder` on that graph.
    JAX_PLATFORMS=cpu python tests/torch_incremental_reference.py images \\
        --npz graph.npz --estimator incremental --ransac-key 0

`scene` builds `utils.synthetic.generate_scene(num_views, num_tracks,
pixel_noise=0.3, seed=5)` and `add_view_graph_edges(min_shared_tracks=100,
seed=1)` (in the port, the same scene as the JAX package's; then carried
into the JAX containers), runs the JAX estimator at its default options
(x64 on the CPU; BA and the track estimator at their f32 defaults) and
prints views and tracks estimated, the median position error after a
Umeyama alignment, the summary's seconds, the localization passes and the
BA calls. `capture` runs the port's `run_images_pipeline` on the card at its
defaults up to the reconstruction and saves what its `ReconstructionBuilder`
was given (priors and verified matches) with the ground-truth extrinsics.
`images` feeds that to the JAX builder with the chosen estimator; with
`--ransac-key k` every `jax.random.PRNGKey(s)` becomes `PRNGKey(s + k)`, the
same estimator on another random stream; with `--port`, the port's builder
on the CPU instead (its own generator). It prints views and tracks
estimated and the median rotation and position errors against ground truth
as `tools/images_sfm.accuracy` computes them.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

import numpy as np


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _count_calls(module, name, counts, key):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)


def _jax_estimator(kind, counts):
    """The JAX estimator class of `kind`, its module's localization and BA
    calls counted into `counts`."""
    if kind == "incremental":
        from pytheiasfm_tpu.sfm import incremental_estimator as mod

        _count_calls(mod, "localize_views_to_reconstruction_batch", counts, "localization_passes")
        cls = mod.IncrementalReconstructionEstimator
    else:
        from pytheiasfm_tpu.sfm import hybrid_estimator as mod

        _count_calls(mod, "localize_view_to_reconstruction", counts, "localization_passes")
        cls = mod.HybridReconstructionEstimator
    _count_calls(mod, "bundle_adjust_partial_reconstruction", counts, "ba_calls")
    return cls


def jax_scene(views, tracks, seed=5):
    """The scene of `tools/incremental_sfm.build_scene`, built by the port
    (numpy; the JAX package's own `generate_scene` and
    `add_view_graph_edges` take tens of minutes at 128 views) and carried
    into the JAX package's containers: (reconstruction, view graph,
    ground-truth extrinsics)."""
    from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
    from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo, ViewGraph
    from pytheiasfm_tpu_torch.tools.incremental_sfm import build_scene

    trecon, tgraph, gt_ext = build_scene(views, tracks, seed)
    recon = Reconstruction()
    for v, (name, p) in enumerate(zip(trecon.view_names, trecon.view_priors)):
        recon.add_view(name, prior=CameraIntrinsicsPrior(
            image_width=p.image_width, image_height=p.image_height,
            focal_length=p.focal_length, principal_point=p.principal_point))
        recon.view_extrinsics[v] = trecon.view_extrinsics[v]
    recon.set_camera_intrinsics_from_priors()
    recon.add_tracks_bulk(trecon.num_tracks())
    recon.add_observations_bulk(trecon.obs_view, trecon.obs_track, trecon.obs_uv)
    graph = ViewGraph()
    for (i, j), info in tgraph.edges.items():
        graph.add_edge(i, j, TwoViewInfo(**{f: getattr(info, f) for f in (
            "focal_length_1", "focal_length_2", "position_2", "rotation_2",
            "num_verified_matches", "num_homography_inliers", "visibility_score",
            "scale_estimate")}))
    return recon, graph, gt_ext


def scene(args):
    _jax_cpu()
    from pytheiasfm_tpu.sfm.estimator_options import ReconstructionEstimatorOptions
    from pytheiasfm_tpu_torch.pipelines.synthetic_global import position_errors

    counts = {"localization_passes": 0, "ba_calls": 0}
    cls = _jax_estimator(args.estimator, counts)
    t0 = time.perf_counter()
    recon, graph, gt_ext = jax_scene(args.views, args.tracks)
    print(f"scene: {args.views} views, {args.tracks} tracks, {recon.num_observations()} "
          f"observations, {graph.num_edges()} edges; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    summary = cls(ReconstructionEstimatorOptions()).estimate(graph, recon)
    wall = time.perf_counter() - t0
    _, err = position_errors(recon, gt_ext[:, :3])
    print(f"JAX CPU {args.estimator}: {summary.message}; success {summary.success}; views "
          f"{len(summary.estimated_views)}, tracks {len(summary.estimated_tracks)}; median "
          f"position error {float(np.median(err))!r}, mean {float(np.mean(err))!r}; pose "
          f"{summary.pose_estimation_time:.1f} s, triangulation "
          f"{summary.triangulation_time:.1f} s, BA {summary.bundle_adjustment_time:.1f} s, "
          f"total {wall:.1f} s; localization passes {counts['localization_passes']}, BA calls "
          f"{counts['ba_calls']}", flush=True)


def capture(args):
    import torch

    from pytheiasfm_tpu_torch.pipelines.images import run_images_pipeline
    from pytheiasfm_tpu_torch.sfm.reconstruction_builder import ReconstructionBuilder
    from pytheiasfm_tpu_torch.tools import image_scene, incremental_sfm

    if not torch.cuda.is_available():
        raise SystemExit("capture: needs a CUDA card")
    images, extrinsics = image_scene.render()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        paths = image_scene.write_views(tmp, images)
        with incremental_sfm.record_builder_inputs() as rec:
            # Stop at the reconstruction: the view graph is the matcher's.
            keep = ReconstructionBuilder.build_reconstruction
            ReconstructionBuilder.build_reconstruction = lambda self: []
            try:
                _, stats = run_images_pipeline(paths)
            finally:
                ReconstructionBuilder.build_reconstruction = keep
    incremental_sfm.save_builder_inputs(args.out, rec, extrinsics)
    sha = hashlib.sha256(Path(args.out).read_bytes()).hexdigest()
    print(f"captured {len(rec['views'])} views, {len(rec['matches'])} verified pairs "
          f"(pipeline: {stats['verified_pairs']}) to {args.out}; sha256 {sha}", flush=True)


def _port_images(args, views, matches):
    """The port's builder with the estimator on the CPU, its generator
    seeded as the package seeds it (the run the JAX one is compared with)."""
    from pytheiasfm_tpu_torch.tools import incremental_sfm

    return incremental_sfm.build_from_inputs(views, matches, args.estimator, device="cpu"), {}


def _jax_images(args, views, matches):
    jax = _jax_cpu()
    from pytheiasfm_tpu.sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior
    from pytheiasfm_tpu.sfm.reconstruction_builder import (
        ImagePairMatch,
        ReconstructionBuilder,
        ReconstructionBuilderOptions,
    )
    from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo

    key = jax.random.PRNGKey
    jax.random.PRNGKey = lambda seed: key(seed + args.ransac_key)
    counts = {"localization_passes": 0, "ba_calls": 0}
    _jax_estimator(args.estimator, counts)
    builder = ReconstructionBuilder(ReconstructionBuilderOptions(
        min_num_inlier_matches=30,
        reconstruction_estimator_options=ReconstructionEstimatorOptions(
            reconstruction_estimator_type=ReconstructionEstimatorType[args.estimator.upper()],
            rng_seed=0)))
    for name, prior in views:
        builder.add_image_with_camera_intrinsics_prior(name, CameraIntrinsicsPrior(**prior))
    for m in matches:
        builder.add_two_view_match(m["image1"], m["image2"], ImagePairMatch(
            image1=m["image1"], image2=m["image2"], twoview_info=TwoViewInfo(**m["info"]),
            correspondences1=m["c1"], correspondences2=m["c2"]))
    return builder.build_reconstruction(), counts


def images(args):
    from pytheiasfm_tpu_torch.tools import images_sfm, incremental_sfm

    sha = hashlib.sha256(Path(args.npz).read_bytes()).hexdigest()
    views, matches, extrinsics = incremental_sfm.load_builder_inputs(args.npz)
    t0 = time.perf_counter()
    models, counts = (_port_images if args.port else _jax_images)(args, views, matches)
    wall = time.perf_counter() - t0
    views_est, rot, pos = images_sfm.accuracy(models, extrinsics)
    tracks = sum(int(np.sum(m.track_estimated)) for m in models)
    who = "port CPU" if args.port else f"JAX CPU, RANSAC key {args.ransac_key},"
    print(f"{who} images {args.estimator}, npz sha256 {sha}: {len(models)} models, views "
          f"{[int(np.sum(m.view_estimated)) for m in models]} ({views_est} in the largest), "
          f"tracks {tracks}; median rotation error {rot!r} deg, median position error {pos!r} "
          f"x the ring radius; {wall:.1f} s; {counts}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("scene")
    p.add_argument("--estimator", choices=["incremental", "hybrid"], required=True)
    p.add_argument("--views", type=int, default=128)
    p.add_argument("--tracks", type=int, default=6000)
    p = sub.add_parser("capture")
    p.add_argument("--out", required=True)
    p = sub.add_parser("images")
    p.add_argument("--npz", required=True)
    p.add_argument("--estimator", choices=["incremental", "hybrid"], required=True)
    p.add_argument("--ransac-key", type=int, default=0)
    p.add_argument("--port", action="store_true",
                   help="run the port's builder on the CPU instead of the JAX package's")
    args = parser.parse_args(argv)
    {"scene": scene, "capture": capture, "images": images}[args.cmd](args)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
