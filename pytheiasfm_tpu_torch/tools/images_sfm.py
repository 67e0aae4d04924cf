"""Images to reconstruction on the CUDA card: the rendered 32-view scene.

    python -m pytheiasfm_tpu_torch.tools.images_sfm [--profile | --matcher-seeds 0 1 2 3 4]

Renders `tools.image_scene` (32 views, 1024x768, seed 0) into 8-bit PGM
files in a temporary directory and runs `pipelines.images.run_images_pipeline`
on them at its defaults (max_dim 1024, 2048 features, SIFT at 1024 a
octave, all 496 pairs with the guided rematch, the global estimator) on the
card twice, a first and a warm run. Each run prints its phase seconds,
features per image, verified pairs, models, views and tracks estimated,
K1's launches, the peak device memory and the accuracy against ground
truth: the median rotation error after the best global rotation and the
median position error after a Umeyama Sim(3) alignment, as a share of the
ring radius. With `--profile` a third run goes under `torch.profiler`:
each phase's kernel launches and their device time. With `--matcher-seeds`
the runs after the first take the given seeds of the matcher's RANSAC
generator instead, to show how far the draws move the result.
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..matching import streaming_matcher as sm
from ..pipelines.images import run_images_pipeline
from . import image_scene
from .global_pose import ground_truth_errors

PHASES = ("extract", "match_verify", "reconstruct")


def accuracy(models, extrinsics: np.ndarray, views=None):
    """(views estimated, median rotation error in degrees, median position
    error / ring radius) of the largest model against the ground-truth
    extrinsics [V, 6] of `views` (default: 0..V-1), matched by file name."""
    if not models:
        return 0, float("inf"), float("inf")
    views = list(range(len(extrinsics))) if views is None else list(views)
    index = {image_scene.view_name(v): i for i, v in enumerate(views)}
    model = max(models, key=lambda m: int(np.sum(m.view_estimated)))
    orientations, positions = {}, {}
    for v in np.flatnonzero(model.view_estimated):
        i = index[model.view_names[v]]
        orientations[i] = model.view_extrinsics[v, 3:]
        positions[i] = model.view_extrinsics[v, :3]
    if len(positions) < 2:
        return len(positions), float("inf"), float("inf")
    rot, pos = ground_truth_errors(orientations, positions, extrinsics[:, 3:],
                                   extrinsics[:, :3])
    return len(positions), rot, pos / image_scene.RING_RADIUS


def run(paths, extrinsics, **kwargs):
    """One pipeline run on the card with K1's launch count set to 0 just
    before and read just after. Returns a dict: the pipeline's stats, wall
    seconds, K1 launches, peak device memory (GiB), accuracy and models."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sm.streaming_top2.launches = 0
    t0 = time.perf_counter()
    models, stats = run_images_pipeline(paths, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    views, rot, pos = accuracy(models, extrinsics)
    return dict(stats=stats, wall_s=wall, k1_launches=sm.streaming_top2.launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, models=models,
                accuracy_views=views, median_rotation_deg=rot, median_position_share=pos)


def describe(label, res) -> list[str]:
    """The lines a run prints."""
    st = res["stats"]
    feats = np.asarray(st["features_per_image"])
    lines = [
        f"[{label}] t_extract_s {st['t_extract_s']:.3f}, t_match_verify_s "
        f"{st['t_match_verify_s']:.3f}, t_reconstruct_s {st['t_reconstruct_s']:.3f}; "
        f"run {res['wall_s']:.3f} s; peak device memory {res['peak_gib']:.2f} GiB",
        f"[{label}] features per image: min {feats.min()}, median {int(np.median(feats))}, "
        f"max {feats.max()}; verified pairs {st['verified_pairs']}; models {st['models']}; "
        f"views estimated {st['views_estimated']}; tracks estimated {st['tracks_estimated']}; "
        f"K1 launches {res['k1_launches']}",
        f"[{label}] against ground truth ({res['accuracy_views']} views of the largest "
        f"model): median rotation error {res['median_rotation_deg']!r} deg, median position "
        f"error {res['median_position_share']!r} x the ring radius",
    ]
    if st.get("launches"):
        for k in PHASES:
            busy = st["device_seconds"][k]
            lines.append(f"[{label}] {k}: {st['launches'][k]} kernel launches, device busy "
                         f"{busy:.3f} s ({busy / st['t_' + k + '_s']:.1%} of the phase)")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="a third run under torch.profiler: launches and device time a phase")
    parser.add_argument("--matcher-seeds", type=int, nargs="+", metavar="SEED",
                        help="instead: one run for each seed of the matcher's RANSAC "
                             "generator, after a first run with seed 0")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("images_sfm: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    images, extrinsics = image_scene.render()
    print(f"scene: {len(images)} views {images.shape[2]}x{images.shape[1]}, rendered in "
          f"{time.perf_counter() - t0:.1f} s, sha256 {image_scene.images_sha256(images)}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = image_scene.write_views(tmp, images)
        if args.matcher_seeds:
            runs = [("first", dict())] + [(f"matcher seed {s}", dict(matcher_seed=s))
                                          for s in args.matcher_seeds]
        else:
            runs = [("first", dict()), ("warm", dict())] + (
                [("profiled", dict(profile=True))] if args.profile else [])
        for label, kw in runs:
            res = run(paths, extrinsics, **kw)
            for line in describe(label, res):
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
