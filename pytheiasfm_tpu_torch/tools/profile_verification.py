"""Where the time of the matching slice's verification goes, on a CUDA card.

    python -m pytheiasfm_tpu_torch.tools.profile_verification [--out DIR]

Builds the ring scene of `ring_scene.py`, matches its descriptors through
`FeatureMatcher.match_images` (verification off) and then times stage 1 of
verification on the matches:

  - `estimate_two_view_info_batch` over all candidate pairs, by host clock
    ending in a synchronize (what `match_images` spends on verification);
  - on one chunk of pairs, by CUDA events: drawing the samples, the minimal
    solver (five-point + pose choice) and the whole RANSAC program
    (scoring = RANSAC - samples - solver);
  - `torch.profiler` over that chunk's RANSAC program: device time by
    operator, written to DIR/profile_verification.txt and printed.

Then stage 2 (`bundle_adjustment`, the default) through
`FeatureMatcher.match_images` at its default options, with the matcher's own
`_refine_survivors` wrapped in `torch.profiler`:

  - the process's first stage 2, on one pair (views 0 and 1), then a second
    one: what the first costs beyond the second is paid once per process;
  - the whole scene three times, the refinement seconds from `timings`; the
    last run's device time by operator goes to DIR/profile_refinement.txt
    and is printed.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..matching import FeatureMatcher, FeatureMatcherOptions
from ..ransac import engine, estimators
from ..sfm import two_view
from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions,
)
from ..utils.timing import cuda_time_ms
from . import ring_scene as rs


def _log(*args):
    print(*args, flush=True)


def _candidates(device):
    """The ring scene's descriptor matches (pixel correspondences) of the
    pairs that pass `min_num_feature_matches`."""
    options = FeatureMatcherOptions(
        perform_geometric_verification=False,
        geometric_verification_options=TwoViewMatchGeometricVerificationOptions(
            guided_matching=False, bundle_adjustment=False
        ),
    )
    matcher = FeatureMatcher(options, device=device)
    prior = CameraIntrinsicsPrior(
        image_width=rs.WIDTH, image_height=rs.HEIGHT, focal_length=rs.FOCAL
    )
    views, _, _ = rs.ring_scene()
    for v, (kps, desc) in enumerate(views):
        matcher.add_image(rs.view_name(v), kps, desc, prior)
    matches = matcher.match_images()
    return matches, prior, options


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="profiles", help="directory of the profile tables")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_verification: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _log(f"card: {smi.stdout.strip().splitlines()[0]}, torch {torch.__version__}")
    profile_verification(torch.device("cuda"), Path(args.out))
    profile_refinement(torch.device("cuda"), Path(args.out))
    return 0


def profile_verification(dev: torch.device, out: Path):
    matches, prior, options = _candidates(dev)
    P = len(matches)
    K = max(len(m.correspondences1) for m in matches)
    K = 1 << max(6, (K - 1).bit_length())  # the matcher's power-of-two padding
    pts1 = np.zeros((P, K, 2))
    pts2 = np.zeros((P, K, 2))
    masks = np.zeros((P, K), bool)
    for i, m in enumerate(matches):
        k = len(m.correspondences1)
        pts1[i, :k] = m.correspondences1
        pts2[i, :k] = m.correspondences2
        masks[i, :k] = True
    _log(f"candidate pairs {P}, correspondences padded to K={K}")

    etvi = options.geometric_verification_options.estimate_twoview_info_options
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two_view.estimate_two_view_info_batch(
            torch.Generator(device=dev).manual_seed(0), etvi, [prior] * P, [prior] * P,
            pts1, pts2, masks, min_num_inlier_matches=options.min_num_feature_matches,
            device=dev,
        )
        torch.cuda.synchronize()
        _log(f"[verify] all {P} pairs, run {run}: {time.perf_counter() - t0:.3f} s")

    # One chunk, as estimate_two_view_info_batch cuts it.
    C = min(P, two_view._PAIRS_PER_CHUNK)
    n1, n2, _ = two_view.normalize_features_by_priors(prior, prior, pts1[:C], pts2[:C])
    e = two_view.compute_resolution_scaled_threshold(
        etvi.max_sampson_error_pixels, rs.WIDTH, rs.HEIGHT
    )
    thresh = torch.full((C,), e * e / rs.FOCAL**2, device=dev)
    data = estimators.TwoViewData(
        torch.as_tensor(n1, dtype=torch.float32, device=dev),
        torch.as_tensor(n2, dtype=torch.float32, device=dev),
    )
    mask = torch.as_tensor(masks[:C], device=dev)
    params = two_view._ransac_parameters(etvi)
    est = estimators.RELATIVE_POSE_ESTIMATOR
    gen = torch.Generator(device=dev).manual_seed(0)
    B = params.max_iterations

    def draw():
        return engine._draw_samples(gen, mask, B, est.sample_size)

    idx = draw()
    subset = engine._gather_subset(data, idx)

    def ransac():
        return estimators.estimate_relative_pose(
            gen, data.points1, data.points2, params, mask=mask, quality="mle",
            error_thresh=thresh,
        )

    draw_ms = cuda_time_ms(draw)
    solve_ms = cuda_time_ms(lambda: est.solve(subset))
    ransac_ms = cuda_time_ms(ransac)
    _log(f"[chunk] {C} pairs x {B} hypotheses x K={K}: RANSAC {ransac_ms:.1f} ms = "
         f"samples {draw_ms:.1f} + five-point and pose choice {solve_ms:.1f} + scoring "
         f"{ransac_ms - draw_ms - solve_ms:.1f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ransac()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_verification.txt").write_text(table)
    _log(table)


def _profile_refinement_of(matcher, path: Path):
    """Wrap `matcher._refine_survivors` in `torch.profiler`; its table of
    operators by device time goes to `path`."""
    from torch.profiler import ProfilerActivity, profile

    refine = matcher._refine_survivors

    def profiled(*args, **kwargs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = refine(*args, **kwargs)
            torch.cuda.synchronize()
        path.write_text(prof.key_averages().table(sort_by="device_time_total", row_limit=30))
        return out

    matcher._refine_survivors = profiled


def profile_refinement(dev: torch.device, out: Path):
    views, _, _ = rs.ring_scene()
    prior = CameraIntrinsicsPrior(
        image_width=rs.WIDTH, image_height=rs.HEIGHT, focal_length=rs.FOCAL
    )
    out.mkdir(parents=True, exist_ok=True)

    def run(view_ids, label, profiled: Path | None = None):
        matcher = FeatureMatcher(FeatureMatcherOptions(), device=dev)
        for v in view_ids:
            matcher.add_image(rs.view_name(v), *views[v], prior)
        if profiled:
            _profile_refinement_of(matcher, profiled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matches = matcher.match_images()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _log(f"[stage 2] {label}: {len(matches)} verified pairs, match_images {wall:.3f} s, "
             f"refinement {matcher.timings['refinement']:.3f} s"
             f"{' (under the profiler)' if profiled else ''}")

    run([0, 1], "the process's first stage 2, 1 pair")
    run([0, 1], "second stage 2, 1 pair")
    everything = range(rs.NUM_VIEWS)
    for i in range(2):
        run(everything, f"{rs.NUM_VIEWS} views, run {i}")
    table = out / "profile_refinement.txt"
    run(everything, f"{rs.NUM_VIEWS} views, run 2", table)
    _log(table.read_text())


if __name__ == "__main__":
    raise SystemExit(main())
