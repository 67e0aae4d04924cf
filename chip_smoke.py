#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's matching slice on one CUDA card.

    python3 chip_smoke.py

Phases, each printed (flushed) as it ends:
  1. build every kernel of the slice from `pytheiasfm_tpu_torch/csrc/`
     (one nvcc per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card at the
     bench shape and at N=64, and time both;
  3. drive the slice at full width through its public entry point,
     `FeatureMatcher.match_images`, on a ring scene of 32 calibrated views
     (4096 features x 128-D descriptors each, all 496 pairs), with the
     kernel launch counts set to 0 just before and read just after; check
     the kernel on the slice's own inputs and time it at the slice's shape;
     check the result against ground truth;
  4. print a {"kernels": [...]} line, the card's name and power limit, and
     last the {"ok": true, "device": ...} line.

It imports nothing of JAX. Without a CUDA card, or outside the repository,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pytheiasfm_tpu_torch.matching import (
    FeatureMatcher,
    FeatureMatcherOptions,
    streaming_matcher as sm,
)
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from pytheiasfm_tpu_torch.sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions,
)
from pytheiasfm_tpu_torch.tools import ring_scene as rs
from pytheiasfm_tpu_torch.utils import cuda_build

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# K1's bench shape's descriptor noise (d2 is a noisy copy of d1).
BENCH_NOISE = 0.05

# Bars of the slice. The rotation bar holds stage 1 of verification alone:
# the best of 1000 minimal five-point models, with no refinement (that is
# stage 2, the two-view bundle adjustment, not in this slice). At 0.5 px
# noise such a model is off by tenths of a degree. The JAX package's stage 1
# is the same algorithm: `tests/test_torch_ransac_two_view.py` holds the two
# scorers to each other on the same samples.
MIN_VERIFIED_SHARE = 0.9
MAX_MEDIAN_ROTATION_DEG = 0.3
MIN_AGREEMENT = 0.999
MAX_ABS_ERR = 1e-4


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def top2_bound_ms(P: int, N: int, D: int) -> tuple[float, str, str]:
    """Least time for K1's work: 2 P N^2 D bf16 operations, against reading
    the bf16 descriptors and f32 norms once and writing six [P, N] outputs.
    Returns (bound ms, what bounds it, both terms as text)."""
    ops_ms = 1e3 * 2.0 * P * N * N * D / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * (2 * P * N * D * 2 + 2 * P * N * 4 + 6 * P * N * 4) / PEAK_BYTES_PER_S
    terms = f"operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms"
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", terms


def top2_inputs(P, N, D, seed, device):
    """Unit-norm descriptors, d2 a noisy shuffled copy of d1, some masked
    rows; returned as K1 takes them (bf16 descriptors, f32 norms)."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(P, N, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + BENCH_NOISE * rng.normal(size=d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d2 = np.take_along_axis(d2, np.stack([rng.permutation(N) for _ in range(P)])[..., None], 1)
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[:, -max(1, N // 64):] = False
    m2[:, : max(1, N // 128)] = False
    return sm.streaming_inputs(*(torch.tensor(x, device=device) for x in (d1, d2, m1, m2)))


def compare_top2(got, want):
    """(index agreement, max |delta| of the distances where indices agree)."""
    agree, err = 1.0, 0.0
    for b1, b2, arg in ((0, 1, 2), (3, 4, 5)):
        same = got[arg] == want[arg]
        agree = min(agree, same.float().mean().item())
        for k in (b1, b2):
            err = max(err, (got[k] - want[k])[same].abs().max().item())
    return agree, err


def check_top2(args, label):
    got = sm.streaming_top2(*args)
    torch.cuda.synchronize()
    agree, err = compare_top2(got, sm.streaming_top2_reference(*args))
    log(f"[k1] {label}: index agreement {agree:.6f}, max |d distance| {err:.3e}")
    if agree < MIN_AGREEMENT or not err <= MAX_ABS_ERR:
        raise RuntimeError(f"K1 disagrees with its plain version at {label}")
    return agree, err


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke.py: no CUDA card; this script needs one")
        return 2
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    cuda_build.build_libraries([sm.KERNEL])
    log(f"[build] {sm.KERNEL}: {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_log(sm.KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # 2. K1 against its plain version, bench shape and N=64.
    bench = top2_inputs(8, 4096, 128, seed=1, device=dev)
    small = top2_inputs(8, 64, 128, seed=2, device=dev)
    checks = [check_top2(bench, "P=8 N=4096 D=128"), check_top2(small, "P=8 N=64 D=128")]
    bench_ms = cuda_time_ms(lambda: sm.streaming_top2(*bench), iters=20)
    bench_plain_ms = cuda_time_ms(lambda: sm.streaming_top2_reference(*bench), iters=5)
    b1t = bench[1].mT
    bench_bmm_ms = cuda_time_ms(lambda: torch.bmm(bench[0], b1t), iters=20)
    bench_bound_ms, _, terms = top2_bound_ms(8, 4096, 128)
    log(f"[k1] P=8 N=4096 D=128: kernel {bench_ms:.4f} ms, plain {bench_plain_ms:.4f} ms, "
        f"torch.bmm (matmul alone) {bench_bmm_ms:.4f} ms, bound {bench_bound_ms:.4f} ms "
        f"({terms})")

    # 3. The slice at full width.
    t0 = time.perf_counter()
    views, rots = rs.ring_scene()
    log(f"[slice] ring scene: {rs.NUM_VIEWS} views x {rs.NUM_FEATURES} features x "
        f"{rs.DESC_DIM}-D, {rs.NUM_TRACKS} tracks, made in {time.perf_counter() - t0:.2f} s")
    options = FeatureMatcherOptions(
        geometric_verification_options=TwoViewMatchGeometricVerificationOptions(
            guided_matching=False, bundle_adjustment=False
        )
    )
    matcher = FeatureMatcher(options)  # the user's default device: the card
    prior = CameraIntrinsicsPrior(
        image_width=rs.WIDTH, image_height=rs.HEIGHT, focal_length=rs.FOCAL
    )
    for v, (kps, desc) in enumerate(views):
        matcher.add_image(rs.view_name(v), kps, desc, prior)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sm.streaming_top2.launches = 0
    t0 = time.perf_counter()
    matches = matcher.match_images()
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = sm.streaming_top2.launches
    log(f"[slice] match_images: {slice_s:.3f} s (matching {matcher.timings['matching']:.3f} s, "
        f"verification {matcher.timings['verification']:.3f} s); K1 launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    verified = {(m.image1, m.image2): m for m in matches}
    overlapping, separate, errors = 0, 0, []
    for a in range(rs.NUM_VIEWS):
        for b in range(a + 1, rs.NUM_VIEWS):
            m = verified.get((rs.view_name(a), rs.view_name(b)))
            if not rs.shares_tracks(a, b):
                separate += m is not None
                continue
            overlapping += 1
            if m is not None:
                errors.append(
                    rs.rotation_error_deg(m.twoview_info.rotation_2, rots[b] @ rots[a].T)
                )
    errors = np.array(errors)
    n_ok = len(errors)
    log(f"[slice] verified {n_ok}/{overlapping} pairs that share tracks, "
        f"{separate}/{len(matcher.pairs()) - overlapping} that share none; relative rotation "
        f"error vs ground truth: median {np.median(errors):.4f} deg, "
        f"max {errors.max():.4f} deg")
    inliers = np.array([m.twoview_info.num_verified_matches for m in matches])
    log(f"[slice] verified matches per pair: min {inliers.min()}, median {int(np.median(inliers))}, "
        f"max {inliers.max()}")

    # K1 on the slice's own inputs: checked on 8 pairs, timed at the
    # slice's full shape (the plain version pair block by pair block).
    pairs = matcher.pairs()
    d1, d2, m1, m2, _, _ = matcher.descriptor_batch(pairs)
    full = sm.streaming_inputs(d1, d2, m1, m2)
    del d1, d2
    checks.append(check_top2([x[:8] for x in full], "the slice's first 8 pairs"))
    agree = min(c[0] for c in checks)
    err = max(c[1] for c in checks)
    P, N, D = full[0].shape
    slice_ms = cuda_time_ms(lambda: sm.streaming_top2(*full), iters=3, warmup=1)
    chunks = [[x[i:i + 8] for x in full] for i in range(0, P, 8)]

    def plain_all():
        for c in chunks:
            sm.streaming_top2_reference(*c)

    slice_plain_ms = cuda_time_ms(plain_all, iters=1, warmup=1)
    slice_bound_ms, bound_by, terms = top2_bound_ms(P, N, D)
    log(f"[k1] slice shape P={P} N={N} D={D}: kernel {slice_ms:.3f} ms, plain (8-pair blocks) "
        f"{slice_plain_ms:.3f} ms, bound {slice_bound_ms:.3f} ms ({terms})")

    failures = []
    if launches < 1:
        failures.append("K1 was not launched on the slice")
    if n_ok < MIN_VERIFIED_SHARE * overlapping:
        failures.append(f"only {n_ok}/{overlapping} overlapping pairs verified")
    if separate:
        failures.append(f"{separate} pairs that share no track verified")
    if not np.median(errors) <= MAX_MEDIAN_ROTATION_DEG:
        failures.append(f"median rotation error {np.median(errors):.4f} deg")
    if failures:
        raise RuntimeError("slice checks failed: " + "; ".join(failures))

    # 4. Summary lines.
    kernels = [dict(
        name="streaming_top2",
        route="cuda",
        source="pytheiasfm_tpu_torch/csrc/streaming_top2.cu",
        replaces="pytheiasfm_tpu/matching/pallas_matcher.py:163",
        launches=launches,
        max_abs_err=err,
        agreement=agree,
        ms=slice_ms,
        plain_ms=slice_plain_ms,
        bound_ms=slice_bound_ms,
        bound_by=bound_by,
        library_ms=None,
        shape=[P, N, D],
        bench_ms=bench_ms,
        bench_plain_ms=bench_plain_ms,
        bench_bound_ms=bench_bound_ms,
        bench_bmm_ms=bench_bmm_ms,
    )]
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
