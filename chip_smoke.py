#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's matching slice on one CUDA card.

    python3 chip_smoke.py

Phases, each printed (flushed) as it ends:
  1. build every kernel of the port from `pytheiasfm_tpu_torch/csrc/`
     (one nvcc per source, all at once), print what ptxas reports, and
     count the `wgmma` instructions (HGMMA) in each kernel's machine code;
  2. hold each kernel against its plain PyTorch version on the card and time
     both, with the one PyTorch call that computes the same function where
     there is one: K1 (`streaming_top2`) at the bench shape and at N=64; K2
     (`matmul_rowmin`) at P=8, N=4096 for D in {128, 256, 512} and at N=64,
     each with the bytes a launch reads through L2 by the kernel's tile
     sizes;
     then drive K2's own path, the roofline sweep
     (`tools.exp_matcher_roofline.main`), with its launch count set to 0
     just before and read just after;
  3. drive `FeatureMatcher.match_images` at full width on a ring scene of
     32 calibrated views (4096 features x 128-D descriptors each, all 496
     pairs), each run with K1's launch count set to 0 just before and read
     just after, and check it against ground truth:
       a. stage 1 of verification alone (`bundle_adjustment=False`);
       b. the default options (stage 2: triangulation gate + two-view BA);
       c. the default options with the guided epipolar rematch, whose
          chunks are recorded: the first ones are held against the same
          rematch on the CPU, index for index, and the correspondences it
          adds are counted;
     then check K1 on the slice's own inputs and time it at the slice's
     shape;
  4. print a {"kernels": [...]} line, the card's name and power limit, and
     last the {"ok": true, "device": ...} line.

It imports nothing of JAX. Without a CUDA card, or outside the repository,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pytheiasfm_tpu_torch.matching import (
    FeatureMatcher,
    FeatureMatcherOptions,
    matcher as matcher_module,
    streaming_matcher as sm,
)
from pytheiasfm_tpu_torch.matching.guided_epipolar import guided_epipolar_match
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from pytheiasfm_tpu_torch.tools import exp_matcher_roofline as k2
from pytheiasfm_tpu_torch.tools import ring_scene as rs
from pytheiasfm_tpu_torch.utils import cuda_build
from pytheiasfm_tpu_torch.utils.timing import cuda_time_ms

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# K1's bench shape's descriptor noise (d2 is a noisy copy of d1).
BENCH_NOISE = 0.05

# Bars of the slice. Stage 1 keeps the best of 1000 minimal five-point
# models unrefined: at 0.5 px noise such a model is off by tenths of a
# degree, so stage 1 alone is held at 0.3 deg. Stage 2 refines each pair
# with a two-view bundle adjustment and is held at 0.1 deg, and below
# stage 1's median.
MIN_VERIFIED_SHARE = 0.9
MAX_MEDIAN_ROTATION_DEG_STAGE1 = 0.3
MAX_MEDIAN_ROTATION_DEG = 0.1
MIN_TRACK_SHARE = 0.98
# The guided rematch adds, for a still unmatched feature of view 1 whose
# epipolar band in view 2 holds exactly one unmatched feature, that feature:
# the second best is then +inf and passes Lowe's test. The JAX reference
# does the same (`matching/guided_epipolar.py:65-73`), and on this scene,
# where stage 1 already finds every co-visible track pair, every such
# correspondence is wrong; they lie on their epipolar lines, so two-view
# geometry keeps them. This is a fault of the reference (ROADMAP.md,
# section 3). The guided run is held to MIN_TRACK_SHARE on the rest of its
# correspondences; the ones that rule added are counted and printed.
GUIDED_CHUNKS_CHECKED = 2  # rematch chunks (4 pairs each) held against the CPU
MIN_AGREEMENT = 0.999
MAX_ABS_ERR = 1e-4  # K1: distances are O(1)
K2_REL_TOL = 1e-4  # K2: max |delta| <= 1e-4 * (1 + |ref|)
# K2 at P=8, N=4096 by depth, in ms: the mma.sync (WMMA) kernel that the
# present one replaced, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
# section 6). Printed in the log beside this run's times; it is no
# measurement of this run, so it stays out of the `kernels` line.
K2_PREV_MS = {128: 0.3393, 256: 0.6158, 512: 1.2351}
# K1 at P=8, N=4096, D=128 and at the slice's P=496, in ms: the WMMA kernel
# with a partial-buffer pass that the present one replaced, on the same card
# (PERF.md, section 6). Printed in the log only, as K2_PREV_MS is.
K1_PREV_MS = {8: 0.5972, 496: 33.080}


def log(*args):
    print(*args, flush=True)


def bound(ops: float, nbytes: float) -> tuple[float, str, str]:
    """Least time for `ops` bf16 operations and `nbytes` of memory traffic:
    (bound ms, what bounds it, both terms as text)."""
    ops_ms = 1e3 * ops / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    terms = f"operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms"
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", terms


def top2_bound_ms(P: int, N: int, D: int):
    """K1: 2 P N^2 D operations against reading the bf16 descriptors and f32
    norms once and writing six [P, N] outputs."""
    return bound(2.0 * P * N * N * D, 2 * P * N * D * 2 + 2 * P * N * 4 + 6 * P * N * 4)


def rowmin_bound_ms(P: int, N: int, D: int):
    """K2: 2 P N^2 D operations against reading both bf16 operands once and
    writing one [P, N] f32 output."""
    return bound(2.0 * P * N * N * D, 2 * P * N * D * 2 + P * N * 4)


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


def check_rowmin(d1, d2t, label):
    """K2 against its plain version: max |delta| and the worst ratio of
    |delta| to its bar 1e-4 * (1 + |ref|)."""
    got = k2.matmul_rowmin(d1, d2t)
    torch.cuda.synchronize()
    want = k2.matmul_rowmin_reference(d1, d2t)
    delta = (got - want).abs()
    err = delta.max().item()
    worst = (delta / (K2_REL_TOL * (1 + want.abs()))).max().item()
    log(f"[k2] {label}: max |delta| {err:.3e}, worst |delta| / bar {worst:.3f}")
    if not worst <= 1.0:
        raise RuntimeError(f"K2 disagrees with its plain version at {label}")
    return err


def phase_kernels(dev):
    """Phase 2: both kernels against their plain versions, timed; then K2's
    own path. Returns the kernel-line entries' measurements."""
    bench = top2_inputs(8, 4096, 128, seed=1, device=dev)
    small = top2_inputs(8, 64, 128, seed=2, device=dev)
    k1_checks = [check_top2(bench, "P=8 N=4096 D=128"), check_top2(small, "P=8 N=64 D=128")]
    k1 = dict(
        bench_ms=cuda_time_ms(lambda: sm.streaming_top2(*bench), iters=20),
        bench_plain_ms=cuda_time_ms(lambda: sm.streaming_top2_reference(*bench), iters=5),
    )
    b1t = bench[1].mT
    k1["bench_bmm_ms"] = cuda_time_ms(lambda: torch.bmm(bench[0], b1t), iters=20)
    k1["bench_bound_ms"], _, terms = top2_bound_ms(8, 4096, 128)
    l2_bytes = sm.l2_bytes_per_launch(8, 4096, 128)
    log(f"[k1] P=8 N=4096 D=128: kernel {k1['bench_ms']:.4f} ms (the kernel it replaced "
        f"{K1_PREV_MS[8]:.4f} ms), plain {k1['bench_plain_ms']:.4f} ms, torch.bmm (product "
        f"alone) {k1['bench_bmm_ms']:.4f} ms, bound {k1['bench_bound_ms']:.4f} ms ({terms}); "
        f"{l2_bytes / 1e9:.3f} GB through L2 a launch, reckoned from the tile sizes (with this "
        f"time that implies {l2_bytes / k1['bench_ms'] / 1e9:.2f} TB/s; not a counter)")
    del bench, small, b1t

    errs = [check_rowmin(*k2.inputs(128, seed=9, device=dev, n=64), "P=8 N=64 D=128")]
    depths = []
    for D in k2.DEPTHS:
        d1, d2t = k2.inputs(D, seed=D, device=dev)
        errs.append(check_rowmin(d1, d2t, f"P=8 N=4096 D={D}"))
        ms = cuda_time_ms(lambda: k2.matmul_rowmin(d1, d2t), iters=30, warmup=3)
        plain_ms = cuda_time_ms(lambda: k2.matmul_rowmin_reference(d1, d2t), iters=5)
        library_ms = cuda_time_ms(lambda: torch.bmm(d1, d2t).amin(-1), iters=30, warmup=3)
        bound_ms, bound_by, terms = rowmin_bound_ms(k2.P, k2.N, D)
        l2_bytes = k2.l2_bytes_per_launch(k2.P, k2.N, D)
        log(f"[k2] P=8 N=4096 D={D}: kernel {ms:.4f} ms "
            f"({2.0 * k2.P * k2.N**2 * D / ms / 1e9:.1f} TF/s; the kernel it replaced "
            f"{K2_PREV_MS[D]:.4f} ms), plain {plain_ms:.4f} ms, "
            f"torch.bmm + amin {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({terms}); "
            f"{l2_bytes / 1e9:.3f} GB through L2 a launch, reckoned from the tile sizes "
            f"(with this time that implies {l2_bytes / ms / 1e9:.2f} TB/s; not a counter)")
        depths.append(dict(D=D, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by))
        del d1, d2t

    k2.matmul_rowmin.launches = 0
    k2.main(["--iters", "10"])
    torch.cuda.synchronize()
    k2_launches = k2.matmul_rowmin.launches
    log(f"[k2] roofline sweep: K2 launches {k2_launches}")
    if k2_launches < 1:
        raise RuntimeError("K2 was not launched by its roofline sweep")
    return k1, k1_checks, dict(launches=k2_launches, max_abs_err=max(errs), depths=depths)


def run_slice(views, prior, label, **gv):
    """One `match_images` run on the ring scene with the given verification
    options; returns (matches, matcher, K1 launches, wall seconds)."""
    options = FeatureMatcherOptions()
    for key, value in gv.items():
        setattr(options.geometric_verification_options, key, value)
    matcher = FeatureMatcher(options)  # the user's default device: the card
    for v, (kps, desc) in enumerate(views):
        matcher.add_image(rs.view_name(v), kps, desc, prior)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sm.streaming_top2.launches = 0
    t0 = time.perf_counter()
    matches = matcher.match_images()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sm.streaming_top2.launches
    times = ", ".join(f"{k} {v:.3f} s" for k, v in matcher.timings.items())
    log(f"[slice {label}] match_images: {wall:.3f} s ({times}); K1 launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return matches, matcher, launches, wall


class RematchRecorder:
    """Stands in for `guided_epipolar_match` inside `match_images`: calls
    it, and keeps each chunk's inputs and output for the checks after the
    run (the descriptors of the first GUIDED_CHUNKS_CHECKED chunks only)."""

    def __init__(self):
        self.calls = []

    def __call__(self, F, points1, points2, d1, d2, *rest):
        idx = guided_epipolar_match(F, points1, points2, d1, d2, *rest)
        if len(self.calls) >= GUIDED_CHUNKS_CHECKED:
            d1 = d2 = None
        self.calls.append(((F, points1, points2, d1, d2, *rest), idx))
        return idx


def check_rematch(recorder):
    """Run c's guided rematch: its first chunks on the card against the same
    inputs on the CPU, index for index; the correspondences it added; and
    the added ones whose epipolar band held one candidate. Returns (those
    as a set of f32 (x1, y1, x2, y2) rows in bytes, failures)."""
    differ, rows = 0, 0
    for args, idx in recorder.calls[:GUIDED_CHUNKS_CHECKED]:
        want = guided_epipolar_match(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        differ += int((idx.cpu() != want).sum())
        rows += want.numel()
    added, lone = 0, set()
    for (F, points1, points2, _, _, *rest), idx in recorder.calls:
        # With every descriptor equal, Lowe's test passes exactly where the
        # second best is +inf: the rows whose band holds one candidate.
        zeros1 = torch.zeros((*points1.shape[:-1], 1), device=points1.device)
        zeros2 = torch.zeros((*points2.shape[:-1], 1), device=points2.device)
        single = guided_epipolar_match(F, points1, points2, zeros1, zeros2, *rest) >= 0
        added += int((idx >= 0).sum())
        p, i = torch.nonzero((idx >= 0) & single, as_tuple=True)
        pairs = torch.cat([points1[p, i], points2[p, idx[p, i].long()]], dim=-1)
        lone.update(row.tobytes() for row in pairs.cpu().numpy())
    log(f"[slice c: guided] rematch: {len(recorder.calls)} chunks, {added} correspondences "
        f"added, {len(lone)} of them the only candidate in their epipolar band; "
        f"card against CPU on the first {GUIDED_CHUNKS_CHECKED} chunks: {differ}/{rows} "
        f"rows differ")
    failures = []
    if added < 1:
        failures.append("guided run: the rematch added no correspondence")
    if differ > (1 - MIN_AGREEMENT) * rows:
        failures.append(f"guided run: the rematch on the card differs from the CPU in "
                        f"{differ}/{rows} rows")
    return lone, failures


def check_slice(label, matches, matcher, launches, rots, views, track_ids, lone=frozenset()):
    """Ground truth: verified pairs, rotation errors, verified
    correspondences on a common track, held to MIN_TRACK_SHARE without the
    `lone` ones (see `check_rematch`). Returns (median rotation error,
    median verified matches, correspondences on a track, failures)."""
    verified = {(m.image1, m.image2): m for m in matches}
    index = {rs.view_name(v): v for v in range(rs.NUM_VIEWS)}
    overlapping, separate, errors = 0, 0, []
    for a in range(rs.NUM_VIEWS):
        for b in range(a + 1, rs.NUM_VIEWS):
            m = verified.get((rs.view_name(a), rs.view_name(b)))
            if not rs.shares_tracks(a, b):
                separate += m is not None
                continue
            overlapping += 1
            if m is not None:
                errors.append(rs.rotation_error_deg(m.twoview_info.rotation_2, rots[b] @ rots[a].T))
    errors = np.array(errors)
    on_track, total, lone_on_track, lone_total = 0, 0, 0, 0
    for m in matches:
        a, b = index[m.image1], index[m.image2]
        t1 = rs.track_ids_of(m.correspondences1, views[a][0], track_ids[a])
        t2 = rs.track_ids_of(m.correspondences2, views[b][0], track_ids[b])
        on = (t1 == t2) & (t1 >= 0)
        on_track += int(np.sum(on))
        total += len(t1)
        if lone:
            rows = np.concatenate([m.correspondences1, m.correspondences2], 1).astype(np.float32)
            is_lone = np.array([row.tobytes() in lone for row in rows], bool)
            lone_on_track += int(np.sum(on & is_lone))
            lone_total += int(np.sum(is_lone))
    track_share = (on_track - lone_on_track) / max(total - lone_total, 1)
    inliers = np.array([m.twoview_info.num_verified_matches for m in matches])
    n_ok = len(errors)
    median_err = float(np.median(errors)) if n_ok else float("inf")
    log(f"[slice {label}] verified {n_ok}/{overlapping} pairs that share tracks, "
        f"{separate}/{len(matcher.pairs()) - overlapping} that share none; relative rotation "
        f"error vs ground truth: median {median_err:.4f} deg, "
        f"max {errors.max() if n_ok else float('inf'):.4f} deg")
    log(f"[slice {label}] verified matches per pair: min {inliers.min()}, median "
        f"{int(np.median(inliers))}, max {inliers.max()}; {on_track}/{total} verified "
        f"correspondences ({on_track / max(total, 1):.4%}) join features of one track")
    if lone:
        log(f"[slice {label}] {lone_total} of them were the only candidate in their "
            f"epipolar band ({lone_on_track} on a track); the other "
            f"{total - lone_total}: {track_share:.4%} on a track")
    failures = []
    if launches < 1:
        failures.append(f"{label}: K1 was not launched")
    if n_ok < MIN_VERIFIED_SHARE * overlapping:
        failures.append(f"{label}: only {n_ok}/{overlapping} overlapping pairs verified")
    if separate:
        failures.append(f"{label}: {separate} pairs that share no track verified")
    if track_share < MIN_TRACK_SHARE:
        failures.append(f"{label}: only {track_share:.4%} of verified correspondences on a track")
    return median_err, float(np.median(inliers)), on_track, failures


def phase_slice(dev):
    """Phase 3: the three runs of `match_images`, then K1 on the slice's
    inputs. Returns K1's slice measurements."""
    t0 = time.perf_counter()
    views, rots, track_ids = rs.ring_scene()
    log(f"[slice] ring scene: {rs.NUM_VIEWS} views x {rs.NUM_FEATURES} features x "
        f"{rs.DESC_DIM}-D, {rs.NUM_TRACKS} tracks, made in {time.perf_counter() - t0:.2f} s")
    prior = CameraIntrinsicsPrior(
        image_width=rs.WIDTH, image_height=rs.HEIGHT, focal_length=rs.FOCAL
    )
    failures = []
    runs = {}
    recorder = RematchRecorder()
    for label, gv in (
        ("a: stage 1", dict(bundle_adjustment=False)),
        ("b: default", dict()),
        ("c: guided", dict(guided_matching=True)),
    ):
        lone = frozenset()
        if gv.get("guided_matching"):
            matcher_module.guided_epipolar_match = recorder
        try:
            matches, matcher, launches, _ = run_slice(views, prior, label, **gv)
        finally:
            matcher_module.guided_epipolar_match = guided_epipolar_match
        if recorder.calls:
            lone, f = check_rematch(recorder)
            failures += f
            recorder.calls.clear()
        median_err, median_inl, on_track, f = check_slice(
            label, matches, matcher, launches, rots, views, track_ids, lone
        )
        failures += f
        runs[label[0]] = (median_err, median_inl, launches, on_track)
        del matches
    if not runs["a"][0] <= MAX_MEDIAN_ROTATION_DEG_STAGE1:
        failures.append(f"stage 1: median rotation error {runs['a'][0]:.4f} deg")
    for key in "bc":
        if not (runs[key][0] <= MAX_MEDIAN_ROTATION_DEG and runs[key][0] < runs["a"][0]):
            failures.append(f"run {key}: median rotation error {runs[key][0]:.4f} deg "
                            f"(stage 1: {runs['a'][0]:.4f} deg)")
    if runs["c"][1] < runs["b"][1]:
        failures.append(f"guided run: median verified matches {runs['c'][1]} < {runs['b'][1]}")
    if runs["c"][3] < runs["b"][3]:
        failures.append(f"guided run: {runs['c'][3]} correspondences on a track < {runs['b'][3]}")
    if failures:
        raise RuntimeError("slice checks failed: " + "; ".join(failures))

    # K1 on the slice's own inputs: checked on 8 pairs, timed at the
    # slice's full shape (the plain version pair block by pair block).
    pairs = matcher.pairs()
    d1, d2, m1, m2, _, _ = matcher.descriptor_batch(pairs)
    full = sm.streaming_inputs(d1, d2, m1, m2)
    del d1, d2
    check = check_top2([x[:8] for x in full], "the slice's first 8 pairs")
    P, N, D = full[0].shape
    slice_ms = cuda_time_ms(lambda: sm.streaming_top2(*full), iters=3, warmup=1)
    chunks = [[x[i:i + 8] for x in full] for i in range(0, P, 8)]

    def plain_all():
        for c in chunks:
            sm.streaming_top2_reference(*c)

    slice_plain_ms = cuda_time_ms(plain_all, iters=1, warmup=1)
    slice_bound_ms, bound_by, terms = top2_bound_ms(P, N, D)
    l2_bytes = sm.l2_bytes_per_launch(P, N, D)
    log(f"[k1] slice shape P={P} N={N} D={D}: kernel {slice_ms:.3f} ms (the kernel it replaced "
        f"{K1_PREV_MS[496]:.3f} ms at P=496), plain (8-pair blocks) {slice_plain_ms:.3f} ms, "
        f"bound {slice_bound_ms:.3f} ms ({terms}); {l2_bytes / 1e9:.2f} GB through L2 a launch, "
        f"reckoned from the tile sizes ({l2_bytes / slice_ms / 1e9:.2f} TB/s implied; not a "
        f"counter)")
    return dict(launches=runs["b"][2], check=check, shape=[P, N, D], ms=slice_ms,
                plain_ms=slice_plain_ms, bound_ms=slice_bound_ms, bound_by=bound_by)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke.py: no CUDA card; this script needs one")
        return 2
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    cuda_build.build_libraries([sm.KERNEL, k2.KERNEL])
    log(f"[build] {sm.KERNEL}, {k2.KERNEL}: {time.perf_counter() - t0:.2f} s")
    for name in (sm.KERNEL, k2.KERNEL):
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in (sm.KERNEL, k2.KERNEL):
        spills = re.findall(r"(\d+) bytes spill", cuda_build.build_log(name))
        hgmma = cuda_build.sass(name).count("HGMMA")
        log(f"[build] {name}: {hgmma} HGMMA (wgmma) instructions in the built library")
        if hgmma < 1 or not spills or any(int(n) for n in spills):
            raise RuntimeError(f"{name}: no wgmma in the built library, or ptxas spilled")

    # 2. Kernels against their plain versions; K2's own path.
    k1, k1_checks, rowmin = phase_kernels(dev)

    # 3. The slice at full width.
    sl = phase_slice(dev)
    k1_checks.append(sl["check"])

    # 4. Summary lines.
    d128 = next(d for d in rowmin["depths"] if d["D"] == 128)
    kernels = [
        dict(
            name="streaming_top2",
            route="cuda",
            source="pytheiasfm_tpu_torch/csrc/streaming_top2.cu",
            replaces="pytheiasfm_tpu/matching/pallas_matcher.py:163",
            launches=sl["launches"],
            max_abs_err=max(c[1] for c in k1_checks),
            agreement=min(c[0] for c in k1_checks),
            ms=sl["ms"],
            plain_ms=sl["plain_ms"],
            bound_ms=sl["bound_ms"],
            bound_by=sl["bound_by"],
            library_ms=None,
            shape=sl["shape"],
            **k1,
        ),
        dict(
            name="matmul_rowmin",
            route="cuda",
            source="pytheiasfm_tpu_torch/csrc/matmul_rowmin.cu",
            replaces="tools/exp_matcher_roofline.py:36",
            launches=rowmin["launches"],
            max_abs_err=rowmin["max_abs_err"],
            ms=d128["ms"],
            plain_ms=d128["plain_ms"],
            bound_ms=d128["bound_ms"],
            bound_by=d128["bound_by"],
            library_ms=d128["library_ms"],
            shape=[k2.P, k2.N, 128],
            by_depth=rowmin["depths"],
        ),
    ]
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
