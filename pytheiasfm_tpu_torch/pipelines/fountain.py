"""Feature tracks from a file -> reconstruction -> Sim(3) ATE.

Counterpart of the JAX package's `pipelines/fountain.py`, the library form
of the reference's benchmark (`docs/content/performance.md:20`: median 2.0
mm, mean 2.4 mm, 11/11 cameras on fountain-11): load serialized feature
tracks (`data/sfm/fountain11.bin`), forget all solved geometry, verify every
co-observing pair (`build_view_graph`), run a reconstruction estimator, and
report the Sim(3)-aligned camera-centre error against the ground truth
(`data/sfm/gt_fountain11.bin`), the metric of the reference's
`examples/vismatch_sfm/sfm_eval_dataset.py`. Verification and the
estimator run on `device` (None: the CUDA card); the files, the pair
assembly and the alignment are host numpy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device

__all__ = [
    "DEFAULT_FOUNTAIN",
    "DEFAULT_GT",
    "load_fountain",
    "strip_geometry",
    "build_view_graph",
    "run_estimator",
    "sim3_ate_mm",
    "evaluate",
]

DEFAULT_FOUNTAIN = "/root/reference/data/sfm/fountain11.bin"
DEFAULT_GT = "/root/reference/data/sfm/gt_fountain11.bin"

# `build_view_graph` hands pairs to `estimate_two_view_info_batch` in chunks
# of at most _CHUNK_ELEMENTS / (256 Np) pairs: the JAX package's bound on its
# [pairs, 256 hypotheses, Np] scores (the port's verifier itself goes 64
# pairs at a time).
_CHUNK_ELEMENTS = 2.5e8


def load_fountain(path: str = DEFAULT_FOUNTAIN):
    from ..io.theia_recon import read_theia_reconstruction

    return read_theia_reconstruction(path)


def strip_geometry(recon, max_tracks=None, seed=0):
    """Forget everything the reference solved: poses, points, estimated
    flags. Keep views, intrinsics priors and the observation table (the
    matched feature tracks). With `max_tracks`, keep the longest tracks."""
    recon.view_extrinsics[:] = 0.0
    recon.view_estimated[:] = False
    recon.points[:] = 0.0
    recon.track_estimated[:] = False
    recon.set_camera_intrinsics_from_priors()
    if max_tracks is not None and recon.num_tracks() > max_tracks:
        lengths = np.asarray([len(recon.track_observations(t)) for t in range(recon.num_tracks())])
        order = np.argsort(-lengths, kind="stable")
        keep = np.zeros(recon.num_tracks(), bool)
        keep[order[:max_tracks]] = True
        return _subsample_tracks(recon, keep)
    return recon


def _subsample_tracks(recon, keep):
    """A copy of the views and of the kept tracks, their observations in
    the same order (one bulk append)."""
    from ..sfm.reconstruction import Reconstruction

    out = Reconstruction(recon.dtype)
    for v in range(recon.num_views()):
        out.add_view(recon.view_names[v], group_id=int(recon.view_group[v]),
                     timestamp=recon.view_timestamps[v], prior=recon.view_priors[v])
    out.view_group = recon.view_group.copy()
    out.intrinsics = recon.intrinsics.copy()
    out.group_model = list(recon.group_model)
    kept = np.flatnonzero(keep)
    rows = [recon.track_observations(t) for t in kept]
    ids = out.add_tracks_bulk(len(kept))
    if len(kept):
        flat = np.asarray([r for rs in rows for r in rs], np.int64)
        out.add_observations_bulk(recon.obs_view[flat], np.repeat(ids, [len(r) for r in rows]),
                                  recon.obs_uv[flat], recon.obs_sqrt_inv_cov[flat])
    return out


def _pair_correspondences(recon, min_inliers):
    """Every view pair that co-observes at least `min_inliers` tracks, with
    the observation rows of those tracks in both views: sort the
    observations by track, enumerate each track's pairs by slot offsets,
    bucket them by (va, vb). Returns (pairs, {pair: (rows_a, rows_b)})."""
    O = len(recon.obs_view)
    ot = np.asarray(recon.obs_track[:O])
    order = np.argsort(ot, kind="stable")
    ot_s = ot[order]
    counts = np.bincount(ot_s, minlength=recon.num_tracks())
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    Lmax = int(counts.max()) if len(counts) else 0

    # Within-track ordered pairs (i < j) by slot offset.
    ra_list, rb_list = [], []
    pos = np.arange(len(ot_s)) - starts[ot_s]
    for d in range(1, Lmax):
        sel = (pos + d) < counts[ot_s]
        ra_list.append(order[sel])
        rb_list.append(order[np.nonzero(sel)[0] + d])
    if not ra_list:
        return [], {}
    ra = np.concatenate(ra_list)
    rb = np.concatenate(rb_list)
    va = np.asarray(recon.obs_view)[ra]
    vb = np.asarray(recon.obs_view)[rb]
    swap = va > vb
    va2, vb2 = np.where(swap, vb, va), np.where(swap, va, vb)
    ra2, rb2 = np.where(swap, rb, ra), np.where(swap, ra, rb)

    V = recon.num_views()
    key = va2.astype(np.int64) * V + vb2
    sort2 = np.argsort(key, kind="stable")
    uniq, first = np.unique(key[sort2], return_index=True)
    ends = np.append(first[1:], len(key))
    pairs, pair_rows = [], {}
    for k, lo, hi in zip(uniq, first, ends):
        if hi - lo < min_inliers:
            continue
        p = (int(k // V), int(k % V))
        pairs.append(p)
        pair_rows[p] = (ra2[sort2[lo:hi]], rb2[sort2[lo:hi]])
    return pairs, pair_rows


def _verify_chunks(generator, options, sel, priors1, priors2, pts1, pts2, masks, chunk, device):
    """`estimate_two_view_info_batch` over the pairs `sel`, `chunk` pairs a
    call."""
    from ..sfm.two_view import estimate_two_view_info_batch
    from ..utils import counters

    out = []
    for lo in range(0, len(sel), chunk):
        s = sel[lo:lo + chunk]
        counters.bump("verify_chunk")
        out += estimate_two_view_info_batch(
            generator, options, [priors1[i] for i in s], [priors2[i] for i in s],
            pts1[s], pts2[s], masks[s], device=device)
    return out


def build_view_graph(recon, seed=0, min_inliers=30, max_ransac_iterations=256, device=None):
    """Two-view geometric verification of every co-observing pair (parity:
    the matcher -> EstimateTwoViewInfo loop of `pytests/sfm_pipeline.py:136`
    driven from the track table), on `device` (None: the CUDA card), with
    RANSAC samples from a `torch.Generator` seeded by `seed`.

    Two-rung adaptive budget, the batched form of the reference's adaptive
    termination (`ComputeMaxIterations`, `sample_consensus_estimator.h`):
    every pair first gets 64 hypotheses; a pair whose adaptive requirement
    at its observed inlier ratio exceeds 64 is verified again at the full
    budget. The JAX package also pads every chunk to one shape for its
    compiled program; nothing here needs that.
    """
    from ..sfm.two_view import EstimateTwoViewInfoOptions
    from ..sfm.view_graph import ViewGraph

    device = default_device(device)
    pairs, pair_rows = _pair_correspondences(recon, min_inliers)
    if not pairs:
        return ViewGraph()
    N = max(len(pair_rows[k][0]) for k in pairs)
    Np = 1 << (N - 1).bit_length()
    P = len(pairs)
    chunk = min(P, max(1, int(_CHUNK_ELEMENTS // (256 * Np))))

    pts1 = np.zeros((P, Np, 2))
    pts2 = np.zeros((P, Np, 2))
    masks = np.zeros((P, Np), bool)
    priors1, priors2 = [], []
    for i, (va, vb) in enumerate(pairs):
        ra, rb = pair_rows[(va, vb)]
        n = len(ra)
        pts1[i, :n] = recon.obs_uv[ra]
        pts2[i, :n] = recon.obs_uv[rb]
        masks[i, :n] = True
        priors1.append(recon.view_priors[va])
        priors2.append(recon.view_priors[vb])

    generator = torch.Generator(device=device).manual_seed(seed)
    rung1 = min(64, max_ransac_iterations)
    opts1 = EstimateTwoViewInfoOptions(max_ransac_iterations=rung1)
    everything = np.arange(P)
    results = _verify_chunks(generator, opts1, everything, priors1, priors2, pts1, pts2, masks,
                             chunk, device)
    if max_ransac_iterations > rung1:
        confidence = 1.0 - opts1.expected_ransac_confidence
        redo = []
        for i, (va, vb) in enumerate(pairs):
            info, inliers = results[i]
            n = len(pair_rows[(va, vb)][0])
            ninl = 0 if info is None else len(inliers)
            p_good = max(ninl / max(n, 1), 1e-9) ** 5
            needed = np.log(confidence) / min(np.log1p(-min(p_good, 1 - 1e-12)), -1e-12)
            if needed > rung1:
                redo.append(i)
        if redo:
            opts2 = EstimateTwoViewInfoOptions(max_ransac_iterations=max_ransac_iterations)
            redo = np.asarray(redo)
            again = _verify_chunks(generator, opts2, redo, priors1, priors2, pts1, pts2, masks,
                                   chunk, device)
            for i, res in zip(redo, again):
                results[i] = res
    graph = ViewGraph()
    for (va, vb), (info, inliers) in zip(pairs, results):
        if info is None or len(inliers) < min_inliers:
            continue
        info.num_verified_matches = len(inliers)
        graph.add_edge(va, vb, info)
    return graph


def run_estimator(recon, graph, estimator_type: str = "global", seed: int = 0,
                  calibrated: bool = False, device=None):
    """The reconstruction estimator on `device` (None: the CUDA card).
    `calibrated=True` holds the intrinsics at their priors (XYZW tracks),
    the reference's Strecha methodology (its fountain-11 benchmark reads
    per-camera calibration files, performance.md:12); the default keeps the
    reference-default free focal + radial configuration."""
    from ..ba.lm import OptimizeIntrinsicsType, TrackParametrizationType
    from ..sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from ..sfm.reconstruction_estimator import create_reconstruction_estimator

    options = ReconstructionEstimatorOptions(
        reconstruction_estimator_type={
            "global": ReconstructionEstimatorType.GLOBAL,
            "incremental": ReconstructionEstimatorType.INCREMENTAL,
            "hybrid": ReconstructionEstimatorType.HYBRID,
        }[estimator_type],
        rng_seed=seed,
    )
    if calibrated:
        options.intrinsics_to_optimize = OptimizeIntrinsicsType.NONE
        options.track_parametrization_type = TrackParametrizationType.XYZW
    estimator = create_reconstruction_estimator(options, device=default_device(device))
    return estimator.estimate(graph, recon)


def sim3_ate_mm(recon, gt_recon):
    """Sim(3)-align the estimated camera centres to the ground truth's by
    view name (Umeyama, f64); return (the position errors in mm, the number
    of cameras compared) (parity: sfm_eval_dataset.py)."""
    from ..transforms.alignment import align_point_clouds_umeyama

    est, gt = [], []
    for v in range(recon.num_views()):
        if not recon.view_estimated[v]:
            continue
        g = gt_recon.view_id_from_name(recon.view_names[v])
        if g < 0:
            continue
        est.append(recon.view_extrinsics[v, :3])
        gt.append(gt_recon.view_extrinsics[g, :3])
    est = np.asarray(est)
    gt = np.asarray(gt)
    R, t, s = align_point_clouds_umeyama(torch.as_tensor(est, dtype=torch.float64),
                                         torch.as_tensor(gt, dtype=torch.float64))
    aligned = float(s) * est @ R.numpy().T + t.numpy()
    return np.linalg.norm(aligned - gt, axis=-1) * 1000.0, len(est)


def evaluate(
    estimator_type: str = "global",
    max_tracks=None,
    seed: int = 0,
    fountain_path: str = DEFAULT_FOUNTAIN,
    gt_path: str = DEFAULT_GT,
    _base_recon=None,
    calibrated: bool = False,
    device=None,
):
    """One tracks -> reconstruction -> ATE run on `device` (None: the CUDA
    card), with the seconds of each phase."""
    from ..io.theia_recon import read_theia_reconstruction
    from ..utils import counters

    device = default_device(device)
    counters.reset()
    t_all = time.perf_counter()
    recon = _base_recon if _base_recon is not None else load_fountain(fountain_path)
    gt = read_theia_reconstruction(gt_path)
    recon = strip_geometry(recon, max_tracks=max_tracks, seed=seed)

    t0 = time.perf_counter()
    graph = build_view_graph(recon, seed=seed, device=device)
    t_verify = time.perf_counter() - t0

    t0 = time.perf_counter()
    summary = run_estimator(recon, graph, estimator_type, seed, calibrated, device=device)
    t_sfm = time.perf_counter() - t0

    err_mm, n_est = sim3_ate_mm(recon, gt)
    return dict(
        dispatch_counts=counters.snapshot(),
        dispatch_total=counters.total(),
        median_mm=float(np.median(err_mm)),
        mean_mm=float(np.mean(err_mm)),
        max_mm=float(np.max(err_mm)),
        cameras=n_est,
        gt_cameras=gt.num_views(),
        edges=graph.num_edges(),
        tracks_used=recon.num_tracks(),
        t_verify_s=t_verify,
        t_sfm_s=t_sfm,
        t_sfm_rotation_s=summary.rotation_estimation_time,
        t_sfm_position_s=summary.position_estimation_time,
        t_sfm_pose_s=summary.pose_estimation_time,
        t_sfm_triangulation_s=summary.triangulation_time,
        t_sfm_ba_s=summary.bundle_adjustment_time,
        t_total_s=time.perf_counter() - t_all,
        success=bool(summary.success),
    )
