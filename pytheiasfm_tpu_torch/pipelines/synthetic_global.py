"""Synthetic Notre-Dame-scale global SfM pipeline.

Counterpart of the JAX package's `pipelines/synthetic_global.py`. The
reference's 1DSfM tables time the global pipeline per phase (Notre Dame,
553 cameras). `build_scene` synthesizes a problem at that scale: a ring of
V cameras looking at the origin, view-local tracks, and view-graph edges
carrying the ground-truth relative poses with calibrated rotation and
direction noise (the output contract of two-view verification,
`twoview_info.h:114`). Given one seed both packages build the same views,
tracks, observations and edges: the same numpy draws in the same order, the
rotation math in f64 on CPU tensors. `contaminate` corrupts a fixed share
of a view graph's edges. `run` drives `GlobalReconstructionEstimator.estimate`
on the scene and reports the per-phase seconds and the Sim(3)-aligned
position accuracy against ground truth.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import camera as cam
from ..models.intrinsics import CameraIntrinsicsModelType as M
from ..ops import rotation as rotops
from ..ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from ..sfm.view_graph import TwoViewInfo, ViewGraph
from ..transforms.alignment import align_point_clouds_umeyama

__all__ = ["build_scene", "contaminate", "position_errors", "run"]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _look_at_ring(V, rng):
    """GT cameras on a ring of radius 10 looking at the origin:
    (positions [V, 3], world->camera rotations [V, 3, 3], angle-axis [V, 3])."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, V))
    positions = np.stack(
        [10 * np.cos(angles), 10 * np.sin(angles), rng.normal(size=V) * 0.5], -1
    )
    z = -positions / np.linalg.norm(positions, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)  # world->cam
    aa = rotops.rotation_matrix_to_angle_axis(_t(R)).numpy()
    return positions, R, aa


def build_scene(
    V=553,
    T=50_000,
    obs_per_track=6,
    neighborhood=20,
    noise_px=0.5,
    edge_rot_noise_deg=0.3,
    edge_pos_noise_deg=1.0,
    min_shared_tracks=30,
    seed=0,
):
    """Build (recon, view_graph, gt_positions).

    Tracks are view-local (each picks `obs_per_track` views within a ring
    `neighborhood` of a random center view), so view pairs share realistic
    track counts; an edge joins two views sharing at least
    `min_shared_tracks` tracks.
    """
    rng = np.random.default_rng(seed)
    positions, R, aa = _look_at_ring(V, rng)
    points = rng.uniform(-3, 3, size=(T, 3))

    # Track views: center + ring-local offsets (duplicates within a row are
    # dropped by add_observations_bulk).
    centers = rng.integers(0, V, size=T)
    offs = np.zeros((T, obs_per_track), np.int64)
    for k in range(obs_per_track):
        offs[:, k] = rng.integers(-neighborhood, neighborhood + 1, size=T)
    offs[:, 0] = 0
    track_views = (centers[:, None] + offs) % V

    prior = CameraIntrinsicsPrior(
        image_width=3072,
        image_height=2048,
        focal_length=1000.0,
        principal_point=(1536.0, 1024.0),
    )
    recon = Reconstruction()
    for v in range(V):
        recon.add_view(f"view_{v:04d}", group_id=0 if v else None, prior=prior)
    recon.set_camera_intrinsics_from_priors()
    recon.add_tracks_bulk(T)

    obs_view = track_views.reshape(-1).astype(np.int32)
    obs_track = np.repeat(np.arange(T, dtype=np.int32), obs_per_track)
    ext = np.concatenate([positions, aa], axis=1)
    depth, pixel = cam.project_point(
        _t(ext[obs_view]), _t(recon.intrinsics[0]), _t(points[obs_track]), M.PINHOLE
    )
    depth = depth.numpy()
    uv = pixel.numpy() + rng.normal(size=(len(obs_view), 2)) * noise_px
    good = depth > 0.5
    recon.add_observations_bulk(obs_view[good], obs_track[good], uv[good])

    # View graph: pairs sharing >= min_shared_tracks, GT relative pose +
    # calibrated noise, the edge math batched over all edges.
    tv = track_views
    P = obs_per_track
    pairs_a = []
    pairs_b = []
    for i in range(P):
        for j in range(i + 1, P):
            a, b = tv[:, i], tv[:, j]
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            sel = lo != hi
            pairs_a.append(lo[sel])
            pairs_b.append(hi[sel])
    key = np.concatenate(pairs_a).astype(np.int64) * V + np.concatenate(pairs_b)
    uniq, counts = np.unique(key, return_counts=True)
    uniq = uniq[counts >= min_shared_tracks]
    counts = counts[counts >= min_shared_tracks]
    E = len(uniq)
    v1 = (uniq // V).astype(np.int64)
    v2 = (uniq % V).astype(np.int64)

    R12 = np.einsum("eij,ekj->eik", R[v2], R[v1])  # R2 R1^T
    ax = rng.normal(size=(E, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = np.deg2rad(rng.normal(size=E) * edge_rot_noise_deg)
    Rn = rotops.angle_axis_to_rotation_matrix(_t(ax * ang[:, None])).numpy()
    aa12 = rotops.rotation_matrix_to_angle_axis(
        _t(np.einsum("eij,ejk->eik", Rn, R12))
    ).numpy()
    t12 = np.einsum("eij,ej->ei", R[v1], positions[v2] - positions[v1])
    t12 /= np.linalg.norm(t12, axis=1, keepdims=True)
    ax2 = rng.normal(size=(E, 3))
    ax2 -= np.sum(ax2 * t12, axis=1, keepdims=True) * t12
    ax2 /= np.linalg.norm(ax2, axis=1, keepdims=True)
    ang2 = np.deg2rad(rng.normal(size=E) * edge_pos_noise_deg)
    tn = rotops.angle_axis_rotate_point(_t(ax2 * ang2[:, None]), _t(t12)).numpy()

    graph = ViewGraph()
    for e in range(E):
        info = TwoViewInfo(
            focal_length_1=1000.0,
            focal_length_2=1000.0,
            rotation_2=aa12[e],
            position_2=tn[e],
            num_verified_matches=int(counts[e]),
        )
        graph.add_edge(int(v1[e]), int(v2[e]), info)
    return recon, graph, positions


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


def position_errors(recon, gt_positions):
    """(estimated view ids, their position errors after the Umeyama Sim(3)
    alignment of the estimated positions onto `gt_positions` [V, 3])."""
    est_ids = [v for v in range(recon.num_views()) if recon.view_estimated[v]]
    est = recon.view_extrinsics[est_ids, :3]
    gt = gt_positions[est_ids]
    Ra, ta, s = align_point_clouds_umeyama(_t(est), _t(gt))
    aligned = float(s) * est @ Ra.numpy().T + ta.numpy()
    return est_ids, np.linalg.norm(aligned - gt, axis=-1)


def run(V=553, T=50_000, seed=0, estimator_type="global", calibrated=False, device=None,
        profile=False, options=None, contaminated=False, **scene):
    """Build the scene (`scene`: `build_scene`'s other arguments) and run the
    global estimator on `device` (None: the CUDA card); returns the phase
    seconds, the accuracy and the counts (one dict: the JAX package's keys,
    plus `estimated_tracks`, `estimated_views`, `ba_rounds` (the
    estimator's `bundle_adjustment_rounds`), `removed_edges` (the edges each
    filter removed), `corrupted` (the edges `contaminate` corrupted),
    `reconstruction` (the estimated container) and `stage_seconds` (each
    stage of `estimate`, host clock ending in a device synchronize)). With
    `profile`, each stage also runs under `torch.profiler`, and
    `launches` / `device_seconds` give its kernel launches and their device
    time (the profiler's own cost is then in the seconds).

    `options` replaces the reference defaults (`rng_seed=seed`); with
    `contaminated`, `contaminate` corrupts 15% of the view graph's edges
    before the estimator runs. `calibrated=True` then holds the intrinsics
    constant (XYZW tracks): the scene carries exact calibration priors and
    no distortion, and the reference's guidance for accurately known
    calibration is constant intrinsics
    (`reconstruction_estimator_options.h:277-284`); bundle adjustment then
    takes the dense Schur. The default keeps the reference-default free
    focal+radial intrinsics and XYZW_MANIFOLD tracks (the iterative Schur).
    `estimator_type` is accepted and ignored: the JAX package's `run`
    hard-codes the global estimator (`:199`), so its "incremental" runs are
    global ones (ROADMAP.md, section 3), and this copy keeps that for
    parity. The incremental and hybrid estimators run at scale through
    `tools/incremental_sfm.py`.
    """
    from ..ba.lm import OptimizeIntrinsicsType, TrackParametrizationType
    from ..sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from ..sfm.reconstruction_estimator import create_reconstruction_estimator
    from ..utils.timing import StageTimer

    t0 = time.perf_counter()
    recon, graph, gt_positions = build_scene(V=V, T=T, seed=seed, **scene)
    corrupted = contaminate(graph) if contaminated else set()
    t_build = time.perf_counter() - t0

    options = dataclasses.replace(options) if options else ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType.GLOBAL,
        rng_seed=seed,
    )
    if calibrated:
        options.intrinsics_to_optimize = OptimizeIntrinsicsType.NONE
        options.track_parametrization_type = TrackParametrizationType.XYZW
    estimator = create_reconstruction_estimator(options, device=device)
    timer = StageTimer(estimator.device, profile)
    t0 = time.perf_counter()
    summary = estimator.estimate(graph, recon, timer)
    t_total = time.perf_counter() - t0

    est_ids, err = position_errors(recon, gt_positions)
    return dict(
        success=bool(summary.success),
        views=len(est_ids),
        views_total=V,
        estimated_views=summary.estimated_views,
        tracks=recon.num_tracks(),
        estimated_tracks=len(summary.estimated_tracks),
        observations=recon.num_observations(),
        edges=graph.num_edges(),
        t_build_s=t_build,
        t_rotation_s=summary.rotation_estimation_time,
        t_position_s=summary.position_estimation_time,
        t_pose_total_s=summary.pose_estimation_time,
        t_triangulation_s=summary.triangulation_time,
        t_ba_s=summary.bundle_adjustment_time,
        t_total_s=t_total,
        median_pos_err=float(np.median(err)),
        mean_pos_err=float(np.mean(err)),
        ba_rounds=estimator.bundle_adjustment_rounds,
        removed_edges=estimator.removed_edges,
        corrupted=corrupted,
        reconstruction=recon,
        stage_seconds=timer.seconds,
        launches=timer.launches,
        device_seconds=timer.device_seconds,
    )
