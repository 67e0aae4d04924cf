"""Shared helpers for the reconstruction estimators.

Counterpart of the JAX package's `sfm/reconstruction_estimator_utils.py`
(`theia/sfm/reconstruction_estimator_utils.{h,cc}`,
`set_outlier_tracks_to_unestimated.{h,cc}`). The reprojection errors of
the whole scene are one batched pass over the observation table on the
device; the per-track outlier statistics reduce there by segment sums
(`index_add_`) and come back in one copy; the angle test and the
under-constrained filters run on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..ops import rotation as rotops
from ..ops.segment import segment_sum

__all__ = [
    "compute_reprojection_errors",
    "set_outlier_tracks_to_unestimated",
    "set_underconstrained_tracks_to_unestimated",
    "set_underconstrained_views_to_unestimated",
    "num_estimated_views",
    "num_estimated_tracks",
    "set_reconstruction_from_estimated_poses",
    "relative_rotations_from_view_graph",
    "create_estimated_subreconstruction",
    "compute_resolution_scaled_threshold",
]

kMinNumObservingViews = 2  # reconstruction_estimator_utils.cc:292
kMinNumObservedTracks = 3  # reconstruction_estimator_utils.cc:323


def compute_resolution_scaled_threshold(
    threshold_pixels: float, image_width: int, image_height: int
) -> float:
    """Parity: `theia::ComputeResolutionScaledThreshold`: thresholds are
    calibrated for a 1024-px image and scale with its larger side."""
    max_dim = max(image_width, image_height)
    if max_dim <= 0:
        return threshold_pixels
    return threshold_pixels * max_dim / 1024.0


def _reproject_all_kernel(ext, intrinsics, pts4, obs_view, obs_track, uv, obs_group,
                          model_idx, present_models: tuple):
    """(squared pixel error, camera-frame depth) of every observation row,
    on the device of the inputs."""
    from ..ba.lm import _pixel_of

    p4 = pts4[obs_track]
    w = p4[:, 3:4]
    p3 = p4[:, :3] / torch.where(torch.abs(w) < 1e-12, torch.ones_like(w), w)
    e6 = ext[obs_view]
    p_cam = rotops.angle_axis_rotate_point(e6[:, 3:], p3 - e6[:, :3])
    pixel = _pixel_of(intrinsics[obs_group], p_cam, present_models, model_idx)
    return torch.sum((pixel - uv) ** 2, dim=-1), p_cam[:, 2]


def _obs_tensors(recon, device):
    """The observation table on `device`: (view, track, uv, group, model
    index into the present models, present models)."""
    groups = recon.view_group[recon.obs_view]
    present = tuple(sorted({int(m) for m in recon.group_model} or {0}))
    midx = np.asarray([present.index(int(m)) for m in recon.group_model], np.int64)[groups]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return (t(recon.obs_view.astype(np.int64)), t(recon.obs_track.astype(np.int64)),
            t(np.asarray(recon.obs_uv, recon.dtype)), t(groups.astype(np.int64)), t(midx),
            present)


def _state_tensors(recon, device):
    def t(a):
        return torch.as_tensor(np.asarray(a, recon.dtype), device=device)

    return t(recon.view_extrinsics), t(recon.intrinsics), t(recon.points)


def compute_reprojection_errors(recon, rows: np.ndarray | None = None, device=None):
    """Squared pixel reprojection error and depth of each observation row
    (all rows, or `rows`), computed for the whole table in one pass.
    `device`: None means the CUDA card."""
    from ..utils import counters

    if recon.num_observations() == 0:
        rows = np.asarray([], np.int64) if rows is None else np.asarray(rows)
        return (np.full((len(rows),), np.inf, recon.dtype),
                np.zeros((len(rows),), recon.dtype))
    device = default_device(device)
    ov, ot, uv, grp, midx, present = _obs_tensors(recon, device)
    counters.bump("reproject_launch")
    e, d = _reproject_all_kernel(*_state_tensors(recon, device), ov, ot, uv, grp, midx, present)
    err_all, depth_all = e.cpu().numpy(), d.cpu().numpy()
    if rows is None:
        return err_all, depth_all
    rows = np.asarray(rows)
    return err_all[rows], depth_all[rows]


def _track_outlier_aggregates(recon, row_mask: np.ndarray, device):
    """Per-track (sum of squared reprojection errors, observation count,
    any observation behind its camera) over the masked rows, [3, T] f64."""
    ov, ot, uv, grp, midx, present = _obs_tensors(recon, device)
    err, depth = _reproject_all_kernel(*_state_tensors(recon, device), ov, ot, uv, grp, midx,
                                       present)
    m = torch.as_tensor(row_mask, device=device)
    mf = m.to(err.dtype)
    T = recon.num_tracks()
    sum_err = segment_sum(err * mf, ot, T)
    cnt = segment_sum(mf, ot, T)
    bad = segment_sum((m & (depth < 0)).to(err.dtype), ot, T)
    return torch.stack([sum_err, cnt, bad]).cpu().numpy().astype(np.float64)


def set_outlier_tracks_to_unestimated(
    recon,
    max_inlier_reprojection_error: float,
    min_triangulation_angle_degrees: float,
    track_ids=None,
    device=None,
) -> int:
    """Parity: `theia::SetOutlierTracksToUnestimated`
    (`set_outlier_tracks_to_unestimated.cc`): an estimated track is dropped
    when an estimated observing view sees it behind the camera, when its
    MEAN squared reprojection error exceeds the threshold squared, or when
    its best pair of viewing rays subtends less than the minimum angle.
    Returns the number dropped. `device`: None means the CUDA card."""
    max_sq = max_inlier_reprojection_error ** 2
    min_cos = np.cos(np.deg2rad(min_triangulation_angle_degrees))
    T = recon.num_tracks()
    cand = np.zeros(T, bool)
    if track_ids is None:
        cand[:] = recon.track_estimated
    else:
        ids = np.asarray(list(track_ids), np.int64)
        if len(ids):
            cand[ids[recon.track_estimated[ids]]] = True
    if not cand.any():
        return 0
    ov, ot = recon.obs_view, recon.obs_track
    row_mask = cand[ot] & recon.view_estimated[ov]
    rows = np.where(row_mask)[0]
    if len(rows) == 0:
        return 0
    from ..utils import counters

    counters.bump("reproject_launch")
    agg = _track_outlier_aggregates(recon, row_mask, default_device(device))
    sum_err, cnt, bad_depth = agg[0], agg[1], agg[2] > 0.5
    seen = cnt > 0
    drop = bad_depth | (sum_err > max_sq * np.maximum(cnt, 1.0))

    # Viewing-angle test of the survivors in a padded [Tc, L] slot layout
    # (the best pair of rays must subtend the minimum angle), on the host.
    tracks = ot[rows]
    need = np.where(seen & ~drop & cand)[0]
    if len(need):
        sub = rows[np.isin(tracks, need)]
        st = ot[sub]
        order = np.argsort(st, kind="stable")
        sub, st = sub[order], st[order]
        tmap = np.full(T, -1, np.int64)
        tmap[need] = np.arange(len(need))
        stc = tmap[st]
        counts = np.bincount(stc, minlength=len(need))
        L = max(int(counts.max()), 1)
        starts = np.zeros(len(need) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(sub)) - starts[stc]
        w = recon.points[need, 3:4]
        pts3 = recon.points[need, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)
        dirs = np.zeros((len(need), L, 3))
        valid = np.zeros((len(need), L), bool)
        d = pts3[stc] - recon.view_extrinsics[ov[sub], :3]
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        dirs[stc, pos] = d / np.where(n < 1e-12, 1.0, n)
        valid[stc, pos] = True
        cosang = np.einsum("tli,tmi->tlm", dirs, dirs)
        pair_ok = valid[:, :, None] & valid[:, None, :]
        np.einsum("tll->tl", cosang)[:] = 1.0  # ignore self-pairs
        cosang = np.where(pair_ok, cosang, 1.0)
        narrow = cosang.min(axis=(1, 2)) > min_cos
        drop[need[narrow]] = True

    out = cand & seen & drop
    recon.track_estimated[out] = False
    return int(out.sum())


def set_underconstrained_tracks_to_unestimated(recon) -> int:
    """Parity: `theia::SetUnderconstrainedTracksToUnestimated`
    (`reconstruction_estimator_utils.cc:292-316`): an estimated track needs
    at least 2 estimated observing views."""
    good = recon.view_estimated[recon.obs_view]
    cnt = np.bincount(recon.obs_track[good], minlength=recon.num_tracks())
    out = recon.track_estimated & (cnt < kMinNumObservingViews)
    recon.track_estimated[out] = False
    return int(out.sum())


def set_underconstrained_views_to_unestimated(recon) -> int:
    """Parity: `theia::SetUnderconstrainedViewsToUnestimated`
    (`reconstruction_estimator_utils.cc:323-347`): an estimated view needs
    at least 3 estimated observed tracks."""
    good = recon.track_estimated[recon.obs_track]
    cnt = np.bincount(recon.obs_view[good], minlength=recon.num_views())
    out = recon.view_estimated & (cnt < kMinNumObservedTracks)
    recon.view_estimated[out] = False
    return int(out.sum())


def num_estimated_views(recon) -> int:
    return int(np.sum(recon.view_estimated))


def num_estimated_tracks(recon) -> int:
    return int(np.sum(recon.track_estimated))


def set_reconstruction_from_estimated_poses(orientations, positions, recon):
    """Parity: `theia::SetReconstructionFromEstimatedPoses`
    (`reconstruction_estimator_utils.cc`): every view with both a rotation
    and a position estimate becomes an estimated view."""
    for v, aa in orientations.items():
        if v not in positions:
            continue
        recon.view_extrinsics[v, :3] = np.asarray(positions[v])
        recon.view_extrinsics[v, 3:] = np.asarray(aa)
        recon.view_estimated[v] = True


def relative_rotations_from_view_graph(view_graph):
    """Parity: `theia::RelativeRotationsFromViewGraph`."""
    return {(i, j): np.asarray(info.rotation_2) for (i, j), info in view_graph.edges.items()}


def create_estimated_subreconstruction(recon):
    """Parity: `theia::CreateEstimatedSubreconstruction`."""
    view_ids = [v for v in range(recon.num_views()) if recon.view_estimated[v]]
    return recon.get_sub_reconstruction(view_ids)
