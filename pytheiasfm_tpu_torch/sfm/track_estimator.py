"""Batched track triangulation: `theia::TrackEstimator` on tensors.

Counterpart of the JAX package's `sfm/track_estimator.py`
(`theia/sfm/estimate_track.{h,cc}`). Every track is one row of a padded
[T, K] observation table (K the next power of two >= 2 of the longest
track, as in the JAX package) and all tracks triangulate in one batch.

A track is accepted (`estimate_track.cc::EstimateTrack`) when
  1. some pair of its rays subtends `min_triangulation_angle_degrees`;
  2. triangulation succeeds (MIDPOINT, or the SVD nullspace for SVD and
     L2_MINIMIZATION);
  3. every observing estimated view reprojects it within
     `max_acceptable_reprojection_error_pixels`, at positive depth.
Five Gauss-Newton steps on the normalized reprojection residuals stand in
for the reference's per-track bundle adjustment (`estimate_track.h:73`),
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import default_device
from ..models import camera as cam
from ..ops import rotation as rotops
from ..ops import triangulation as tri
from ..parallel.sharding import local_shard, mesh_axis

__all__ = [
    "TriangulationMethodType",
    "TrackEstimatorOptions",
    "TrackEstimatorSummary",
    "triangulate_tracks",
    "estimate_tracks",
    "estimate_all_tracks",
]


class TriangulationMethodType(enum.IntEnum):
    """Parity: `theia::TriangulationMethodType` (`estimate_track.h:49`)."""

    MIDPOINT = 0
    SVD = 1
    L2_MINIMIZATION = 2


@dataclasses.dataclass(frozen=True)
class TrackEstimatorOptions:
    """Parity: `theia::TrackEstimator::Options` (`estimate_track.h:57-101`).
    `mesh`: a device mesh (`parallel.make_mesh`): the track axis of the
    batched triangulation shards over it, every rank triangulating its
    block of the candidates; every rank calls with the same inputs."""

    max_acceptable_reprojection_error_pixels: float = 5.0
    min_triangulation_angle_degrees: float = 3.0
    bundle_adjustment: bool = True
    ba_iterations: int = 5
    triangulation_method: TriangulationMethodType = TriangulationMethodType.MIDPOINT
    mesh: object = None


@dataclasses.dataclass
class TrackEstimatorSummary:
    """Parity: `theia::TrackEstimator::Summary` (`estimate_track.h:103`)."""

    input_num_estimated_tracks: int = 0
    num_triangulation_attempts: int = 0
    estimated_tracks: set = dataclasses.field(default_factory=set)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)


def _refine_point_gn(point3, ext, norm_uv, mask, iters: int):
    """Per-track Gauss-Newton on the normalized reprojection residuals (the
    batched stand-in for the reference's single-point BA): points [T, 3],
    ext [T, K, 6], norm_uv [T, K, 2], mask [T, K]. A step is kept only
    where it lowers the track's squared residual. The Jacobian is
    forward-mode (`torch.autograd.forward_ad`), one direction a pass."""
    zero = torch.zeros((), dtype=point3.dtype, device=point3.device)

    def residuals(p):
        adjusted = p[:, None, :] - ext[..., :3]
        p_cam = rotops.angle_axis_rotate_point(ext[..., 3:], adjusted)
        r = p_cam[..., :2] / _safe_z(p_cam[..., 2])[..., None] - norm_uv
        return torch.where(mask[..., None], r, zero).reshape(p.shape[0], -1)

    eye = torch.eye(3, dtype=point3.dtype, device=point3.device)
    p = point3
    for _ in range(iters):
        cols = []
        with forward_ad.dual_level():
            for k in range(3):
                out = residuals(forward_ad.make_dual(p, eye[k].expand_as(p).contiguous()))
                r, col = forward_ad.unpack_dual(out)
                cols.append(col)
        J = torch.stack(cols, dim=-1)  # [T, 2K, 3]
        H = J.mT @ J + 1e-8 * eye
        g = (J.mT @ r[..., None])[..., 0]
        dp = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        p_new = p + dp
        better = torch.sum(residuals(p_new) ** 2, dim=-1) < torch.sum(r * r, dim=-1)
        p = torch.where(better[:, None], p_new, p)
    return p


def triangulate_tracks(
    track_ext,  # [T, K, 6] extrinsics of the observing (estimated) views
    track_norm_uv,  # [T, K, 2] normalized camera coordinates of the features
    track_focal,  # [T, K] focal length a slot (pixel threshold conversion)
    slot_mask,  # [T, K] bool
    max_reproj_px,
    min_angle_deg,
    method: int = int(TriangulationMethodType.MIDPOINT),
    bundle_adjustment: bool = True,
    ba_iterations: int = 5,
):
    """Triangulate T tracks at once on the device of the inputs. Returns
    (points4 [T, 4] with w = 1, success [T])."""
    dtype, dev = track_ext.dtype, track_ext.device
    min_cos = torch.cos(torch.deg2rad(torch.as_tensor(min_angle_deg, dtype=dtype, device=dev)))
    mask = slot_mask
    n_obs = torch.sum(mask, dim=-1)
    origins = track_ext[..., :3]
    dirs_cam = torch.cat([track_norm_uv, torch.ones_like(track_norm_uv[..., :1])], dim=-1)
    dirs_cam = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    R = rotops.angle_axis_to_rotation_matrix(track_ext[..., 3:])  # [T, K, 3, 3]
    dirs = torch.sum(R * dirs_cam[..., :, None], dim=-2)  # R^T d

    # 1. Angle test: some pair of rays subtends >= the minimum angle.
    K = mask.shape[-1]
    cosang = dirs @ dirs.mT
    pair_mask = mask[:, :, None] & mask[:, None, :]
    pair_mask = pair_mask & ~torch.eye(K, dtype=torch.bool, device=dev)
    angle_ok = torch.any(pair_mask & (cosang < min_cos), dim=(-2, -1))

    # 2. Triangulate.
    if method == int(TriangulationMethodType.MIDPOINT):
        point4, tri_ok = tri.triangulate_midpoint(origins, dirs, mask=mask)
    else:
        t = -torch.sum(R * origins[..., None, :], dim=-1)  # -R c
        poses = torch.cat([R, t[..., None]], dim=-1)  # [T, K, 3, 4]
        point4 = tri.triangulate_nview_svd(poses, track_norm_uv, mask=mask)
        tri_ok = torch.all(torch.isfinite(point4), dim=-1)
    w = point4[..., 3:4]
    point3 = point4[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.ones_like(w), w)

    if method == int(TriangulationMethodType.L2_MINIMIZATION) or (
        bundle_adjustment and ba_iterations > 0
    ):
        point3 = _refine_point_gn(point3, track_ext, track_norm_uv, mask, ba_iterations)

    # 3. Reprojection gate: every observing view within the threshold, at
    #    positive depth.
    p_cam = torch.sum(R * (point3[:, None, :] - origins)[..., None, :], dim=-1)
    z = p_cam[..., 2]
    reproj = p_cam[..., :2] / _safe_z(z)[..., None]
    err_px = torch.linalg.norm(reproj - track_norm_uv, dim=-1) * track_focal
    obs_ok = (z > 0) & (err_px <= max_reproj_px)
    reproj_ok = torch.all(obs_ok | ~mask, dim=-1)

    success = (n_obs >= 2) & angle_ok & tri_ok & reproj_ok
    return torch.cat([point3, torch.ones_like(point3[:, :1])], dim=-1), success


# --------------------------------------------------------------------- host


def _normalized_obs_by_group(recon, obs_rows: np.ndarray, device):
    """Pixel features of `obs_rows` to normalized camera coordinates (in
    the container's dtype, one call an intrinsics group), and each row's
    focal length."""
    norm = np.zeros((len(obs_rows), 2), recon.dtype)
    focal = np.ones((len(obs_rows),), recon.dtype)
    groups = recon.view_group[recon.obs_view[obs_rows]]
    for g in np.unique(groups):
        sel = groups == g
        ray = cam.pixel_to_normalized_batch(
            torch.as_tensor(recon.intrinsics[g], device=device),
            torch.as_tensor(recon.obs_uv[obs_rows[sel]], device=device),
            int(recon.group_model[g]),
        )
        norm[sel] = (ray[:, :2] / ray[:, 2:3]).cpu().numpy()
        focal[sel] = float(recon.intrinsics[g][0])
    return norm, focal


def estimate_tracks(
    recon,
    track_ids,
    options: TrackEstimatorOptions | None = None,
    dtype=np.float32,
    device=None,
) -> TrackEstimatorSummary:
    """Parity: `TrackEstimator::EstimateTracks` (`estimate_track.h:88`):
    triangulate every unestimated track of `track_ids` that two estimated
    views observe, and write the accepted ones back. The candidates and
    their slots are in the order of `track_ids` and of the observation rows,
    as the JAX package's per-track walk gives them (a track id listed twice
    is taken once). `device`: None means the CUDA card."""
    device = default_device(device)
    options = options or TrackEstimatorOptions()
    summary = TrackEstimatorSummary(input_num_estimated_tracks=int(np.sum(recon.track_estimated)))
    ids = np.asarray(list(track_ids), np.int64)
    if len(ids) == 0 or recon.num_observations() == 0:
        return summary
    # Position of each track in `track_ids` (its first listing).
    order_of = np.full(recon.num_tracks(), -1, np.int64)
    order_of[ids[::-1]] = np.arange(len(ids))[::-1]
    ot, ov = recon.obs_track, recon.obs_view
    rows = np.nonzero((order_of[ot] >= 0) & ~recon.track_estimated[ot]
                      & recon.view_estimated[ov])[0]
    rows = rows[np.argsort(order_of[ot[rows]], kind="stable")]
    listed, counts = np.unique(order_of[ot[rows]], return_counts=True)
    keep = counts >= 2
    rows = rows[np.repeat(keep, counts)]
    candidates, lengths = ids[listed[keep]], counts[keep]
    summary.num_triangulation_attempts = len(candidates)
    if not len(candidates):
        return summary

    K = 2
    while K < int(lengths.max()):
        K *= 2
    T = len(candidates)
    track_ext = np.zeros((T, K, 6), dtype)
    track_uv = np.zeros((T, K, 2), dtype)
    track_focal = np.ones((T, K), dtype)
    slot_mask = np.zeros((T, K), bool)
    norm_all, focal_all = _normalized_obs_by_group(recon, rows, device)
    i_idx = np.repeat(np.arange(T), lengths)
    starts = np.zeros(T + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    k_idx = np.arange(len(rows)) - starts[i_idx]
    track_ext[i_idx, k_idx] = recon.view_extrinsics[ov[rows]]
    track_uv[i_idx, k_idx] = norm_all
    track_focal[i_idx, k_idx] = focal_all
    slot_mask[i_idx, k_idx] = True

    from ..utils import counters

    counters.bump("triangulate_launch")
    arrays = (track_ext, track_uv, track_focal, slot_mask)
    comm = mesh_axis(options.mesh)
    if comm is not None:
        # This rank's block of the candidates; padded tracks are fully
        # masked (the JAX package's `:284-300`).
        arrays = tuple(local_shard(a, comm) for a in arrays)
    points4, success = triangulate_tracks(
        *(torch.as_tensor(a, device=device) for a in arrays),
        float(np.asarray(options.max_acceptable_reprojection_error_pixels, dtype)),
        float(np.asarray(options.min_triangulation_angle_degrees, dtype)),
        method=int(options.triangulation_method),
        bundle_adjustment=options.bundle_adjustment,
        ba_iterations=options.ba_iterations,
    )
    if comm is not None:  # every rank's block, in track order
        points4, success = comm.gather(points4)[:T], comm.gather(success)[:T]
    points4 = points4.cpu().numpy().astype(recon.dtype)
    success = success.cpu().numpy()
    idx = candidates[success]
    if len(idx):
        recon.points[idx] = points4[success]
        recon.track_estimated[idx] = True
        summary.estimated_tracks.update(int(t) for t in idx)
    return summary


def estimate_all_tracks(
    recon, options: TrackEstimatorOptions | None = None, dtype=np.float32, device=None
) -> TrackEstimatorSummary:
    """Parity: `TrackEstimator::EstimateAllTracks` (`estimate_track.h:85`)."""
    return estimate_tracks(recon, range(recon.num_tracks()), options, dtype, device=device)
