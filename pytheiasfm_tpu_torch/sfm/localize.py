"""2D-3D view localization against the current reconstruction.

Counterpart of the JAX package's `sfm/localize.py`
(`theia/sfm/localize_view_to_reconstruction.{h,cc}`: options `.h:55-90`,
flow `.cc:137-254`): gather the view's observations of estimated tracks,
RANSAC a calibrated absolute pose (P3P, SQPnP or DLS hypotheses by
`PnPType`, batched on the device) or, with a known orientation, a position,
gate on the inlier count, then a single-view bundle adjustment with every
track constant.

The JAX package pads the rows of a view to a power of two (and the batch
of views too) so that calls of different sizes share a compilation; the
port runs eagerly and pads the views of a batch only to the longest one,
with the same mask semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..ba.entry import bundle_adjust_view
from ..ba.lm import BundleAdjustmentOptions
from ..models import camera as cam
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np, rotation_matrix_to_angle_axis_np
from ..ransac import engine
from ..ransac.estimators import (
    estimate_absolute_pose_with_known_orientation,
    estimate_calibrated_absolute_pose_typed,
)
from ..utils import counters
from .reconstruction_estimator_utils import compute_resolution_scaled_threshold

__all__ = [
    "LocalizeViewToReconstructionOptions",
    "localize_view_to_reconstruction",
    "localize_views_to_reconstruction_batch",
]


@dataclasses.dataclass
class LocalizeViewToReconstructionOptions:
    """Parity: `theia::LocalizeViewToReconstructionOptions`
    (`localize_view_to_reconstruction.h:55-90`)."""

    reprojection_error_threshold_pixels: float = 4.0
    assume_known_orientation: bool = False
    ransac_params: engine.RansacParameters = dataclasses.field(
        default_factory=engine.RansacParameters
    )
    bundle_adjust_view: bool = True
    ba_options: BundleAdjustmentOptions = dataclasses.field(
        default_factory=lambda: BundleAdjustmentOptions(max_num_iterations=10)
    )
    min_num_inliers: int = 30
    # PnPType {0 KNEIP, 1 SQPNP, 2 DLS} (`estimate_calibrated_absolute_pose.h:54`).
    pnp_type: int = 0


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _rows_of(recon, view_id: int) -> list[int]:
    """The view's observation rows of estimated tracks."""
    return [r for t, r in recon._view_track_to_obs[view_id].items() if recon.track_estimated[t]]


def _normalized(recon, rows: np.ndarray, device) -> np.ndarray:
    """Normalized (calibrated) features of observation rows [n] -> [n, 2],
    one call an intrinsics group."""
    out = np.zeros((len(rows), 2), recon.dtype)
    groups = recon.view_group[recon.obs_view[rows]]
    for g in np.unique(groups):
        sel = groups == g
        ray = cam.pixel_to_normalized_batch(
            torch.as_tensor(recon.intrinsics[g], device=device),
            torch.as_tensor(recon.obs_uv[rows[sel]], device=device),
            int(recon.group_model[g]),
        )
        out[sel] = (ray[:, :2] / ray[:, 2:3]).cpu().numpy()
    return out


def _points3(recon, rows: np.ndarray) -> np.ndarray:
    tracks = recon.obs_track[rows]
    w = recon.points[tracks, 3:4]
    return recon.points[tracks, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)


def _threshold(recon, view_id: int, options) -> float:
    """Pixels -> a squared threshold in normalized coordinates, resolution
    scaled as in `localize_view_to_reconstruction.cc`."""
    prior = recon.view_priors[view_id]
    focal = float(recon.intrinsics[recon.view_group[view_id]][0])
    thresh_px = compute_resolution_scaled_threshold(
        options.reprojection_error_threshold_pixels, prior.image_width, prior.image_height)
    return (thresh_px / focal) ** 2


def localize_view_to_reconstruction(
    view_id: int,
    options: LocalizeViewToReconstructionOptions,
    recon,
    generator: torch.Generator | None = None,
    device=None,
):
    """Parity: `theia::LocalizeViewToReconstruction`. Returns (success,
    RansacSummary or None). On success the view's extrinsics are set and it
    is flagged estimated. `generator` defaults to one seeded by `view_id`
    (the JAX package's `PRNGKey(view_id)`); `device`: None means the CUDA
    card."""
    device = default_device(device)
    if generator is None:
        generator = _generator(view_id, device)
    rows = np.asarray(_rows_of(recon, view_id), np.int64)
    if len(rows) < max(options.min_num_inliers, 4):
        return False, None

    def t(a):
        return torch.as_tensor(a, device=device)[None]

    feats = _normalized(recon, rows, device)
    pts = _points3(recon, rows)
    params = dataclasses.replace(options.ransac_params,
                                 error_thresh=_threshold(recon, view_id, options))
    if options.assume_known_orientation:
        # Position only: the features rotated into the world-aligned frame
        # by the view's current orientation (R^T x), 2-point RANSAC.
        R_cur = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[view_id, 3:])
        rays = np.concatenate([feats, np.ones((len(feats), 1), feats.dtype)], axis=-1) @ R_cur
        model, summary = estimate_absolute_pose_with_known_orientation(
            generator, t(rays[:, :2] / rays[:, 2:3]), t(pts), params)
        if int(summary.num_inliers[0]) < options.min_num_inliers:
            return False, summary
        recon.view_extrinsics[view_id, :3] = model.position[0].cpu().numpy()
    else:
        model, summary = estimate_calibrated_absolute_pose_typed(
            generator, t(feats), t(pts), params, pnp_type=int(options.pnp_type))
        if int(summary.num_inliers[0]) < options.min_num_inliers:
            return False, summary
        recon.view_extrinsics[view_id, :3] = model.position[0].cpu().numpy()
        recon.view_extrinsics[view_id, 3:] = rotation_matrix_to_angle_axis_np(
            model.rotation[0].cpu().numpy())
    recon.view_estimated[view_id] = True

    if options.bundle_adjust_view:
        ba_summary = bundle_adjust_view(options.ba_options, view_id, recon, device=device)
        if not bool(ba_summary.success):
            recon.view_estimated[view_id] = False
            return False, summary
    return True, summary


def localize_views_to_reconstruction_batch(
    view_ids,
    options: LocalizeViewToReconstructionOptions,
    recon,
    generator: torch.Generator | None = None,
    device=None,
):
    """Localize a batch of views against the current reconstruction in one
    batched RANSAC call: the JAX package's mapping of the reference's
    candidate sweep (`incremental_reconstruction_estimator.cc:221-246`, one
    `LocalizeViewToReconstruction` per view there). Each view is a problem
    of its own with its own threshold; `generator` defaults to one seeded by
    `view_ids[0]` (the JAX package's `PRNGKey(view_ids[0])`).

    Returns {view_id: num_inliers} for the views that succeeded; their
    extrinsics are written and they are flagged estimated. The single-view
    BA of the one-view path is left to the caller's partial or full BA, as
    in the JAX package."""
    device = default_device(device)
    if generator is None:
        generator = _generator(int(view_ids[0]) if len(view_ids) else 0, device)

    kept, rows_per_view = [], []
    for v in view_ids:
        rows = _rows_of(recon, v)
        if len(rows) >= max(options.min_num_inliers, 4):
            kept.append(v)
            rows_per_view.append(np.asarray(rows, np.int64))
    if not kept:
        return {}

    B = len(kept)
    N = max(len(r) for r in rows_per_view)
    counts = np.asarray([len(r) for r in rows_per_view])
    all_rows = np.concatenate(rows_per_view)
    b_idx = np.repeat(np.arange(B), counts)
    n_idx = np.arange(len(all_rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    feats = np.zeros((B, N, 2), recon.dtype)
    pts = np.zeros((B, N, 3), recon.dtype)
    mask = np.zeros((B, N), bool)
    feats[b_idx, n_idx] = _normalized(recon, all_rows, device)
    pts[b_idx, n_idx] = _points3(recon, all_rows)
    mask[b_idx, n_idx] = True
    thresh = np.asarray([_threshold(recon, v, options) for v in kept], recon.dtype)

    counters.bump("localize_batch_launch")
    model, summary = estimate_calibrated_absolute_pose_typed(
        generator,
        *(torch.as_tensor(a, device=device) for a in (feats, pts)),
        dataclasses.replace(options.ransac_params, error_thresh=1.0),  # per view below
        pnp_type=int(options.pnp_type),
        mask=torch.as_tensor(mask, device=device),
        error_thresh=torch.as_tensor(thresh, device=device),
    )
    R = model.rotation.cpu().numpy()
    pos = model.position.cpu().numpy()
    ninl = summary.num_inliers.cpu().numpy()
    out = {}
    for i, v in enumerate(kept):
        if int(ninl[i]) < options.min_num_inliers:
            continue
        recon.view_extrinsics[v, :3] = pos[i]
        recon.view_extrinsics[v, 3:] = rotation_matrix_to_angle_axis_np(R[i])
        recon.view_estimated[v] = True
        out[v] = int(ninl[i])
    return out
