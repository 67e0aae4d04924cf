"""Track selection for efficient bundle adjustment.

Counterpart of the JAX package's `sfm/select_tracks.py`
(`theia/sfm/select_good_tracks_for_bundle_adjustment.{h,cc}`, flow
`.cc:54-240`): rank each view's estimated tracks by the pair (truncated
track length, mean squared reprojection error), hash features into an
image grid, keep the best-ranked track per cell, then top up per view
until `min_num_optimized_tracks_per_view`. Track statistics for the whole scene
come from one batched reprojection pass on the device.
"""

from __future__ import annotations

import numpy as np

from .reconstruction_estimator_utils import compute_reprojection_errors

__all__ = ["select_good_tracks_for_bundle_adjustment"]


def select_good_tracks_for_bundle_adjustment(
    recon,
    view_ids=None,
    long_track_length_threshold: int = 10,
    image_grid_cell_size_pixels: int = 100,
    min_num_optimized_tracks_per_view: int = 100,
    device=None,
) -> set[int]:
    """Returns the set of track ids to optimize. Parity:
    `theia::SelectGoodTracksForBundleAdjustment`
    (`select_good_tracks_for_bundle_adjustment.h`). `device`: where the
    reprojection errors are computed (None: the CUDA card)."""
    if view_ids is None:
        view_ids = [v for v in range(recon.num_views()) if recon.view_estimated[v]]
    view_set = set(int(v) for v in view_ids)

    # --- track statistics over all estimated (track, estimated-view) rows.
    rows = np.where(
        recon.view_estimated[recon.obs_view] & recon.track_estimated[recon.obs_track]
    )[0]
    if len(rows) == 0:
        return set()
    sq_err, _ = compute_reprojection_errors(recon, rows, device=device)
    tracks = recon.obs_track[rows]
    T = recon.num_tracks()
    err_sum = np.zeros(T)
    cnt = np.zeros(T)
    np.add.at(err_sum, tracks, sq_err)
    np.add.at(cnt, tracks, 1.0)
    valid = cnt > 0
    mean_err = np.where(valid, err_sum / np.maximum(cnt, 1.0), np.inf)
    trunc_len = np.minimum(cnt, long_track_length_threshold).astype(int)

    def stat(t):
        return (trunc_len[t], mean_err[t])

    tracks_to_optimize: set[int] = set()

    # --- best track per image-grid cell, per view
    #     (SelectBestTracksFromEachImageGridCell, .cc:141-189).
    inv_cell = 1.0 / image_grid_cell_size_pixels
    for v in view_set:
        grid: dict[tuple[int, int], list[int]] = {}
        for t, r in recon._view_track_to_obs[v].items():
            if not recon.track_estimated[t] or not valid[t]:
                continue
            cell = (
                int(recon.obs_uv[r][0] * inv_cell),
                int(recon.obs_uv[r][1] * inv_cell),
            )
            grid.setdefault(cell, []).append(t)
        for cell_tracks in grid.values():
            best = min(cell_tracks, key=stat)
            tracks_to_optimize.add(int(best))

    # --- top-up per view (SelectTopRankedTracksInView, .cc:192-240).
    for v in view_set:
        estimated = [
            t
            for t in recon._view_track_to_obs[v]
            if recon.track_estimated[t] and valid[t]
        ]
        chosen = [t for t in estimated if int(t) in tracks_to_optimize]
        if len(chosen) >= min_num_optimized_tracks_per_view:
            continue
        candidates = [t for t in estimated if int(t) not in tracks_to_optimize]
        need = min(
            min_num_optimized_tracks_per_view - len(chosen), len(candidates)
        )
        for t in sorted(candidates, key=stat)[:need]:
            tracks_to_optimize.add(int(t))

    return tracks_to_optimize
