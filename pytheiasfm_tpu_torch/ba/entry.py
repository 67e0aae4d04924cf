"""Bundle-adjustment entry points over the host `Reconstruction` container.

Counterpart of the JAX package's `ba/entry.py` (the reference's
`BundleAdjustReconstruction`, `BundleAdjustPartialReconstruction`,
`BundleAdjustView(s)`, `BundleAdjustTrack(s)`, `bundle_adjustment.h:181-219`):
one kernel with different free-parameter masks.

The problem is gathered on the host (numpy, as the JAX entry does), padded
as the JAX entry pads it (views, tracks and groups by `_pad_soft` /
`_pad_pow2`, so that the kernel's size gates switch at the same scenes), laid
out in track slots and view rowchunks, and solved on `device`. The dispatch
rules are the JAX entry's (`:410-443`):
  - dense Schur (frozen intrinsics, <= 1024 padded views, tracks of <= 32
    slots): not ported, raises naming ROADMAP item A7;
  - rowchunk iterative Schur (`ba/iterative_schur.py`): everything else that
    fits the slot layout, the main path's free-intrinsics problems of every
    size among them;
  - the flat implicit-PCG kernel (INVERSE_DEPTH, degenerate slot layouts):
    not ported, raises naming ROADMAP item A5b.
The JAX entry's launch-cap cost model (`:384-409`) only sizes the TPU's
launch chunks, which the port does not have (one LM loop,
`iterative_schur.bundle_adjust_iterative`). The covariance entries
(`compute_reconstruction_covariance`, `*_with_cov`) wait for ROADMAP item
D1. `_rodrigues_np` serves the INVERSE_DEPTH write-back of the flat kernel
(A5b).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..models.intrinsics import intrinsics_subset_mask
from .iterative_schur import bundle_adjust_iterative
from .lm import (
    FLAT_KERNEL_ITEM,
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    TrackParametrizationType,
    check_no_priors,
)

__all__ = [
    "bundle_adjust_reconstruction",
    "bundle_adjust_partial_reconstruction",
    "bundle_adjust_views",
    "bundle_adjust_tracks",
    "bundle_adjust_view",
    "bundle_adjust_track",
    "bundle_adjust_views_with_cov",
    "bundle_adjust_view_with_cov",
    "bundle_adjust_tracks_with_cov",
    "bundle_adjust_track_with_cov",
]

# The JAX package's `ba/dense_schur.DENSE_SCHUR_MAX_CAMERAS`: AUTO's
# crossover from the dense to the iterative Schur.
DENSE_SCHUR_MAX_CAMERAS = 1024
DENSE_SCHUR_ITEM = "ROADMAP item A7"
COVARIANCE_ITEM = "ROADMAP item D1"


def _pad_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_bucket(n: int, floor: int = 16) -> int:
    """Pow2 up to 64k, then multiples of 64k."""
    if n <= 65536:
        return _pad_pow2(n, floor)
    return -(-n // 65536) * 65536


def _pad_soft(n: int, floor: int, pow2_until: int, step: int) -> int:
    """Pow2 while small, multiples of `step` once past `pow2_until`."""
    if n <= pow2_until:
        return _pad_pow2(n, floor)
    return -(-n // step) * step


def _gather_problem(recon, view_sel, track_sel, dtype):
    """The flat masked problem from the host container (the JAX entry's
    `_gather_problem`): observations of participating views and tracks,
    padded to `_pad_bucket` rows. view_sel / track_sel: boolean arrays."""
    ov, ot = recon.obs_view, recon.obs_track
    rows = np.where(view_sel[ov] & track_sel[ot])[0]
    O = len(rows)
    Opad = _pad_bucket(max(O, 1))
    groups_used = {int(g) for g in np.unique(recon.view_group[view_sel])}
    present = tuple(sorted({int(recon.group_model[g]) for g in groups_used} or {0}))
    P = recon.intrinsics.shape[1]
    intr_rows = np.zeros((Opad, P), dtype)
    obs_view = np.zeros((Opad,), np.int32)
    obs_track = np.zeros((Opad,), np.int32)
    obs_uv = np.zeros((Opad, 2), dtype)
    obs_info = np.ones((Opad, 2), dtype)
    obs_mask = np.zeros((Opad,), bool)
    obs_view[:O] = ov[rows]
    obs_track[:O] = ot[rows]
    obs_uv[:O] = recon.obs_uv[rows]
    obs_info[:O] = recon.obs_sqrt_inv_cov[rows]
    obs_mask[:O] = True
    intr_rows[:O] = recon.intrinsics[recon.view_group[ov[rows]]]
    w = recon.points[:, 3:4]
    pts3 = recon.points[:, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)
    return dict(
        extrinsics=recon.view_extrinsics.astype(dtype),
        points=pts3.astype(dtype),
        intrinsics_rows=intr_rows,
        obs_view=obs_view,
        obs_track=obs_track,
        obs_uv=obs_uv,
        obs_sqrt_info=obs_info,
        obs_mask=obs_mask,
        model=present[0],
        present_models=present,
    )


def _slot_layout(prob, num_tracks: int, dtype):
    """The flat masked observations regrouped into the padded [T, L] track
    slots, a track's observations in row order; L = `_pad_soft(longest
    track, 4, 4, 2)`. None when no observation is masked in."""
    m = prob["obs_mask"]
    rows = np.where(m)[0]
    if len(rows) == 0:
        return None
    ot = prob["obs_track"][rows]
    order = np.argsort(ot, kind="stable")
    rows = rows[order]
    ot = ot[order]
    counts = np.bincount(ot, minlength=num_tracks)
    L = _pad_soft(max(int(counts.max()), 1), 4, 4, 2)
    starts = np.zeros(num_tracks + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(rows)) - starts[ot]
    track_views = np.zeros((num_tracks, L), np.int32)
    uv = np.zeros((num_tracks, L, 2), dtype)
    info = np.ones((num_tracks, L, 2), dtype)
    mask = np.zeros((num_tracks, L), bool)
    track_views[ot, pos] = prob["obs_view"][rows]
    uv[ot, pos] = prob["obs_uv"][rows]
    info[ot, pos] = prob["obs_sqrt_info"][rows]
    mask[ot, pos] = True
    return dict(track_views=track_views, uv=uv, info=info, mask=mask, L=L)


def _rowchunk_layout(slot, num_views: int):
    """The view-rowchunk layout from the track slots: observations sorted by
    view (stable), split into rows of up to C per view, each row slot
    indexing into the flat [T*L] slots. C in {64, ..., 1024} minimizes the
    padded slots; R pads by `_pad_soft(R, 16, 2048, 512)`."""
    mask = slot["mask"]
    tv = slot["track_views"]
    flat = np.nonzero(mask.reshape(-1))[0]
    if len(flat) == 0:
        return None
    v_of = tv.reshape(-1)[flat]
    order = np.argsort(v_of, kind="stable")
    flat = flat[order]
    v_sorted = v_of[order]
    counts = np.bincount(v_sorted, minlength=num_views)
    best = None
    for cand in (64, 128, 256, 512, 1024):
        padded = int(np.sum(-(-counts // cand)) * cand)
        if best is None or padded < best[1]:
            best = (cand, padded)
    C = best[0]
    rows_per_view = -(-counts // C)
    R = int(rows_per_view.sum())
    Rp = _pad_soft(max(R, 1), 16, 2048, 512)
    row_view = np.zeros((Rp,), np.int32)
    rc_src = np.zeros((Rp, C), np.int32)
    rc_mask = np.zeros((Rp, C), bool)
    row_base = np.zeros(num_views + 1, np.int64)
    np.cumsum(rows_per_view, out=row_base[1:])
    starts = np.zeros(num_views + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    p = np.arange(len(flat)) - starts[v_sorted]
    row_id = row_base[v_sorted] + p // C
    col = p % C
    rc_src[row_id, col] = flat
    rc_mask[row_id, col] = True
    row_view[:R] = np.repeat(np.arange(num_views, dtype=np.int32), rows_per_view)
    return dict(row_view=row_view, rc_src=rc_src, rc_mask=rc_mask, R=Rp, C=C)


def _rodrigues_np(aa, pts):
    """Rotate pts [N, 3] by angle-axis aa [N, 3] (host numpy)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = aa / safe
    c = np.cos(theta)
    s = np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=-1, keepdims=True)
    out = pts * c + kxp * s + k * kdp * (1.0 - c)
    return np.where(theta < 1e-12, pts, out)


def _run(recon, view_sel, track_sel, camera_free, point_free, options, dtype,
         orientation_constant: bool = False, device=None) -> BundleAdjustmentSummary:
    """Gather, pad, dispatch and solve; write the solution back into
    `recon` (free views, moved intrinsics groups, free tracks)."""
    device = default_device(device)
    if options.mesh is not None:
        raise NotImplementedError("bundle adjustment over a device mesh is not ported yet "
                                  "(ROADMAP item G1)")
    check_no_priors(options)
    tp = options.track_parametrization_type
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        raise NotImplementedError(
            "INVERSE_DEPTH tracks go to the flat implicit-PCG kernel, which is not "
            f"ported yet ({FLAT_KERNEL_ITEM})"
        )
    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    V, T = recon.num_views(), recon.num_tracks()
    G = recon.intrinsics.shape[0]
    P = recon.intrinsics.shape[1]
    Vp = _pad_soft(V, 8, 512, 256)
    Tp = _pad_soft(T, 64, 16384, 16384 if T > 150_000 else 8192)
    # G == 1 keeps its own bucket: the kernel eliminates a single shared
    # group exactly.
    Gp = 1 if G <= 1 else _pad_pow2(G, 4)
    ext_in = np.zeros((Vp, 6), dtype)
    ext_in[:V] = prob["extrinsics"]

    present = prob["present_models"]
    intr_in = np.zeros((Gp, P), dtype)
    intr_in[:, 0] = 1.0
    intr_in[:, 1] = 1.0
    intr_in[:G] = recon.intrinsics.astype(dtype)
    view_group = np.zeros((Vp,), np.int32)
    view_group[:V] = recon.view_group
    group_model_idx = np.zeros((Gp,), np.int32)
    intr_free = np.zeros((Gp, P), bool)
    flags = options.intrinsics_to_optimize
    # Only groups owning a participating view get free intrinsics (the
    # reference never moves a parameter block with no residual).
    free_groups = (
        {int(g) for g in np.unique(recon.view_group[:V][view_sel[:V]])} if flags else set()
    )
    for g in range(G):
        m = int(recon.group_model[g])
        group_model_idx[g] = present.index(m) if m in present else 0
        if flags and g in free_groups:
            intr_free[g] = intrinsics_subset_mask(recon.group_model[g], flags)[:P]

    if tp == TrackParametrizationType.XYZW_MANIFOLD:
        pts_in = np.zeros((Tp, 4), dtype)
        pts_in[:, 3] = 1.0
        p4 = recon.points[:T].astype(np.float64)
        n = np.linalg.norm(p4, axis=-1, keepdims=True)
        pts_in[:T] = (p4 / np.where(n < 1e-12, 1.0, n)).astype(dtype)
    else:
        pts_in = np.zeros((Tp, 3), dtype)
        pts_in[:T] = prob["points"]

    if orientation_constant:
        # Per-DOF mask: positions free, angle-axis rows frozen.
        cam_free_p = np.zeros((Vp, 6), bool)
        cam_free_p[:V, :3] = camera_free[:, None]
    else:
        cam_free_p = np.zeros(Vp, bool)
        cam_free_p[:V] = camera_free
    pt_free_p = np.zeros(Tp, bool)
    pt_free_p[:T] = point_free

    # Dispatch (`ba/entry.py:410-443` of the JAX package).
    O_real = int(np.sum(prob["obs_mask"]))
    slot = _slot_layout(prob, Tp, dtype)
    rowchunk = None
    want_dense = options.linear_solver_type in (LinearSolverType.AUTO,
                                                LinearSolverType.DENSE_SCHUR)
    if options.linear_solver_type == LinearSolverType.AUTO:
        want_dense = want_dense and Vp <= DENSE_SCHUR_MAX_CAMERAS
    use_dense = want_dense and not flags and slot is not None and slot["L"] <= 32
    if slot is not None and not use_dense:
        # Rowchunk kernel unless slot padding dwarfs the real problem.
        if Tp * slot["L"] <= min(max(4 * O_real, 1 << 16), 4_000_000):
            rowchunk = _rowchunk_layout(slot, Vp)
        if rowchunk is None:
            slot = None
    if use_dense:
        raise NotImplementedError(
            "the dense-Schur bundle adjustment (frozen intrinsics, <= "
            f"{DENSE_SCHUR_MAX_CAMERAS} cameras) is not ported yet ({DENSE_SCHUR_ITEM})"
        )
    if rowchunk is None:
        raise NotImplementedError(
            "this problem goes to the flat implicit-PCG kernel (no usable slot layout), "
            f"which is not ported yet ({FLAT_KERNEL_ITEM})"
        )

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    ext, intr_out, pts, summary = bundle_adjust_iterative(
        t(ext_in), t(intr_in), t(pts_in), t(view_group), t(group_model_idx),
        t(slot["track_views"]), t(slot["uv"]), t(slot["info"]), t(slot["mask"]),
        t(rowchunk["row_view"]), t(rowchunk["rc_src"]), t(rowchunk["rc_mask"]),
        t(cam_free_p), t(pt_free_p), t(intr_free),
        present_models=present, num_views=Vp, num_tracks=Tp, max_track_len=slot["L"],
        num_rows=rowchunk["R"], row_chunk=rowchunk["C"], num_groups=Gp, options=options,
    )
    ext = ext.cpu().numpy().astype(recon.dtype)[:V]
    pts = pts.cpu().numpy().astype(recon.dtype)[:T]
    recon.view_extrinsics[camera_free] = ext[camera_free]
    if flags:
        intr_out = intr_out.cpu().numpy().astype(recon.dtype)[:G]
        moved = intr_free[:G].any(axis=-1)
        recon.intrinsics[moved] = intr_out[moved]
    if tp == TrackParametrizationType.XYZW_MANIFOLD:
        recon.points[point_free] = pts[point_free]
    else:
        recon.points[point_free, :3] = pts[point_free]
        recon.points[point_free, 3] = 1.0
    return summary


def bundle_adjust_reconstruction(
    options: BundleAdjustmentOptions, recon, dtype=np.float32, device=None
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustReconstruction` (`bundle_adjustment.cc:188`):
    every estimated view and track."""
    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    return _run(recon, view_sel, track_sel, view_sel, track_sel, options, dtype,
                device=device)


def bundle_adjust_partial_reconstruction(
    options: BundleAdjustmentOptions, views_to_optimize, tracks_to_optimize, recon,
    dtype=np.float32, orientation_constant: bool = False, device=None,
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustPartialReconstruction`
    (`bundle_adjustment.h:188`): only the given (estimated) views and tracks
    move; their residuals still couple to every estimated neighbour.
    `orientation_constant=True` freezes the camera orientations."""
    V, T = recon.num_views(), recon.num_tracks()
    cam_free = np.zeros(V, bool)
    pt_free = np.zeros(T, bool)
    for v in views_to_optimize:
        if recon.view_estimated[v]:
            cam_free[v] = True
    for t in tracks_to_optimize:
        if recon.track_estimated[t]:
            pt_free[t] = True
    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    return _run(recon, view_sel, track_sel, cam_free, pt_free, options, dtype,
                orientation_constant=orientation_constant, device=device)


def bundle_adjust_views(options, view_ids, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustViews` (`bundle_adjustment.h:199`): the
    given views move, every track stays."""
    return bundle_adjust_partial_reconstruction(options, view_ids, [], recon, dtype,
                                                device=device)


def bundle_adjust_view(options, view_id, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustView` (`bundle_adjustment.h:195`)."""
    return bundle_adjust_views(options, [view_id], recon, dtype, device=device)


def bundle_adjust_tracks(options, track_ids, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustTracks` (`bundle_adjustment.h:214`): the
    given tracks move, every view stays."""
    return bundle_adjust_partial_reconstruction(options, [], track_ids, recon, dtype,
                                                device=device)


def bundle_adjust_track(options, track_id, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustTrack` (`bundle_adjustment.h:206`)."""
    return bundle_adjust_tracks(options, [track_id], recon, dtype, device=device)


def _covariance_not_ported(*args, **kwargs):
    raise NotImplementedError(
        f"bundle adjustment with covariance is not ported yet ({COVARIANCE_ITEM})"
    )


bundle_adjust_views_with_cov = _covariance_not_ported
bundle_adjust_view_with_cov = _covariance_not_ported
bundle_adjust_tracks_with_cov = _covariance_not_ported
bundle_adjust_track_with_cov = _covariance_not_ported
compute_reconstruction_covariance = _covariance_not_ported
