"""Bundle-adjustment entry points over the host `Reconstruction` container.

Counterpart of the JAX package's `ba/entry.py` (the reference's
`BundleAdjustReconstruction`, `BundleAdjustPartialReconstruction`,
`BundleAdjustView(s)`, `BundleAdjustTrack(s)`, `bundle_adjustment.h:181-219`,
and the covariance entries, `:221-250`): one kernel with different
free-parameter masks.

The problem is gathered on the host (numpy, as the JAX entry does), padded
as the JAX entry pads it (views, tracks and groups by `_pad_soft` /
`_pad_pow2`, so that the kernels' size gates switch at the same scenes),
laid out in track slots and view rowchunks, and solved on `device`. The
dispatch rules are the JAX entry's (`:410-443`):
  - dense Schur (`ba/dense_schur.py`): frozen intrinsics, <= 1024 padded
    views, tracks of <= 32 slots (the calibrated configuration);
  - rowchunk iterative Schur (`ba/iterative_schur.py`): everything else that
    fits the slot layout, the main path's free-intrinsics problems of every
    size among them;
  - the flat implicit-PCG kernel (`ba/lm.bundle_adjust`): INVERSE_DEPTH
    tracks, and problems whose slot padding would dwarf them (one track much
    longer than the rest).
The JAX entry's launch-cap cost model (`:384-409`) only sizes the TPU's
launch chunks, which the port does not have (one LM loop, `lm.run_lm`).

With `options.mesh` every rank calls the entry with the same container and
options. The padded track count rounds up to a multiple of the mesh size
(the JAX entry's `:230-234`); the dense Schur sums its pair blocks by track
blocks, the iterative Schur gets this rank's block of the track slots and
the rowchunks of its own slots, and the flat kernel runs whole on every
rank, as the JAX entry passes it no mesh. Every rank writes rank 0's
solution back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..models import intrinsics as intr_models
from ..models.intrinsics import intrinsics_subset_mask
from ..parallel.sharding import mesh_axis
from .dense_schur import DENSE_SCHUR_MAX_CAMERAS, bundle_adjust_dense, joint_covariance_dense
from .iterative_schur import bundle_adjust_iterative
from .lm import (
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    TrackParametrizationType,
    bundle_adjust,
    hessian_blocks,
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
    "compute_reconstruction_covariance",
]


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


def _empty_rowchunk():
    """A rowchunk layout of one padded block of rows that hold nothing."""
    return dict(row_view=np.zeros((16,), np.int32), rc_src=np.zeros((16, 64), np.int32),
                rc_mask=np.zeros((16, 64), bool), R=16, C=64)


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


def _tensors(device):
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return t


def _inverse_depth_tracks(recon, points3, T, Tp, dtype):
    """INVERSE_DEPTH inputs: (track_ref [Tp], track_bearing [Tp, 3], inverse
    depths [Tp, 1], valid reference [T]). The bearing is the observed
    feature ray in the reference view (the reference stores the undistorted
    feature bearing, track.h:84; the current point estimate would freeze its
    lateral error into the parametrization), the depth the current point's
    projection on it."""
    ref = np.asarray(recon.track_reference_view[:T], np.int64)
    valid_ref = ref >= 0
    ref_safe = np.where(valid_ref, ref, 0)
    c_ref = recon.view_extrinsics[ref_safe, :3]
    aa_ref = recon.view_extrinsics[ref_safe, 3:]
    p_ref = _rodrigues_np(aa_ref, points3[:T] - c_ref)
    depth = np.linalg.norm(p_ref, axis=-1)
    depth = np.where(depth < 1e-9, 1e-9, depth)
    bearing = p_ref / depth[:, None]
    for g in range(recon.intrinsics.shape[0]):
        rows = [
            (t, recon._view_track_to_obs[int(ref_safe[t])].get(t))
            for t in range(T)
            if valid_ref[t] and int(recon.view_group[ref_safe[t]]) == g
        ]
        rows = [(t, r) for (t, r) in rows if r is not None]
        if not rows:
            continue
        t_idx = np.asarray([t for t, _ in rows])
        uv = recon.obs_uv[[r for _, r in rows]]
        ray = intr_models.pixel_to_camera(
            torch.as_tensor(np.asarray(recon.intrinsics[g], dtype)[None, :]),
            torch.as_tensor(np.asarray(uv, dtype)), recon.group_model[g]).numpy()
        n = np.linalg.norm(ray, axis=-1, keepdims=True)
        bearing[t_idx] = ray / np.where(n < 1e-12, 1.0, n)
        depth_ray = np.sum(p_ref[t_idx] * bearing[t_idx], axis=-1)
        depth[t_idx] = np.where(depth_ray > 1e-9, depth_ray, depth[t_idx])
    track_ref = np.zeros((Tp,), np.int32)
    track_bearing = np.zeros((Tp, 3), dtype)
    pts_in = np.zeros((Tp, 1), dtype)
    track_ref[:T] = ref_safe.astype(np.int32)
    track_bearing[:T] = bearing.astype(dtype)
    pts_in[:T, 0] = (1.0 / depth).astype(dtype)
    return track_ref, track_bearing, pts_in, valid_ref


def _view_priors(recon, view_sel, options, Vp, dtype):
    """The 9-tuple of per-view prior arrays (pp, psi, pm, op, osi, om, gp,
    gsi, gm) of `lm._prior_residual` for the participating views (position,
    orientation, gravity, bundle_adjuster.cc:292-313), an unset sqrt
    information taken as the identity; None when no prior is asked for."""
    use = (options.use_position_priors, options.use_orientation_priors,
           options.use_gravity_priors)
    if not any(use):
        return None
    arrays = []
    for _ in use:
        arrays += [np.zeros((Vp, 3), dtype), np.zeros((Vp, 3, 3), dtype), np.zeros((Vp,), dtype)]
    for v, vp in enumerate(recon.view_priors):
        if not view_sel[v]:
            continue
        for k, (on, value, info) in enumerate((
            (use[0], vp.position, vp.position_sqrt_information),
            (use[1], vp.orientation, vp.orientation_sqrt_information),
            (use[2], vp.gravity, vp.gravity_sqrt_information),
        )):
            if on and value is not None:
                arrays[3 * k][v] = np.asarray(value, dtype)
                arrays[3 * k + 1][v] = (np.asarray(info, dtype) if info is not None
                                        else np.eye(3, dtype=dtype))
                arrays[3 * k + 2][v] = 1.0
    return tuple(arrays)


def _run(recon, view_sel, track_sel, camera_free, point_free, options, dtype,
         orientation_constant: bool = False, device=None) -> BundleAdjustmentSummary:
    """Gather, pad, dispatch and solve; write the solution back into
    `recon` (free views, moved intrinsics groups, free tracks)."""
    device = default_device(device)
    comm = mesh_axis(options.mesh)
    tp = options.track_parametrization_type
    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    V, T = recon.num_views(), recon.num_tracks()
    G = recon.intrinsics.shape[0]
    P = recon.intrinsics.shape[1]
    Vp = _pad_soft(V, 8, 512, 256)
    Tp = _pad_soft(T, 64, 16384, 16384 if T > 150_000 else 8192)
    if comm is not None:
        Tp = -(-Tp // comm.size) * comm.size
    # G == 1 keeps its own bucket: the iterative kernel eliminates a single
    # shared group exactly.
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

    # Track parametrization (bundle_adjustment.h:127-131).
    track_ref = np.zeros((Tp,), np.int32)
    track_bearing = np.zeros((Tp, 3), dtype)
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        track_ref, track_bearing, pts_in, valid_ref = _inverse_depth_tracks(
            recon, prob["points"], T, Tp, dtype)
        point_free = point_free & valid_ref
    elif tp == TrackParametrizationType.XYZW_MANIFOLD:
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

    t = _tensors(device)
    priors = _view_priors(recon, view_sel, options, Vp, dtype)
    if priors is not None:
        priors = tuple(t(a) for a in priors)

    # Dispatch (`ba/entry.py:410-443` of the JAX package).
    O_real = int(np.sum(prob["obs_mask"]))
    slot = None
    if tp != TrackParametrizationType.INVERSE_DEPTH:
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

    common = (t(ext_in), t(intr_in), t(pts_in), t(view_group), t(group_model_idx))
    if use_dense:
        ext, intr_out, pts, summary = bundle_adjust_dense(
            *common, t(slot["track_views"]), t(slot["uv"]), t(slot["info"]), t(slot["mask"]),
            t(cam_free_p), t(pt_free_p), present_models=present, num_views=Vp, num_tracks=Tp,
            max_track_len=slot["L"], num_groups=Gp, options=options, priors=priors,
            mesh=options.mesh,
        )
    elif rowchunk is not None:
        pts_k, pt_free_k = pts_in, pt_free_p
        if comm is not None:
            # This rank's block of the track slots and the rowchunks of its
            # own slots (an empty layout where it holds no observation).
            slot = {k: (comm.shard(v) if isinstance(v, np.ndarray) else v)
                    for k, v in slot.items()}
            rowchunk = _rowchunk_layout(slot, Vp) or _empty_rowchunk()
            pts_k, pt_free_k = comm.shard(pts_in), comm.shard(pt_free_p)
        ext, intr_out, pts, summary = bundle_adjust_iterative(
            t(ext_in), t(intr_in), t(pts_k), t(view_group), t(group_model_idx),
            t(slot["track_views"]), t(slot["uv"]), t(slot["info"]), t(slot["mask"]),
            t(rowchunk["row_view"]), t(rowchunk["rc_src"]), t(rowchunk["rc_mask"]),
            t(cam_free_p), t(pt_free_k), t(intr_free),
            present_models=present, num_views=Vp, num_tracks=Tp, max_track_len=slot["L"],
            num_rows=rowchunk["R"], row_chunk=rowchunk["C"], num_groups=Gp, options=options,
            priors=priors, mesh=options.mesh,
        )
    else:
        ext, intr_out, pts, summary = bundle_adjust(
            *common, t(prob["obs_view"]), t(prob["obs_track"]), t(prob["obs_uv"]),
            t(prob["obs_sqrt_info"]), t(prob["obs_mask"]), t(cam_free_p), t(pt_free_p),
            t(intr_free), t(track_ref), t(track_bearing), present_models=present,
            num_views=Vp, num_tracks=Tp, num_groups=Gp,
            options=dataclasses.replace(options, mesh=None), priors=priors,
        )
        if comm is not None:  # the same solve on every rank: rank 0's bits
            ext, intr_out, pts = comm.broadcast(ext), comm.broadcast(intr_out), comm.broadcast(pts)
    ext = ext.cpu().numpy().astype(recon.dtype)[:V]
    pts = pts.cpu().numpy().astype(recon.dtype)[:T]
    recon.view_extrinsics[camera_free] = ext[camera_free]
    if flags:
        intr_out = intr_out.cpu().numpy().astype(recon.dtype)[:G]
        moved = intr_free[:G].any(axis=-1)
        recon.intrinsics[moved] = intr_out[moved]
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        rho = pts[:, 0]
        recon.track_inverse_depth[point_free] = rho[point_free]
        depth = 1.0 / np.where(np.abs(rho) < 1e-12, 1e-12, rho)
        ref = track_ref[:T].astype(np.int64)
        c_ref = recon.view_extrinsics[ref, :3]
        aa_ref = recon.view_extrinsics[ref, 3:]
        p_world = c_ref + _rodrigues_np(
            -aa_ref, np.asarray(track_bearing[:T], np.float64) * depth[:, None])
        recon.points[point_free, :3] = p_world[point_free]
        recon.points[point_free, 3] = 1.0
    elif tp == TrackParametrizationType.XYZW_MANIFOLD:
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


def _covariance_problem(recon, dtype):
    """The covariance entries' problem, padded as the JAX entry pads it
    (`_pad_pow2` on views and tracks): (gather, view_sel, track_sel, V, T,
    Vp, Tp)."""
    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    V, T = recon.num_views(), recon.num_tracks()
    return prob, view_sel, track_sel, V, T, _pad_pow2(V, 8), _pad_pow2(T, 64)


def compute_reconstruction_covariance(options: BundleAdjustmentOptions, recon,
                                      constant_views=(), dtype=np.float64, view_ids=None,
                                      track_ids=None, device=None):
    """Joint-problem marginal covariances: the general `ceres::Covariance`
    case on the full problem (`bundle_adjuster.cc:660-744`), not the
    block-diagonal approximation of the `*_with_cov` entries.

    `constant_views` are held constant to fix the gauge (the covariance of a
    gauge-free problem is singular). Returns ({view_id: [6, 6]},
    {track_id: [3, 3]}, variance_factor). With `view_ids` None, every block
    by the dense Schur inverse (`dense_schur.joint_covariance_dense`), up to
    `DENSE_SCHUR_MAX_CAMERAS` padded views and slot length 32 (larger
    problems raise); with `view_ids`, the requested columns of S^-1 by PCG
    (`covariance.selected_covariance_pcg`) at any scale, the observing
    views of `track_ids` added to the solve."""
    device = default_device(device)
    prob, view_sel, track_sel, V, T, Vp, Tp = _covariance_problem(recon, dtype)
    selected = view_ids is not None
    if not selected and Vp > DENSE_SCHUR_MAX_CAMERAS:
        raise ValueError(
            f"compute_reconstruction_covariance(view_ids=None) materializes a dense "
            f"[{6 * Vp}, {6 * Vp}] Schur complement; supported up to "
            f"{DENSE_SCHUR_MAX_CAMERAS} (padded) views, got {V}. Pass view_ids=/track_ids= "
            f"for the matrix-free selected-block path (any scale), or use "
            f"bundle_adjust_views_with_cov / bundle_adjust_tracks_with_cov."
        )
    slot = _slot_layout(prob, Tp, dtype)
    if slot is None:
        return {}, {}, 0.0
    if not selected and slot["L"] > 32:
        raise ValueError(
            f"compute_reconstruction_covariance gathers [T, L, L, 6, 6] blocks; supported up "
            f"to slot length 32, got L={slot['L']}. Pass view_ids= for the selected-block path."
        )
    ext = np.zeros((Vp, 6), dtype)
    ext[:V] = prob["extrinsics"]
    pts = np.zeros((Tp, 3), dtype)
    pts[:T] = prob["points"]
    G = recon.intrinsics.shape[0]
    P = recon.intrinsics.shape[1]
    Gp = _pad_pow2(max(G, 1), 4)
    intr_in = np.zeros((Gp, P), dtype)
    intr_in[:, 0] = 1.0
    intr_in[:, 1] = 1.0
    intr_in[:G] = recon.intrinsics.astype(dtype)
    view_group = np.zeros((Vp,), np.int32)
    view_group[:V] = recon.view_group
    groups_used = {int(g) for g in np.unique(recon.view_group[:V])}
    present = tuple(sorted({int(recon.group_model[g]) for g in groups_used} or {0}))
    group_model_idx = np.zeros((Gp,), np.int32)
    for g in range(G):
        m = int(recon.group_model[g])
        group_model_idx[g] = present.index(m) if m in present else 0
    cam_free = np.zeros(Vp, bool)
    cam_free[:V] = view_sel
    for v in constant_views:
        cam_free[v] = False
    pt_free = np.zeros(Tp, bool)
    pt_free[:T] = track_sel
    n_params = 6 * int(cam_free[:V].sum()) + 3 * int(pt_free[:T].sum())

    t = _tensors(device)
    common = (t(ext), t(intr_in), t(pts), t(view_group), t(group_model_idx),
              t(slot["track_views"]), t(slot["uv"]), t(slot["info"]), t(slot["mask"]),
              t(cam_free), t(pt_free))
    common_kw = dict(present_models=present, num_views=Vp, num_tracks=Tp,
                     max_track_len=slot["L"], num_groups=Gp, options=options)
    if selected:
        from .covariance import selected_covariance_pcg

        req_views = [int(v) for v in view_ids if cam_free[v]]
        req_tracks = [int(tr) for tr in (track_ids or ()) if pt_free[tr]]
        # Track marginals need S^-1 columns at their observing views.
        solve_views = list(dict.fromkeys(req_views))
        have = set(solve_views)
        for tr in req_tracks:
            for row in recon.track_observations(tr):
                v = int(recon.obs_view[row])
                if cam_free[v] and v not in have:
                    have.add(v)
                    solve_views.append(v)
        if not solve_views:
            return {}, {}, 0.0
        # The selections padded to powers of two, as the JAX entry pads them.
        sel_v = np.full((_pad_pow2(len(solve_views), 4),), solve_views[0], np.int32)
        sel_v[: len(solve_views)] = solve_views
        sel_t = np.zeros((_pad_pow2(max(len(req_tracks), 1), 4),), np.int32)
        sel_t[: len(req_tracks)] = req_tracks
        cam_cov, track_cov, cost, nres, _ = selected_covariance_pcg(
            *common, t(sel_v), t(sel_t), **common_kw)
        cam_cov, track_cov = cam_cov.cpu().numpy(), track_cov.cpu().numpy()
        variance_factor = 2.0 * float(cost) / max(int(nres) - n_params, 1)
        pos = {v: i for i, v in enumerate(solve_views)}
        return ({v: cam_cov[pos[v]] * variance_factor for v in req_views},
                {tr: track_cov[i] * variance_factor for i, tr in enumerate(req_tracks)},
                variance_factor)
    cam_cov, track_cov, cost, nres = joint_covariance_dense(*common, **common_kw)
    cam_cov, track_cov = cam_cov.cpu().numpy(), track_cov.cpu().numpy()
    variance_factor = 2.0 * float(cost) / max(int(nres) - n_params, 1)
    return ({v: cam_cov[v] * variance_factor for v in range(V) if cam_free[v]},
            {tr: track_cov[tr] * variance_factor for tr in range(T) if pt_free[tr]},
            variance_factor)


def _covariance_blocks(recon, options, dtype, device):
    """Hessian blocks U [V, 6, 6] and Vt [T, 3, 3], the robust cost and the
    observation count at the current state."""
    prob, _, _, V, T, Vp, Tp = _covariance_problem(recon, dtype)
    ext = np.zeros((Vp, 6), dtype)
    ext[:V] = prob["extrinsics"]
    pts = np.zeros((Tp, 3), dtype)
    pts[:T] = prob["points"]
    t = _tensors(device)
    U, Vt, cost, n_obs = hessian_blocks(
        t(ext), t(pts), t(prob["intrinsics_rows"]), t(prob["obs_view"]), t(prob["obs_track"]),
        t(prob["obs_uv"]), t(prob["obs_sqrt_info"]), t(prob["obs_mask"]), model=prob["model"],
        num_views=Vp, num_tracks=Tp, options=options)
    return U.cpu().numpy()[:V], Vt.cpu().numpy()[:T], float(cost), int(n_obs)


def _inverse_blocks(blocks, ids, variance_factor):
    """{id: inv(block) variance_factor} in f64, or None if a block is
    singular."""
    out = {}
    for i in ids:
        try:
            out[i] = np.linalg.inv(blocks[i].astype(np.float64)) * variance_factor
        except np.linalg.LinAlgError:
            return None
    return out


def bundle_adjust_views_with_cov(options: BundleAdjustmentOptions, view_ids, recon,
                                 dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustViews` with covariance
    (`bundle_adjustment.h:246-250`): optimize the views (tracks constant),
    then return (summary, {view: 6x6 empirical covariance}, the empirical
    variance factor sigma^2 = 2 cost / (residuals - parameters)); both None
    if a block is singular."""
    device = default_device(device)
    summary = bundle_adjust_views(options, view_ids, recon, dtype, device=device)
    U, _, cost, n_obs = _covariance_blocks(recon, options, dtype, device)
    variance_factor = 2.0 * cost / max(2 * n_obs - 6 * len(view_ids), 1)
    covariances = _inverse_blocks(U, view_ids, variance_factor)
    return summary, covariances, None if covariances is None else variance_factor


def bundle_adjust_view_with_cov(options, view_id, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustView` with covariance
    (`bundle_adjustment.h:239-243`)."""
    summary, covs, vf = bundle_adjust_views_with_cov(options, [view_id], recon, dtype,
                                                     device=device)
    return summary, (covs or {}).get(view_id), vf


def bundle_adjust_tracks_with_cov(options: BundleAdjustmentOptions, track_ids, recon,
                                  dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustTracks` with covariance
    (`bundle_adjustment.h:230-236`): per-track 3x3 covariances."""
    device = default_device(device)
    summary = bundle_adjust_tracks(options, track_ids, recon, dtype, device=device)
    _, Vt, cost, n_obs = _covariance_blocks(recon, options, dtype, device)
    variance_factor = 2.0 * cost / max(2 * n_obs - 3 * len(track_ids), 1)
    covariances = _inverse_blocks(Vt, track_ids, variance_factor)
    return summary, covariances, None if covariances is None else variance_factor


def bundle_adjust_track_with_cov(options, track_id, recon, dtype=np.float32, device=None):
    """Parity: `theia::BundleAdjustTrack` with covariance
    (`bundle_adjustment.h:223-228`)."""
    summary, covs, vf = bundle_adjust_tracks_with_cov(options, [track_id], recon, dtype,
                                                      device=device)
    return summary, (covs or {}).get(track_id), vf
