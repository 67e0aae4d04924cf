"""Sim(3) alignment and pose-graph optimization between reconstructions.

Counterpart of the JAX package's `transforms/pose_graph_sim3.py`:
  - `OptimizeAlignmentSim3` (`transformation/align_point_clouds.h:157`):
    Umeyama start, then Gauss-Newton over the Sim(3) tangent with
    POINT_TO_POINT / ROBUST_POINT_TO_POINT (Huber) / POINT_TO_PLANE costs;
  - `Sim3Manifold` + `SelfEdgesErrorTerm` / `CrossEdgesErrorTerm`
    (`align_reconstructions_pose_graph_optim.h:43-150`): Gauss-Newton over a
    Sim(3) node a view with relative (self) and absolute (cross) edges;
  - `FindCommonTracksByFeatureInReconstructions`
    (`find_common_tracks_by_feature_in_reconstructions.h:49`), host dicts;
  - `AlignOverlapReconstructionsWithPointsAndPosesRobust`
    (`align_reconstructions.h:66`): common tracks -> robust Sim(3) ->
    transform -> pose priors from the reference -> bundle adjustment with
    priors.

Both solvers run in f64 on `device` (None: the CUDA card). The JAX package
forms the pose graph's dense Jacobian by `jax.jacfwd` over every node; here
each edge's 7x14 block comes from forward-mode passes (`torch.autograd.forward_ad`:
each node's exp once, then each edge's product and log), and the normal
equations are assembled from the blocks by `index_add_` into the same dense
[7N, 7N] matrix, solved as the JAX package solves it.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import default_device
from ..ba.lm import _forward_jacobians
from ..ops import lie
from .alignment import align_point_clouds_umeyama, transform_reconstruction

__all__ = [
    "Sim3AlignmentType",
    "Sim3AlignmentOptions",
    "Sim3AlignmentSummary",
    "optimize_alignment_sim3",
    "optimize_sim3_pose_graph",
    "find_common_tracks_by_feature_in_reconstructions",
    "align_overlap_reconstructions_with_points_and_poses_robust",
]

_F64 = torch.float64


class Sim3AlignmentType(enum.Enum):
    """Parity: `theia::Sim3AlignmentType` (`align_point_clouds.h:73-77`)."""

    POINT_TO_POINT = 0
    ROBUST_POINT_TO_POINT = 1
    POINT_TO_PLANE = 2


@dataclasses.dataclass
class Sim3AlignmentOptions:
    """Parity: `theia::Sim3AlignmentOptions` (`align_point_clouds.h:80-105`)."""

    alignment_type: Sim3AlignmentType = Sim3AlignmentType.POINT_TO_POINT
    initial_sim3_params: np.ndarray | None = None  # [7] (rho, phi, sigma)
    point_weight: float = 1.0
    huber_threshold: float = 0.1
    outlier_threshold: float = 1.0
    max_iterations: int = 100
    target_normals: np.ndarray | None = None  # [N, 3] for POINT_TO_PLANE


@dataclasses.dataclass
class Sim3AlignmentSummary:
    """Parity: `theia::Sim3AlignmentSummary` (`align_point_clouds.h:143`)."""

    success: bool = False
    final_cost: float = 0.0
    num_iterations: int = 0
    alignment_error: float = 0.0
    sim3_params: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(7))


def _apply(xi, src):
    """S(xi) applied to src [N, 3]; xi [.., 7] -> [.., N, 3]."""
    s, R, t = lie.sim3_exp(xi)
    return s[..., None, None] * torch.einsum("...ij,nj->...ni", R, src) + t[..., None, :]


def _sim3_gn(xi0, src, tgt, normals, huber, iters: int, robust: bool, point_to_plane: bool):
    """Gauss-Newton refinement of a Sim(3) tangent [7] aligning src -> tgt.
    Returns (xi, the cost of the iterate before the last step), as the JAX
    function does."""

    def residuals(xi):
        r = _apply(xi, src) - tgt
        if point_to_plane:
            r = torch.sum(r * normals, dim=-1, keepdim=True)
        return r

    eye = torch.eye(7, dtype=xi0.dtype, device=xi0.device)
    xi, cost = xi0, torch.tensor(float("inf"), dtype=xi0.dtype, device=xi0.device)
    for _ in range(iters):
        r, (J,) = _forward_jacobians(residuals, (xi,), (True,))  # [N, d], [N, d, 7]
        if robust:
            nrm = torch.linalg.norm(r, dim=-1)
            w = torch.where(nrm <= huber, 1.0, huber / torch.clamp(nrm, min=1e-12))
        else:
            w = torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
        J = J.reshape(-1, 7)
        wr = (r * w[:, None]).reshape(-1)
        Jw = J * w.repeat_interleave(r.shape[1])[:, None]
        delta = torch.linalg.solve(Jw.T @ J + 1e-9 * eye, Jw.T @ r.reshape(-1))
        cost = 0.5 * torch.sum(wr * r.reshape(-1))
        xi = xi - delta
    return xi, cost


def optimize_alignment_sim3(source_points, target_points,
                            options: Sim3AlignmentOptions | None = None,
                            device=None) -> Sim3AlignmentSummary:
    """Parity: `theia::OptimizeAlignmentSim3` (`align_point_clouds.h:157`):
    the Sim(3) S with target ~= S(source), in f64 on `device` (None: the
    CUDA card). `sim3_params` is the tangent that `lie.sim3_exp` reads."""
    device = default_device(device)
    options = options or Sim3AlignmentOptions()
    src_np = np.asarray(source_points, np.float64)
    tgt_np = np.asarray(target_points, np.float64)
    summary = Sim3AlignmentSummary()
    if len(src_np) < 3:
        return summary
    src = torch.as_tensor(src_np, device=device)
    tgt = torch.as_tensor(tgt_np, device=device)

    if options.initial_sim3_params is not None:
        xi0 = torch.as_tensor(np.asarray(options.initial_sim3_params, np.float64), device=device)
    else:
        R, t, s = align_point_clouds_umeyama(src, tgt)
        xi0 = lie.sim3_log(s, R, t)

    ptp = options.alignment_type == Sim3AlignmentType.POINT_TO_PLANE
    normals = (torch.as_tensor(np.asarray(options.target_normals, np.float64), device=device)
               if ptp and options.target_normals is not None else torch.zeros_like(tgt))
    iters = max(1, min(options.max_iterations, 50))
    robust = options.alignment_type == Sim3AlignmentType.ROBUST_POINT_TO_POINT
    xi, cost = _sim3_gn(xi0, src, tgt, normals, options.huber_threshold, iters, robust, ptp)
    if robust:
        # Huber only down-weights gross outliers: trim by outlier_threshold
        # and refit on the inliers.
        inliers = (torch.linalg.norm(_apply(xi, src) - tgt, dim=-1)
                   < options.outlier_threshold).cpu().numpy()
        if 3 <= inliers.sum() < len(src_np):
            keep = torch.as_tensor(inliers, device=device)
            xi, cost = _sim3_gn(xi, src[keep], tgt[keep], torch.zeros_like(tgt[keep]),
                                options.huber_threshold, iters, False, False)
    err = torch.linalg.norm(_apply(xi, src) - tgt, dim=-1).cpu().numpy()
    summary.success = bool(np.isfinite(err).all())
    summary.final_cost = float(cost)
    summary.num_iterations = iters
    summary.alignment_error = float(np.mean(err))
    summary.sim3_params = xi.cpu().numpy()
    return summary


def _flat(s, R, t):
    """A Sim(3) element (s, R, t) as one [.., 13] tensor."""
    return torch.cat([s[..., None], R.flatten(-2), t], dim=-1)


def _unflat(g):
    return g[..., 0], g[..., 1:10].unflatten(-1, (3, 3)), g[..., 10:]


def _self_residual(g_i, g_j, sji_inverse, sqrt_info):
    """sqrt_info log((S_i^-1 S_j) S_ji^-1) (`SelfEdgesErrorTerm`)."""
    rel = lie.sim3_multiply(*lie.sim3_inverse(*_unflat(g_i)), *_unflat(g_j))
    err = lie.sim3_log(*lie.sim3_multiply(*rel, *sji_inverse))
    return (sqrt_info @ err[..., None])[..., 0]


def _cross_residual(g_i, sref_inverse, sqrt_info):
    """sqrt_info log(S_i S_ref^-1) (`CrossEdgesErrorTerm`)."""
    err = lie.sim3_log(*lie.sim3_multiply(*_unflat(g_i), *sref_inverse))
    return (sqrt_info @ err[..., None])[..., 0]


def _edge_jacobians(residual, groups, derivatives, *constants):
    """residual(*groups, *constants) [E, 7] and its Jacobian [E, 7, 7] with
    respect to the tangent of each node in `groups` ([E, 13] each), from the
    nodes' exp derivatives ([E, 13, 7] each): one forward-mode pass, a
    direction for each tangent coordinate of each node."""
    D = 7 * len(groups)
    with forward_ad.dual_level():
        duals = []
        for k, (g, dg) in enumerate(zip(groups, derivatives)):
            tangent = torch.zeros((D, *g.shape), dtype=g.dtype, device=g.device)
            tangent[7 * k:7 * k + 7] = dg.movedim(-1, 0)
            duals.append(forward_ad.make_dual(g.expand(D, *g.shape).contiguous(), tangent))
        r, J = forward_ad.unpack_dual(residual(*duals, *constants))
    J = J.movedim(0, -1)
    return r[0], [J[..., 7 * k:7 * k + 7] for k in range(len(groups))]


def _pose_graph_gn(nodes, self_i, self_j, self_sij, self_sq, cross_i, cross_sref, cross_sq,
                   free, iters: int):
    """Gauss-Newton over Sim(3) nodes [N, 7] (log coordinates), the JAX
    function's steps: H = J^T J + 1e-8 I over every node, delta = H^-1 J^T r,
    the fixed nodes' rows of the step zeroed (`free` [N]). Each node's exp and
    its derivative along its 7 tangent directions are formed once a step;
    each edge's blocks follow by the chain rule through its product and log.
    Returns (nodes, the squared cost at the last nodes)."""
    N = nodes.shape[0]
    eye = torch.eye(7 * N, dtype=nodes.dtype, device=nodes.device)
    sji_inverse = lie.sim3_inverse(*lie.sim3_exp(self_sij))
    sref_inverse = lie.sim3_inverse(*lie.sim3_exp(cross_sref))
    for _ in range(iters):
        g, (dg,) = _forward_jacobians(lambda xi: _flat(*lie.sim3_exp(xi)), (nodes,), (True,))
        rs, (Ji, Jj) = _edge_jacobians(_self_residual, (g[self_i], g[self_j]),
                                       (dg[self_i], dg[self_j]), sji_inverse, self_sq)
        rc, (Jc,) = _edge_jacobians(_cross_residual, (g[cross_i],), (dg[cross_i],),
                                    sref_inverse, cross_sq)
        H = torch.zeros(N * N, 7, 7, dtype=nodes.dtype, device=nodes.device)
        grad = torch.zeros(N, 7, dtype=nodes.dtype, device=nodes.device)
        blocks = [(self_i, self_i, Ji, Ji), (self_j, self_j, Jj, Jj),
                  (self_i, self_j, Ji, Jj), (self_j, self_i, Jj, Ji), (cross_i, cross_i, Jc, Jc)]
        for a, b, Ja, Jb in blocks:
            H.index_add_(0, a * N + b, Ja.mT @ Jb)
        for a, Ja, r in ((self_i, Ji, rs), (self_j, Jj, rs), (cross_i, Jc, rc)):
            grad.index_add_(0, a, (Ja.mT @ r[..., None])[..., 0])
        H = H.reshape(N, N, 7, 7).permute(0, 2, 1, 3).reshape(7 * N, 7 * N)
        delta = torch.linalg.solve(H + 1e-8 * eye, grad.reshape(-1)).reshape(N, 7)
        nodes = nodes - delta * free[:, None]
    g = _flat(*lie.sim3_exp(nodes))
    cost = torch.sum(_self_residual(g[self_i], g[self_j], sji_inverse, self_sq) ** 2) + \
        torch.sum(_cross_residual(g[cross_i], sref_inverse, cross_sq) ** 2)
    return nodes, cost


def optimize_sim3_pose_graph(nodes, self_edges=(), cross_edges=(), fixed_nodes=(),
                             iters: int = 20, device=None):
    """Sim(3) pose-graph optimization in f64 on `device` (None: the CUDA
    card).

    nodes: [N, 7] log coordinates (rho, phi, sigma) of world->camera Sim3s.
    self_edges: list of (i, j, Sji_log [7], sqrt_info [7, 7] | None).
    cross_edges: list of (i, Sref_log [7], sqrt_info [7, 7] | None).
    Returns (nodes [N, 7], the final squared cost).
    """
    device = default_device(device)
    nodes = np.asarray(nodes, np.float64)
    N = len(nodes)
    eye = np.eye(7)

    def unpack(edges, n_idx):
        idx = [torch.as_tensor(np.asarray([e[k] for e in edges], np.int64), device=device)
               for k in range(n_idx)]
        logs = np.asarray([e[n_idx] for e in edges], np.float64).reshape(-1, 7)
        sq = np.asarray([eye if (len(e) <= n_idx + 1 or e[n_idx + 1] is None) else e[n_idx + 1]
                         for e in edges], np.float64).reshape(-1, 7, 7)
        return idx, torch.as_tensor(logs, device=device), torch.as_tensor(sq, device=device)

    if not self_edges:
        self_edges = [(0, 0, np.zeros(7), np.zeros((7, 7)))]
    if not cross_edges:
        cross_edges = [(0, nodes[0], np.zeros((7, 7)))]
    (si, sj), s_logs, s_sq = unpack(self_edges, 2)
    (ci,), c_logs, c_sq = unpack(cross_edges, 1)
    free = np.ones(N)
    free[list(fixed_nodes)] = 0.0
    out, cost = _pose_graph_gn(torch.as_tensor(nodes, device=device), si, sj, s_logs, s_sq, ci,
                               c_logs, c_sq, torch.as_tensor(free, device=device), iters)
    return out.cpu().numpy(), float(cost)


def find_common_tracks_by_feature_in_reconstructions(recon_ref, recon_qry, view_matches_ref_qry,
                                                     pixel_tolerance: float = 0.25):
    """Parity: `theia::FindCommonTracksByFeatureInReconstructions`
    (`find_common_tracks_by_feature_in_reconstructions.h:49`): two tracks
    correspond where both reconstructions observe the same feature location
    (to `pixel_tolerance`, Python's `round`) in a matched view pair; each
    reference track keeps its first correspondence. Returns (points_ref
    [N, 3], points_qry [N, 3], track id pairs)."""

    def key(uv):
        return (round(uv[0] / pixel_tolerance), round(uv[1] / pixel_tolerance))

    def feature_map(recon, view_id):
        return {key(recon.obs_uv[row]): (t, row)
                for t, row in recon._view_track_to_obs[view_id].items()}

    def point3(recon, t):
        p = recon.points[t]
        return p[:3] / (p[3] if abs(p[3]) > 1e-12 else 1.0)

    corr = {}
    pts_ref, pts_qry, pairs = [], [], []
    for vid_ref, vid_qry in view_matches_ref_qry:
        fm_qry = feature_map(recon_qry, vid_qry)
        for t_ref, row in recon_ref._view_track_to_obs[vid_ref].items():
            if not recon_ref.track_estimated[t_ref]:
                continue
            hit = fm_qry.get(key(recon_ref.obs_uv[row]))
            if hit is None:
                continue
            t_qry = hit[0]
            if not recon_qry.track_estimated[t_qry] or corr.get(t_ref, t_qry) != t_qry:
                continue
            corr[t_ref] = t_qry
            pts_ref.append(point3(recon_ref, t_ref))
            pts_qry.append(point3(recon_qry, t_qry))
            pairs.append((t_ref, t_qry))
    return np.asarray(pts_ref).reshape(-1, 3), np.asarray(pts_qry).reshape(-1, 3), pairs


def align_overlap_reconstructions_with_points_and_poses_robust(
    recon_ref,
    recon_qry,
    view_matches_ref_qry,
    sim3_options: Sim3AlignmentOptions | None = None,
    position_prior_information: float = 100.0,
    orientation_prior_information: float = 5.0,
    ba_iterations: int = 50,
    device=None,
):
    """Parity: `theia::AlignOverlapReconstructionsWithPointsAndPosesRobust`
    (`align_reconstructions.h:66`; workflow
    `align_reconstructions_pose_graph_optim_test.cc:169-200`): common tracks
    by feature -> robust Sim(3) of their points -> transform the query
    reconstruction -> position and orientation priors from the reference's
    poses of the overlap views -> bundle adjustment of the query with those
    priors, on `device` (None: the CUDA card). Returns the
    Sim3AlignmentSummary."""
    from ..ba.entry import bundle_adjust_reconstruction
    from ..ba.lm import BundleAdjustmentOptions

    device = default_device(device)
    sim3_options = sim3_options or Sim3AlignmentOptions(
        alignment_type=Sim3AlignmentType.ROBUST_POINT_TO_POINT)
    pts_ref, pts_qry, _ = find_common_tracks_by_feature_in_reconstructions(
        recon_ref, recon_qry, view_matches_ref_qry)
    summary = optimize_alignment_sim3(pts_qry, pts_ref, sim3_options, device=device)
    if not summary.success:
        return summary
    s, R, t = lie.sim3_exp(torch.as_tensor(summary.sim3_params, dtype=_F64))
    transform_reconstruction(recon_qry, R.numpy(), t.numpy(), float(s))

    for vid_ref, vid_qry in view_matches_ref_qry:
        # A copy for each view: views added with one prior object share it,
        # and the JAX function's in-place update gives every view that
        # shares it this view's pose (ROADMAP.md, section 3).
        recon_qry.view_priors[vid_qry] = dataclasses.replace(
            recon_qry.view_priors[vid_qry],
            position=recon_ref.view_extrinsics[vid_ref, :3].copy(),
            position_sqrt_information=np.eye(3) * position_prior_information,
            orientation=recon_ref.view_extrinsics[vid_ref, 3:].copy(),
            orientation_sqrt_information=np.eye(3) * orientation_prior_information)

    ba_options = BundleAdjustmentOptions(max_num_iterations=ba_iterations,
                                         use_position_priors=True, use_orientation_priors=True)
    bundle_adjust_reconstruction(ba_options, recon_qry, device=device)
    return summary
