"""Rotation averaging over a view graph.

Counterpart of the JAX package's `global_pose/rotation_estimator.py`
(`theia/sfm/global_pose_estimation/robust_rotation_estimator.h:62-166`: L1
then IRLS on the tangent-space relaxation, Chatterjee & Govindu ICCV'13).

Conventions: orientations are world→camera angle-axis vectors R_i; an edge
(i, j) carries R_ij with R_j = R_ij · R_i. The relaxation uses camera-local
right perturbations R_i ← R_i · exp(δ_i), giving the first-order edge
equation δ_j − δ_i = log(R_jᵀ R_ij R_i) with the ±I incidence structure
(`robust_rotation_estimator.h:116-125`); every solve is CG on the device.

Ported: the maximum-spanning-tree initialisation and ROBUST_L1L2, the
default estimator. LINEAR, NONLINEAR, LAGRANGE_DUAL and HYBRID raise
`NotImplementedError` (ROADMAP item D1), a device mesh raises (item G1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..math import graph as graphops
from ..math.l1 import admm_l1, conjugate_gradient
from ..ops import rotation as rotops
from ..ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from ..ops.segment import segment_sum

__all__ = [
    "GlobalRotationEstimatorType",
    "RobustRotationEstimatorOptions",
    "orientations_from_maximum_spanning_tree",
    "robust_rotation_averaging",
    "estimate_rotations",
]

# Above this many incidence entries (E x V; about 1 GB in f64) the operator
# is applied by gathers and segment sums instead of a dense incidence matrix.
_DENSE_INCIDENCE_MAX = 134_000_000


class GlobalRotationEstimatorType:
    """Parity: `GlobalRotationEstimatorType` enum
    (`reconstruction_estimator_options.h`)."""

    ROBUST_L1L2 = 0
    NONLINEAR = 1
    LINEAR = 2
    LAGRANGE_DUAL = 3
    HYBRID = 4


@dataclasses.dataclass(frozen=True)
class RobustRotationEstimatorOptions:
    """Parity: `RobustRotationEstimator::Options`
    (`robust_rotation_estimator.h:66-77`)."""

    max_num_l1_iterations: int = 5
    max_num_irls_iterations: int = 10
    irls_loss_parameter_sigma: float = np.radians(5.0)
    cg_iterations: int = 50
    admm_iterations: int = 50


def orientations_from_maximum_spanning_tree(view_graph):
    """Initialize orientations by chaining relative rotations along the
    maximum spanning tree (weight = #verified matches).

    Parity: `theia::OrientationsFromMaximumSpanningTree`
    (`view_graph/orientations_from_maximum_spanning_tree.h:50`). Host-side
    walk in numpy. Returns {view_id: angle-axis ndarray}.
    """
    v1, v2, rel_rot, _, weights = view_graph.edge_arrays()
    if len(v1) == 0:
        return {}
    edges = np.stack([v1, v2], -1)
    tree = graphops.maximum_spanning_tree(edges, weights)
    adj: dict[int, list[tuple[int, int]]] = {}
    for e in tree:
        adj.setdefault(int(v1[e]), []).append((int(v2[e]), e))
        adj.setdefault(int(v2[e]), []).append((int(v1[e]), e))
    R_rel_all = angle_axis_to_rotation_matrix_np(rel_rot)
    root = int(min(adj.keys()))
    orientations = {root: np.zeros(3)}
    R_cache = {root: np.eye(3)}
    stack = [root]
    while stack:
        cur = stack.pop()
        R_cur = R_cache[cur]
        for (nb, e) in adj[cur]:
            if nb in orientations:
                continue
            R_rel = R_rel_all[e]
            # Edge stores v1->v2: R_{v2} = R_rel · R_{v1}.
            if int(v1[e]) == cur:
                R_nb = R_rel @ R_cur
            else:
                R_nb = R_rel.T @ R_cur
            R_cache[nb] = R_nb
            orientations[nb] = rotation_matrix_to_angle_axis_np(R_nb)
            stack.append(nb)
    return orientations


def _edge_residuals(orientations, edge_i, edge_j, rel_aa):
    """e_ij = log(R_jᵀ R_ij R_i) for every edge."""
    R = rotops.angle_axis_to_rotation_matrix(orientations)
    R_rel = rotops.angle_axis_to_rotation_matrix(rel_aa)
    loop = R[edge_j].mT @ R_rel @ R[edge_i]
    return rotops.rotation_matrix_to_angle_axis(loop)


def _apply_update(orientations, delta):
    """R_i ← R_i · exp(δ_i) (camera-local right perturbation)."""
    R = rotops.angle_axis_to_rotation_matrix(orientations)
    dR = rotops.angle_axis_to_rotation_matrix(delta)
    return rotops.rotation_matrix_to_angle_axis(R @ dR)


def _laplacian(edge_i, edge_j, w, num_views):
    """Dᵀ diag(w) D assembled from segment sums, [V, V]."""
    deg = segment_sum(w, edge_i, num_views) + segment_sum(w, edge_j, num_views)
    adj = torch.zeros((num_views, num_views), dtype=w.dtype, device=w.device)
    adj.index_put_((edge_i, edge_j), w, accumulate=True)
    return torch.diag(deg) - (adj + adj.T)


def robust_rotation_averaging(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    options: RobustRotationEstimatorOptions = RobustRotationEstimatorOptions(),
    edge_mask=None,
):
    """L1 stage then IRLS stage, each relinearized every step.

    Parity: `RobustRotationEstimator::EstimateRotations`
    (`robust_rotation_estimator.h:90`). Tensors on one device:
    orientations [V, 3], edge_i / edge_j [E] int64, rel_aa [E, 3],
    free_mask [V] bool (fixed views keep δ = 0), edge_mask [E] bool
    (optional; masked edges contribute nothing). Returns [V, 3].

    Every CG step applies the graph Laplacian L = DᵀD [V, V], assembled
    once: with D the signed incidence matrix [E, V] (one-hot(j) −
    one-hot(i)) as a dense product while E·V is at most
    `_DENSE_INCIDENCE_MAX`, else from segment sums. A and Aᵀ follow the
    same choice.
    """
    dtype = orientations.dtype
    device = orientations.device
    fm = free_mask.to(dtype)[:, None]
    E = edge_i.shape[0]
    em = (
        torch.ones((E, 1), dtype=dtype, device=device)
        if edge_mask is None
        else edge_mask.to(dtype)[:, None]
    )
    use_dense = E * num_views <= _DENSE_INCIDENCE_MAX
    if use_dense:
        ar = torch.arange(num_views, device=device)
        D = (edge_j[:, None] == ar[None, :]).to(dtype) - (
            edge_i[:, None] == ar[None, :]
        ).to(dtype)
        D = D * em
        Lap = D.T @ D
    else:
        Lap = _laplacian(edge_i, edge_j, em[:, 0], num_views)

    def apply_A(delta):
        d = delta.reshape(num_views, 3) * fm
        if use_dense:
            return (D @ d).reshape(-1)
        return ((d[edge_j] - d[edge_i]) * em).reshape(-1)

    def apply_At(y):
        yv = y.reshape(-1, 3) * em
        if use_dense:
            return (D.T @ yv * fm).reshape(-1)
        acc = segment_sum(yv, edge_j, num_views) - segment_sum(yv, edge_i, num_views)
        return (acc * fm).reshape(-1)

    def normal_matvec(delta):
        d = delta.reshape(num_views, 3) * fm
        return (Lap @ d * fm).reshape(-1)

    degree = segment_sum(em[:, 0], edge_i, num_views) + segment_sum(
        em[:, 0], edge_j, num_views
    )
    inv_deg = torch.where(degree > 0, 1.0 / torch.clamp(degree, min=1.0), 1.0)

    def precond(r):
        return (r.reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)

    R_aa = orientations
    for _ in range(options.max_num_l1_iterations):
        e = (_edge_residuals(R_aa, edge_i, edge_j, rel_aa) * em).reshape(-1)
        delta = admm_l1(
            apply_A, apply_At, e, (num_views * 3,),
            outer_iters=options.admm_iterations,
            cg_iters=options.cg_iterations, precond=precond,
            normal_matvec=normal_matvec,
        )
        R_aa = _apply_update(R_aa, delta.reshape(num_views, 3) * fm)

    sigma = torch.tensor(options.irls_loss_parameter_sigma, dtype=dtype, device=device)
    for _ in range(options.max_num_irls_iterations):
        e = _edge_residuals(R_aa, edge_i, edge_j, rel_aa) * em
        # Geman-McClure weights on the edge residual norm
        # (`robust_rotation_estimator.h:140`).
        nrm2 = torch.sum(e * e, dim=-1)
        w = ((sigma**2 / (nrm2 + sigma**2)) ** 2) * em[:, 0]
        sw = torch.sqrt(w)[:, None]
        # Weighted Laplacian Dᵀ diag(w) D, once a relinearization.
        if use_dense:
            Lw = D.T @ (D * w[:, None])
        else:
            Lw = _laplacian(edge_i, edge_j, w, num_views)

        def matvec(v, Lw=Lw):
            d = v.reshape(num_views, 3) * fm
            return (Lw @ d * fm).reshape(-1)

        rhs = apply_At((e * sw * sw).reshape(-1))
        delta = conjugate_gradient(
            matvec, rhs, iters=options.cg_iterations, precond=precond
        )
        R_aa = _apply_update(R_aa, delta.reshape(num_views, 3) * fm)
    return R_aa


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


def estimate_rotations(
    view_graph,
    estimator_type: int = GlobalRotationEstimatorType.ROBUST_L1L2,
    initial_orientations: dict | None = None,
    fixed_views: set | None = None,
    options: RobustRotationEstimatorOptions | None = None,
    dtype=np.float64,
    mesh=None,
    device=None,
):
    """Host entry: view graph → {view_id: angle-axis}.

    Parity: the `RotationEstimator::EstimateRotations` interface
    (`rotation_estimator.h:50`) with the MST initialisation of
    `GlobalReconstructionEstimator::EstimateGlobalRotations`
    (`global_reconstruction_estimator.cc:327-371`). `device`: where the
    solve runs (None: the CUDA card). One copy to the device, one back.
    """
    if int(estimator_type) != GlobalRotationEstimatorType.ROBUST_L1L2:
        raise _unported(f"rotation estimator type {int(estimator_type)}", "D1")
    if mesh is not None:
        raise _unported("rotation averaging over a device mesh", "G1")
    device = default_device(device)
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, rel_rot, _, _ = view_graph.edge_arrays(dtype)
    ei = np.asarray([index[v] for v in v1], np.int64)
    ej = np.asarray([index[v] for v in v2], np.int64)

    if initial_orientations is None:
        initial_orientations = orientations_from_maximum_spanning_tree(view_graph)
    init = np.zeros((V, 3), dtype)
    for v, aa in initial_orientations.items():
        if v in index:
            init[index[v]] = aa

    free = np.ones(V, bool)
    if fixed_views:
        for v in fixed_views:
            if v in index:
                free[index[v]] = False
    else:
        free[0] = False  # gauge: fix the first view

    def t(a):
        return torch.as_tensor(a, device=device)

    out = robust_rotation_averaging(
        t(init), t(ei), t(ej), t(rel_rot), t(free), V,
        options or RobustRotationEstimatorOptions(),
    ).cpu().numpy()
    return {v: out[index[v]] for v in view_ids}
