"""Rotation averaging over a view graph.

Counterpart of the JAX package's `global_pose/rotation_estimator.py`
(`theia/sfm/global_pose_estimation/robust_rotation_estimator.h:62-166`: L1
then IRLS on the tangent-space relaxation, Chatterjee & Govindu ICCV'13).

Conventions: orientations are world→camera angle-axis vectors R_i; an edge
(i, j) carries R_ij with R_j = R_ij · R_i. The relaxation uses camera-local
right perturbations R_i ← R_i · exp(δ_i), giving the first-order edge
equation δ_j − δ_i = log(R_jᵀ R_ij R_i) with the ±I incidence structure
(`robust_rotation_estimator.h:116-125`); every solve is CG on the device.

All five estimator types of the JAX package: ROBUST_L1L2 (the default),
NONLINEAR (`nonlinear_rotation_estimator.h:50`, robust Gauss-Newton),
LINEAR (`linear_rotation_estimator.h:55`, Martinec-Pajdla by block inverse
iteration), LAGRANGE_DUAL (`lagrange_dual_rotation_estimator.h:62`, the SDP
relaxation by `math/sdp.py`'s staircase) and HYBRID
(`hybrid_rotation_estimator.h:51`, LAGRANGE_DUAL then IRLS), with the MST
initialisation. A device mesh raises `NotImplementedError` (ROADMAP item G1).

LINEAR starts its inverse iteration from a random draw, which the JAX
package takes from `jax.random`: here it comes from a `torch.Generator`
with a fixed seed, or from the caller (`start`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..math import graph as graphops
from ..math import sdp as sdpmod
from ..math.l1 import admm_l1, conjugate_gradient, seeded_normal
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
    "irls_rotation_refine",
    "linear_rotation_averaging",
    "nonlinear_rotation_averaging",
    "lagrange_dual_rotation_averaging",
    "hybrid_rotation_averaging",
    "l1_rotation_global",
    "estimate_rotations",
]

# The seed of LINEAR's default random start (the JAX package: `PRNGKey(0)`).
_LINEAR_START_SEED = 0

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


def _signed_incidence(edge_i, edge_j, num_views, dtype):
    """The signed incidence matrix D [E, V]: one-hot(j) − one-hot(i)."""
    ar = torch.arange(num_views, device=edge_i.device)
    return (edge_j[:, None] == ar[None, :]).to(dtype) - (edge_i[:, None] == ar[None, :]).to(dtype)


def _degree_preconditioner(edge_i, edge_j, w, num_views):
    """r ↦ r / (the view's weighted degree), 1 for a view without edges."""
    degree = segment_sum(w, edge_i, num_views) + segment_sum(w, edge_j, num_views)
    inv_deg = torch.where(degree > 0, 1.0 / torch.clamp(degree, min=1.0), 1.0)
    return lambda r: (r.reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)


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
        D = _signed_incidence(edge_i, edge_j, num_views, dtype) * em
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

    precond = _degree_preconditioner(edge_i, edge_j, em[:, 0], num_views)

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


def irls_rotation_refine(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    num_iterations: int = 10, sigma: float = np.radians(5.0),
    cg_iterations: int = 50,
):
    """IRLS-only local refinement.

    Parity: `theia::IRLSRotationLocalRefiner`
    (`irls_rotation_local_refiner.h:52`), used by the hybrid estimator."""
    opts = RobustRotationEstimatorOptions(
        max_num_l1_iterations=0,
        max_num_irls_iterations=num_iterations,
        irls_loss_parameter_sigma=sigma,
        cg_iterations=cg_iterations,
    )
    return robust_rotation_averaging(
        orientations, edge_i, edge_j, rel_aa, free_mask, num_views, opts
    )


def linear_rotation_averaging(
    edge_i, edge_j, rel_aa, weights, num_views: int, power_iterations: int = 100,
    start=None,
):
    """Least-squares rotation averaging à la Martinec-Pajdla.

    Parity: `theia::LinearRotationEstimator`
    (`linear_rotation_estimator.h:55`): R minimizing
    Σ w_ij ||R_j − R_ij R_i||², the 3 smallest eigenvectors of the
    Laplacian-like operator L = D − M with 3×3 rotation blocks, by block
    inverse iteration as the JAX package does it: 4 outer steps, each
    solving (L + εI) Y = X for the 3 columns with `power_iterations` CG
    steps and re-orthonormalizing by QR, then per-view SO(3) projection.

    `start`: the random start [V, 3, 3] before its QR (None: a normal draw
    of a generator seeded `_LINEAR_START_SEED`). Returns [V, 3] angle-axis
    in a global gauge (removed downstream by `align_orientations`).
    """
    dtype, device = rel_aa.dtype, rel_aa.device
    R_rel = rotops.angle_axis_to_rotation_matrix(rel_aa)
    w = weights.to(dtype)
    deg = segment_sum(w, edge_i, num_views) + segment_sum(w, edge_j, num_views)
    eps = 1e-6 * torch.max(deg)

    def shifted(v):
        # L x + ε x, with M_{ji} = w R_ij (and its transpose term).
        x = v.reshape(num_views, 3)
        cj = (R_rel @ x[edge_i][..., None])[..., 0] * w[:, None]
        ci = (R_rel.mT @ x[edge_j][..., None])[..., 0] * w[:, None]
        Mx = segment_sum(cj, edge_j, num_views) + segment_sum(ci, edge_i, num_views)
        return (deg[:, None] * x - Mx + eps * x).reshape(-1)

    # Random start: a structured one (e.g. identity blocks) can sit in an
    # invariant subspace orthogonal to parts of the null space and stall.
    if start is None:
        start = seeded_normal((num_views, 3, 3), dtype, device, _LINEAR_START_SEED)
    X, _ = torch.linalg.qr(start.reshape(num_views * 3, 3))
    for _ in range(4):
        Y = torch.stack(
            [conjugate_gradient(shifted, X[:, k], iters=power_iterations) for k in range(3)],
            dim=-1,
        )
        X, _ = torch.linalg.qr(Y)
    X = X.reshape(num_views, 3, 3)

    # Zero residual means X_i = R_i G for a shared 3×3 gauge G; the polar
    # factor of X_i is then R_i · polar(G), one global right gauge. det(X_i)
    # = det(G) for every i: if negative, the per-block det-corrected SVD
    # would flip a degenerate direction arbitrarily per view, so flip one
    # column globally first.
    det_sign = torch.sign(torch.sum(torch.linalg.det(X)))
    X = torch.cat([X[:, :, :2], X[:, :, 2:] * det_sign], dim=-1)
    return rotops.rotation_matrix_to_angle_axis(rotops.project_to_so3(X))


def nonlinear_rotation_averaging(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    num_iterations: int = 10, huber_delta: float = 0.1,
):
    """Robust Gauss-Newton over pairwise rotation errors.

    Parity: `theia::NonlinearRotationEstimator`
    (`nonlinear_rotation_estimator.h:50`, Ceres + Huber(0.1) on the
    angle-axis pairwise error): the IRLS stage's linearization with Huber
    weights, 50 preconditioned CG steps a step. The signed incidence
    matrix is dense while E·V is at most `_DENSE_INCIDENCE_MAX`, else
    gathers and segment sums.
    """
    dtype, device = orientations.dtype, orientations.device
    fm = free_mask.to(dtype)[:, None]
    use_dense = edge_i.shape[0] * num_views <= _DENSE_INCIDENCE_MAX
    if use_dense:
        D = _signed_incidence(edge_i, edge_j, num_views, dtype)
    precond = _degree_preconditioner(
        edge_i, edge_j, torch.ones(edge_i.shape[0], dtype=dtype, device=device), num_views)

    R_aa = orientations
    for _ in range(num_iterations):
        e = _edge_residuals(R_aa, edge_i, edge_j, rel_aa)
        nrm = torch.linalg.norm(e, dim=-1)
        # Huber IRLS weight: 1 inside delta, delta/|r| outside.
        w = torch.where(nrm <= huber_delta, 1.0, huber_delta / torch.clamp(nrm, min=1e-12))
        sw = torch.sqrt(w)[:, None]

        def apply_Aw(delta, sw=sw):
            d = delta.reshape(num_views, 3) * fm
            ad = (D @ d) if use_dense else (d[edge_j] - d[edge_i])
            return (ad * sw).reshape(-1)

        def apply_Atw(y, sw=sw):
            yv = y.reshape(-1, 3) * sw
            if use_dense:
                return (D.T @ yv * fm).reshape(-1)
            acc = segment_sum(yv, edge_j, num_views) - segment_sum(yv, edge_i, num_views)
            return (acc * fm).reshape(-1)

        rhs = apply_Atw((e * sw).reshape(-1))
        delta = conjugate_gradient(
            lambda v: apply_Atw(apply_Aw(v)), rhs, iters=50, precond=precond
        )
        R_aa = _apply_update(R_aa, delta.reshape(num_views, 3) * fm)
    return R_aa


def _dual_cost(edge_i, edge_j, rel_aa, num_views):
    """The SDP cost C [3V, 3V]: C_ij = −R̃_ijᵀ and C_ji = −R̃_ij for every
    edge (duplicates add)."""
    R_rel = rotops.angle_axis_to_rotation_matrix(rel_aa)
    ar = torch.arange(3, device=rel_aa.device)
    rows_i = (3 * edge_i[:, None, None] + ar[None, :, None]).expand(-1, 3, 3)
    cols_j = (3 * edge_j[:, None, None] + ar[None, None, :]).expand(-1, 3, 3)
    C = torch.zeros((3 * num_views, 3 * num_views), dtype=rel_aa.dtype, device=rel_aa.device)
    C.index_put_((rows_i, cols_j), -R_rel.mT, accumulate=True)
    C.index_put_((cols_j.mT, rows_i.mT), -R_rel, accumulate=True)
    return C


def lagrange_dual_rotation_averaging(
    edge_i, edge_j, rel_aa, num_views: int, options=None, v0=None
):
    """Rotation averaging by SDP relaxation (strong Lagrangian duality).

    Parity: `theia::LagrangeDualRotationEstimator`
    (`lagrange_dual_rotation_estimator.h:62-115`), as the JAX package's:
    relax max Σ tr(R_iᵀ R̃_ijᵀ R_j) over SO(3)^n to the block SDP
    min tr(C X), X_ii = I₃, X ⪰ 0 with C_ij = −R̃_ijᵀ (dense [3V, 3V]),
    solved by `math/sdp.riemannian_staircase`; rounding projects the top-3
    subspace back to SO(3)^n. `options`: `SDPSolverOptions`; `v0`: the
    staircase's power-iteration start. Returns ([V, 3] angle-axis in a
    global gauge, the certificate's smallest eigenvalue).
    """
    if options is None:
        options = sdpmod.SDPSolverOptions()
    C = _dual_cost(edge_i, edge_j, rel_aa, num_views)
    Y, _, lam = sdpmod.riemannian_staircase(C, num_views, options, v0=v0)
    R = sdpmod.round_block_solution(Y, num_views)
    return rotops.rotation_matrix_to_angle_axis(R), lam


def hybrid_rotation_averaging(
    edge_i, edge_j, rel_aa, free_mask, num_views: int,
    sdp_options=None, irls_iterations: int = 10, v0=None,
):
    """Lagrange-dual initialization + IRLS local refinement.

    Parity: `theia::HybridRotationEstimator`
    (`hybrid_rotation_estimator.h:51-89`, LD + `IRLSRotationLocalRefiner`).
    """
    aa0, _ = lagrange_dual_rotation_averaging(
        edge_i, edge_j, rel_aa, num_views, sdp_options, v0=v0
    )
    return irls_rotation_refine(
        aa0, edge_i, edge_j, rel_aa, free_mask, num_views,
        num_iterations=irls_iterations,
    )


def l1_rotation_global(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    l1_iterations: int = 5,
):
    """L1-only global rotation estimation.

    Parity: `theia::L1RotationGlobalEstimator`
    (`l1_rotation_global_estimator.h:52`): the L1 stage of the robust
    estimator without the IRLS polish."""
    opts = RobustRotationEstimatorOptions(
        max_num_l1_iterations=l1_iterations, max_num_irls_iterations=0
    )
    return robust_rotation_averaging(
        orientations, edge_i, edge_j, rel_aa, free_mask, num_views, opts
    )


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
    (`global_reconstruction_estimator.cc:327-371`), dispatched as the JAX
    package's: LINEAR, LAGRANGE_DUAL and HYBRID (every view free) are
    aligned to the MST start by `align_orientations`; NONLINEAR and
    ROBUST_L1L2 start from it with the fixed views (default: the first)
    held. `options` applies to ROBUST_L1L2. `device`: where the solve runs
    (None: the CUDA card). One copy to the device, one back.
    """
    if mesh is not None:
        raise NotImplementedError(
            "rotation averaging over a device mesh is not ported yet (ROADMAP item G1)"
        )
    device = default_device(device)
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, rel_rot, _, weights = view_graph.edge_arrays(dtype)
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

    edges = (t(ei), t(ej), t(rel_rot))
    kind = int(estimator_type)
    if kind == GlobalRotationEstimatorType.LINEAR:
        out = linear_rotation_averaging(*edges, t(weights), V)
    elif kind == GlobalRotationEstimatorType.LAGRANGE_DUAL:
        out, _ = lagrange_dual_rotation_averaging(*edges, V)
    elif kind == GlobalRotationEstimatorType.HYBRID:
        out = hybrid_rotation_averaging(*edges, t(np.ones(V, bool)), V)
    elif kind == GlobalRotationEstimatorType.NONLINEAR:
        out = nonlinear_rotation_averaging(t(init), *edges, t(free), V)
    else:
        out = robust_rotation_averaging(
            t(init), *edges, t(free), V, options or RobustRotationEstimatorOptions()
        )
    if kind in (GlobalRotationEstimatorType.LINEAR, GlobalRotationEstimatorType.LAGRANGE_DUAL,
                GlobalRotationEstimatorType.HYBRID):
        # Gauge: align to the MST start.
        out = rotops.align_orientations(t(init), out)
    out = out.cpu().numpy()
    return {v: out[index[v]] for v in view_ids}
