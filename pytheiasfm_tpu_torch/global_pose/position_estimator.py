"""Position averaging from pairwise translation directions.

Counterpart of the JAX package's `global_pose/position_estimator.py`
(`theia/sfm/global_pose_estimation/least_unsquared_deviation_position_
estimator.h:58`: LUD, Ozyesil & Singer CVPR'15, a convex ‖·‖₂-deviation
objective with scale variables s_ij ≥ 1). The solver runs a fixed number of
ADMM steps with operator-form CG (gather / segment-sum matvecs) on the
device.

Edge data: for edge (i, j) the view graph stores `position_2`, the unit
position of camera j in camera i's frame; the world-frame direction is
t_ij = R_iᵀ · position_2 with c_j − c_i ≈ s_ij t_ij, s_ij > 0.

Ported: LEAST_UNSQUARED_DEVIATION, the default. NONLINEAR, LINEAR_TRIPLET,
LIGT and BATA raise `NotImplementedError` (ROADMAP item D1), a device mesh
raises (item G1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..math.l1 import conjugate_gradient
from ..ops import rotation as rotops
from ..ops.segment import segment_sum

__all__ = [
    "GlobalPositionEstimatorType",
    "relative_translations_to_world",
    "least_unsquared_deviation_positions",
    "estimate_positions",
]


class GlobalPositionEstimatorType:
    """Parity: `GlobalPositionEstimatorType`
    (`reconstruction_estimator_options.h`), with BATA as the JAX package
    has it."""

    NONLINEAR = 0
    LINEAR_TRIPLET = 1
    LEAST_UNSQUARED_DEVIATION = 2
    LIGT = 3
    BATA = 4


def relative_translations_to_world(orientations, edge_i, rel_positions):
    """t_ij(world) = R_iᵀ · position_2, unit-normalized."""
    Ri = rotops.angle_axis_to_rotation_matrix(orientations)[edge_i]
    t = (Ri.mT @ rel_positions[..., None])[..., 0]
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)


def least_unsquared_deviation_positions(
    edge_i, edge_j, t_world, free_mask, num_views: int,
    outer_iters: int = 200, cg_iters: int = 30, rho: float = 1.0,
    edge_mask=None,
):
    """LUD: min Σ ‖c_j − c_i − s_ij t_ij‖₂ s.t. s_ij ≥ 1.

    Parity: `LeastUnsquaredDeviationPositionEstimator`
    (`least_unsquared_deviation_position_estimator.h:58`, solved there by
    `ConstrainedL1Solver` ADMM, `.cc:104`). With x = (c, s) and A x the
    stacked edge residuals,

        min Σ_e ‖z1_e‖₂ + 1_{z2 ≥ 1}   s.t.  A x = z1,  s = z2,

    the x-update is a CG solve of (AᵀA + [0; I_s]) x = Aᵀ(z1−u1) +
    (z2−u2), the z1-update the group soft threshold (the prox of the
    sum of norms), and the z2-update projects the scales to s ≥ 1, the
    constraint that forbids the collapse c ≡ 0. Tensors on one device;
    returns [V, 3].
    """
    E = edge_i.shape[0]
    dtype = t_world.dtype
    device = t_world.device
    fm = free_mask.to(dtype)[:, None]
    nC = num_views * 3

    ones = (
        torch.ones((E,), dtype=dtype, device=device)
        if edge_mask is None
        else edge_mask.to(dtype)
    )
    deg = segment_sum(ones, edge_i, num_views) + segment_sum(ones, edge_j, num_views)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 1.0)

    def apply_A(x):
        dc = x[:nC].reshape(num_views, 3) * fm
        ds = x[nC:]
        return dc[edge_j] - dc[edge_i] - ds[:, None] * t_world

    def apply_At(re):
        gc = segment_sum(re, edge_j, num_views) - segment_sum(re, edge_i, num_views)
        gs = -torch.sum(re * t_world, dim=-1)
        return torch.cat([(gc * fm).reshape(-1), gs])

    def matvec(x):
        out = apply_At(apply_A(x))
        # + identity on the s block from the s = z2 constraint.
        return torch.cat([out[:nC], out[nC:] + x[nC:]])

    def precond(v):
        pc = (v[:nC].reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)
        return torch.cat([pc, v[nC:] * 0.5])

    def group_shrink(v, kappa):
        nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
        scale = torch.clamp(1.0 - kappa / torch.clamp(nrm, min=1e-12), min=0.0)
        return v * scale

    x = torch.cat([
        torch.zeros((nC,), dtype=dtype, device=device),
        torch.ones((E,), dtype=dtype, device=device),
    ])
    z1 = torch.zeros((E, 3), dtype=dtype, device=device)
    u1 = torch.zeros((E, 3), dtype=dtype, device=device)
    z2 = torch.ones((E,), dtype=dtype, device=device)
    u2 = torch.zeros((E,), dtype=dtype, device=device)
    for _ in range(outer_iters):
        rhs = apply_At(z1 - u1)
        rhs = torch.cat([rhs[:nC], rhs[nC:] + (z2 - u2)])
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters, precond=precond)
        Ax = apply_A(x)
        z1 = group_shrink(Ax + u1, 1.0 / rho)
        u1 = u1 + Ax - z1
        s = x[nC:]
        z2 = torch.clamp(s + u2, min=1.0)
        u2 = u2 + s - z2
    return x[:nC].reshape(num_views, 3) * fm


def estimate_positions(
    view_graph,
    orientations: dict,
    estimator_type: int = GlobalPositionEstimatorType.LEAST_UNSQUARED_DEVIATION,
    fixed_views: set | None = None,
    dtype=np.float64,
    mesh=None,
    device=None,
):
    """Host entry: view graph + orientations → {view_id: position}.

    Parity: the `PositionEstimator::EstimatePositions` interface
    (`position_estimator.h:53`) as dispatched by
    `GlobalReconstructionEstimator::EstimatePosition`
    (`global_reconstruction_estimator.cc:418-452`). `device`: where the
    solve runs (None: the CUDA card).
    """
    if int(estimator_type) != GlobalPositionEstimatorType.LEAST_UNSQUARED_DEVIATION:
        raise NotImplementedError(
            f"position estimator type {int(estimator_type)} is not ported yet "
            "(ROADMAP item D1)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "position estimation over a device mesh is not ported yet (ROADMAP item G1)"
        )
    device = default_device(device)
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, _, rel_pos, _ = view_graph.edge_arrays(dtype)
    ei = np.asarray([index[v] for v in v1], np.int64)
    ej = np.asarray([index[v] for v in v2], np.int64)
    orient = np.zeros((V, 3), dtype)
    for v, aa in orientations.items():
        if v in index:
            orient[index[v]] = aa

    free = np.ones(V, bool)
    if fixed_views:
        for v in fixed_views:
            if v in index:
                free[index[v]] = False
    else:
        free[0] = False

    def t(a):
        return torch.as_tensor(a, device=device)

    ei_d, ej_d = t(ei), t(ej)
    t_world = relative_translations_to_world(t(orient), ei_d, t(rel_pos))
    out = least_unsquared_deviation_positions(
        ei_d, ej_d, t_world, t(free), V
    ).cpu().numpy()
    return {v: out[index[v]] for v in view_ids}
