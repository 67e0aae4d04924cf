"""Position averaging from pairwise translation directions.

Counterpart of the JAX package's `global_pose/position_estimator.py`
(`theia/sfm/global_pose_estimation/`): LUD
(`least_unsquared_deviation_position_estimator.h:58`, Ozyesil & Singer
CVPR'15, a convex ‖·‖₂-deviation objective with scale variables s_ij ≥ 1),
NONLINEAR (`nonlinear_position_estimator.h:61`, robust LM over unit
directions), LINEAR_TRIPLET (`linear_position_estimator.cc:195`, the
smallest eigenvector by shifted power iteration), LiGT
(`LiGT_position_estimator.h:53`, from track observations) and BATA
(`bata_position_estimator.h:56`, bilinear angle-based averaging). Every
solver runs a fixed number of steps with operator-form CG (gather /
segment-sum matvecs) on the device.

Edge data: for edge (i, j) the view graph stores `position_2`, the unit
position of camera j in camera i's frame; the world-frame direction is
t_ij = R_iᵀ · position_2 with c_j − c_i ≈ s_ij t_ij, s_ij > 0.

`estimate_positions` dispatches as the JAX package's: LIGT falls through to
LUD there (`ligt_positions` is reached only by calling it; ROADMAP section
3), and so it does here. On a device mesh LUD shards the edge axis (the
other types ignore the mesh, as in the JAX package). LINEAR_TRIPLET and
LiGT start from a random draw, which the JAX
package takes from `jax.random`: here it comes from a `torch.Generator` with
a fixed seed, or from the caller (`start`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import default_device
from ..math.l1 import conjugate_gradient, seeded_normal
from ..ops import rotation as rotops
from ..ops.segment import segment_sum
from ..parallel.sharding import local_shard, mesh_axis

__all__ = [
    "GlobalPositionEstimatorType",
    "relative_translations_to_world",
    "least_unsquared_deviation_positions",
    "nonlinear_positions",
    "linear_triplet_positions",
    "ligt_positions",
    "bata_positions",
    "estimate_positions",
]

# The seed of the random starts (the JAX package: `PRNGKey(0)`).
_START_SEED = 0


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


def _deflate(c):
    """Remove the mean row of [V, 3] (the global translation)."""
    return c - torch.mean(c, dim=0, keepdim=True)


def least_unsquared_deviation_positions(
    edge_i, edge_j, t_world, free_mask, num_views: int,
    outer_iters: int = 200, cg_iters: int = 30, rho: float = 1.0,
    edge_mask=None, mesh=None,
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

    `mesh`: the edge arrays are this rank's block of the edges (padded ones
    with t_world = 0, i = j and `edge_mask` False: exact zero rows). A x,
    z1 and u1 are the rank's edges'; x, z2 and u2 stay whole on every rank,
    so that CG's inner products need no collective: Aᵀ's sums into views
    and the rank's scale entries (zeros elsewhere) travel in one
    `all_reduce` a product.
    """
    comm = mesh_axis(mesh)
    E = edge_i.shape[0]
    lo, hi, E_all = 0, E, E  # this rank's edges among all of them
    if comm is not None:
        E_all = E * comm.size
        lo, hi = comm.block(E_all)
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
    if comm is not None:
        deg = comm.sum(deg)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 1.0)

    def apply_A(x):
        dc = x[:nC].reshape(num_views, 3) * fm
        ds = x[nC + lo:nC + hi]
        return dc[edge_j] - dc[edge_i] - ds[:, None] * t_world

    def apply_At(re):
        gc = segment_sum(re, edge_j, num_views) - segment_sum(re, edge_i, num_views)
        gs = -torch.sum(re * t_world, dim=-1)
        if comm is not None:
            out = torch.zeros((nC + E_all,), dtype=dtype, device=device)
            out[:nC] = gc.reshape(-1)
            out[nC + lo:nC + hi] = gs
            out = comm.sum(out)
            gc, gs = out[:nC].reshape(num_views, 3), out[nC:]
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
        torch.ones((E_all,), dtype=dtype, device=device),
    ])
    z1 = torch.zeros((E, 3), dtype=dtype, device=device)
    u1 = torch.zeros((E, 3), dtype=dtype, device=device)
    z2 = torch.ones((E_all,), dtype=dtype, device=device)
    u2 = torch.zeros((E_all,), dtype=dtype, device=device)
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


def nonlinear_positions(
    positions, edge_i, edge_j, t_world, edge_weights, free_mask,
    num_views: int, num_iterations: int = 50, cg_iters: int = 30,
    huber_delta: float = 0.1,
):
    """Robust Levenberg-Marquardt over unit-direction errors.

    Parity: `NonlinearPositionEstimator` (`nonlinear_position_estimator.h:61`,
    `pairwise_translation_error.h`): residual w·((c_j − c_i)/‖c_j − c_i‖ −
    t̂_ij) with Huber weights fixed at the start of each step; λ halves on a
    step taken and grows 4x on one refused, decided on the device. The JAX
    package applies J and Jᵀ by `jax.jvp` / `jax.vjp` of the residual in
    every CG step; here each LM step takes the residual's per-edge 3x3
    Jacobian blocks (with respect to c_j − c_i) from three forward-mode
    passes, as the port's bundle adjustment takes its Jacobians, and J·v
    and Jᵀ·u are block products with gathers and segment sums: the same
    linear maps.
    """
    dtype, device = positions.dtype, positions.device
    fm = free_mask.to(dtype)[:, None]
    w_edge = edge_weights.to(dtype)[:, None]

    def unit(d):
        return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)

    def residuals(c):
        return (unit(c[edge_j] - c[edge_i]) - t_world) * w_edge

    c = positions
    lam = torch.tensor(1e-3, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    for _ in range(num_iterations):
        r = residuals(c)
        nrm = torch.linalg.norm(r, dim=-1)
        # Huber IRLS weight: 1 inside delta, delta/|r| outside.
        w = torch.where(nrm <= huber_delta, 1.0, huber_delta / torch.clamp(nrm, min=1e-12))
        scale = torch.sqrt(w)[:, None] * w_edge
        r0 = r * torch.sqrt(w)[:, None]
        d = c[edge_j] - c[edge_i]
        with fwAD.dual_level():
            B = torch.stack([
                fwAD.unpack_dual(unit(fwAD.make_dual(d, eye[k].expand_as(d)))).tangent
                for k in range(3)
            ], dim=-1) * scale[..., None]  # [E, 3, 3]: d r_e / d (c_j - c_i)

        def apply_J(v, B=B):
            vv = v.reshape(num_views, 3) * fm
            return (B @ (vv[edge_j] - vv[edge_i])[..., None])[..., 0]

        def apply_Jt(u, B=B):
            g = (B.mT @ u[..., None])[..., 0]
            return ((segment_sum(g, edge_j, num_views) - segment_sum(g, edge_i, num_views))
                    * fm).reshape(-1)

        dx = conjugate_gradient(lambda v, lam=lam: apply_Jt(apply_J(v)) + lam * v,
                                -apply_Jt(r0), iters=cg_iters)
        c_new = c + dx.reshape(num_views, 3) * fm
        r_new = residuals(c_new) * torch.sqrt(w)[:, None]
        ok = torch.sum(r_new * r_new) < torch.sum(r0 * r0)
        c = torch.where(ok, c_new, c)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return c


def linear_triplet_positions(
    edge_i, edge_j, t_world, edge_weights, num_views: int,
    power_iterations: int = 200, start=None,
):
    """Linear position estimation: smallest eigenvector of the direction
    cross-constraint quadratic Σ w ‖(I − t tᵀ)(c_j − c_i)‖².

    Parity target: `LinearPositionEstimator`
    (`linear_position_estimator.cc:195-207`), as the JAX package's:
    deflation removes the global translation, shifted power iteration
    (λ_max I − L) finds the smallest mode. `start`: the random start
    [V, 3] (None: a normal draw of a generator seeded `_START_SEED`).
    """
    dtype, device = t_world.dtype, t_world.device
    w = edge_weights.to(dtype)
    P = (
        torch.eye(3, dtype=dtype, device=device)[None] - t_world[:, :, None] * t_world[:, None, :]
    ) * w[:, None, None]
    deg = 2.0 * (segment_sum(w, edge_i, num_views) + segment_sum(w, edge_j, num_views))
    lam = torch.max(deg) + 1.0

    def apply_L(c):
        Pd = (P @ (c[edge_j] - c[edge_i])[..., None])[..., 0]
        return segment_sum(Pd, edge_j, num_views) - segment_sum(Pd, edge_i, num_views)

    if start is None:
        start = seeded_normal((num_views, 3), dtype, device, _START_SEED)
    c = _deflate(start)
    c = c / torch.linalg.norm(c)
    for _ in range(power_iterations):
        y = _deflate(lam * c - apply_L(c))
        c = y / torch.clamp(torch.linalg.norm(y), min=1e-12)

    # Resolve the sign so most edges have positive scale along t.
    s = torch.sum((c[edge_j] - c[edge_i]) * t_world, dim=-1)
    return c * torch.where(torch.sum(torch.sign(s)) >= 0, 1.0, -1.0)


def ligt_positions(
    obs_view, obs_track, bearings, orientations, num_views: int,
    num_tracks: int, power_iterations: int = 200, start=None,
):
    """LiGT: linear global translation from track constraints.

    Parity: `theia::LiGTPositionEstimator` (`LiGT_position_estimator.h:53`,
    Cai et al., TPAMI 2021), as the JAX package's derivation: for a track
    with base observation (b, v_b) and another observation (j, v_j),
    eliminating the depth with a = [v_j]× R_j R_bᵀ v_b gives three equations
    linear in the camera centres, [a]× B_j (c_b − c_j) = 0 with
    B_j = [v_j]× R_j. The smallest eigenvector of the assembled quadratic
    comes from 8 inverse-iteration steps, each `power_iterations` CG steps.

    Args:
      obs_view [O], obs_track [O] (int64); bearings [O, 3] unit camera-
      frame bearings; orientations [V, 3] world→camera angle-axis; `start`:
      the random start [V, 3] (None: a normal draw of a generator seeded
      `_START_SEED`).

    Returns:
      positions [V, 3] (zero-mean, unit-norm gauge, majority-positive depth).
    """
    dtype, device = bearings.dtype, bearings.device
    R = rotops.angle_axis_to_rotation_matrix(orientations)
    O = obs_view.shape[0]
    obs_idx = torch.arange(O, device=device)
    # Base observation per track: the first occurrence (a segment min over
    # the observation index; a track without one reads the last).
    base_obs = torch.full((num_tracks,), O - 1, dtype=obs_idx.dtype, device=device)
    base_obs = base_obs.scatter_reduce(0, obs_track, obs_idx, "amin", include_self=False)
    b_view = obs_view[base_obs][obs_track]  # [O]
    v_b = bearings[base_obs][obs_track]  # [O, 3]
    ray_b = (R[b_view].mT @ v_b[..., None])[..., 0]  # R_bᵀ v_b, the world ray

    B_j = rotops.hat(bearings) @ R[obs_view]  # [O, 3, 3]
    a = (B_j @ ray_b[..., None])[..., 0]  # [O, 3]
    M = rotops.hat(a) @ B_j  # M (c_b − c_j) = 0
    is_base = obs_idx == base_obs[obs_track]
    # Scale-balance each constraint (|a| ~ the triangulation angle) and mask.
    wnorm = torch.linalg.norm(a, dim=-1, keepdim=True)
    M = torch.where(is_base[:, None, None], 0.0, M / torch.clamp(wnorm[..., None], min=1e-12))
    MtM = M.mT @ M  # [O, 3, 3]

    def apply_L(c):
        Md = (MtM @ (c[b_view] - c[obs_view])[..., None])[..., 0]
        return segment_sum(Md, b_view, num_views) - segment_sum(Md, obs_view, num_views)

    tr = MtM.diagonal(dim1=-2, dim2=-1).sum(-1)
    deg = segment_sum(tr, obs_view, num_views) + segment_sum(tr, b_view, num_views)

    # Inverse iteration: each step solves (L + eps I) y = c with CG, which
    # amplifies the near-null mode by about 1/eps.
    eps = 1e-8 * torch.clamp(torch.mean(deg), min=1e-12)

    def matvec(x):
        xv = _deflate(x.reshape(num_views, 3))
        return (apply_L(xv) + eps * xv).reshape(-1)

    if start is None:
        start = seeded_normal((num_views, 3), dtype, device, _START_SEED)
    c = _deflate(start)
    c = c / torch.linalg.norm(c)
    for _ in range(8):
        y = conjugate_gradient(matvec, c.reshape(-1), x0=c.reshape(-1), iters=power_iterations)
        y = _deflate(y.reshape(num_views, 3))
        c = y / torch.clamp(torch.linalg.norm(y), min=1e-30)

    # Sign: the majority of depths d = −aᵀw/|a|² must be positive.
    w_vec = (B_j @ (c[b_view] - c[obs_view])[..., None])[..., 0]
    d_est = -torch.sum(a * w_vec, -1) / torch.clamp(torch.sum(a * a, -1), min=1e-20)
    d_est = torch.where(is_base, 0.0, d_est)
    return c * torch.where(torch.sum(torch.sign(d_est)) >= 0, 1.0, -1.0)


def bata_positions(
    edge_i, edge_j, t_world, free_mask, num_views: int,
    outer_iters: int = 100, cg_iters: int = 40, alpha_eps: float = 1e-3,
):
    """BATA: bilinear angle-based translation averaging (revised LUD).

    Parity: `theia::RevisedLeastUnsquaredDeviationPositionEstimator`
    (`bata_position_estimator.h:56`, Zhuang et al. CVPR 2018), as the JAX
    package's: a LUD start, then `outer_iters` rounds that re-estimate the
    per-edge scale α_ij = max(t̂ᵀd, ε)/‖d‖², reweight by a Cauchy-like
    weight of the angular residual, solve the weighted Laplacian system
    with `cg_iters` CG steps and keep the step only if the angular
    objective falls.

    Returns positions [V, 3] (zero-mean gauge, mean edge length 1).
    """
    fm = free_mask.to(t_world.dtype)[:, None]

    def scales(d):
        return torch.clamp(torch.sum(t_world * d, -1), min=alpha_eps) / torch.clamp(
            torch.sum(d * d, -1), min=alpha_eps**2
        )

    # Warm start from LUD: the bilinear alternation has spurious fixed
    # points when started far away.
    c = _deflate(least_unsquared_deviation_positions(edge_i, edge_j, t_world, free_mask, num_views))
    dn0 = torch.linalg.norm(c[edge_j] - c[edge_i], dim=-1)
    c = c / torch.clamp(torch.mean(dn0), min=1e-12)

    for _ in range(outer_iters):
        d = c[edge_j] - c[edge_i]
        # The optimal per-edge scale given c (Zhuang et al. eq. 6), the
        # projection, clamped positive.
        alpha = scales(d)
        r = alpha[:, None] * d - t_world
        w = 1.0 / (1.0 + torch.sum(r * r, -1) / 0.25)
        wa2 = w * alpha * alpha
        reg = 1e-6 * torch.mean(wa2)

        def matvec(x, wa2=wa2, reg=reg):
            # Deflate + a tiny Tikhonov term: the Laplacian is singular on
            # the translations.
            xv = _deflate(x.reshape(num_views, 3)) * fm
            dd = (xv[edge_j] - xv[edge_i]) * wa2[:, None]
            g = segment_sum(dd, edge_j, num_views) - segment_sum(dd, edge_i, num_views)
            return (_deflate(g * fm) + reg * xv).reshape(-1)

        rhs_e = t_world * (w * alpha)[:, None]
        rhs = segment_sum(rhs_e, edge_j, num_views) - segment_sum(rhs_e, edge_i, num_views)
        rhs = _deflate(rhs * fm).reshape(-1)
        x = conjugate_gradient(matvec, rhs, x0=c.reshape(-1), iters=cg_iters)
        # Mean-zero gauge only: the α projection makes the cost scale
        # invariant.
        c_new = _deflate(x.reshape(num_views, 3))

        # Monotone guard on the (scale-invariant) angular objective.
        def ang_obj(cc, w=w):
            dd = cc[edge_j] - cc[edge_i]
            rr = scales(dd)[:, None] * dd - t_world
            return torch.sum(w * torch.sum(rr * rr, -1))

        c = torch.where(ang_obj(c_new) < ang_obj(c), c_new, c)
    # Final gauge: mean edge length 1 (the reference's convention).
    dn = torch.linalg.norm(c[edge_j] - c[edge_i], dim=-1)
    return c / torch.clamp(torch.mean(dn), min=1e-12)


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
    (`global_reconstruction_estimator.cc:418-452`), with the JAX package's
    branches: NONLINEAR starts from LUD with √(weights) as edge weights,
    LINEAR_TRIPLET takes the weights, BATA its own LUD start; every other
    type (LIGT included) runs LUD. `device`: where the solve runs (None:
    the CUDA card).

    `mesh` (LUD only, as in the JAX package; every rank calls with the same
    graph and orientations): the edges are padded to a multiple of the mesh
    size with t_world = 0, i = j = 0 and a False mask, each rank solves with
    its block of them, and every rank returns rank 0's positions.
    """
    device = default_device(device)
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, _, rel_pos, weights = view_graph.edge_arrays(dtype)
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

    ei_d, ej_d, free_d = t(ei), t(ej), t(free)
    t_world = relative_translations_to_world(t(orient), ei_d, t(rel_pos))
    kind = int(estimator_type)
    if kind == GlobalPositionEstimatorType.NONLINEAR:
        # The reference starts from a random draw
        # (`nonlinear_position_estimator.h:97`); the JAX package from LUD.
        init = least_unsquared_deviation_positions(ei_d, ej_d, t_world, free_d, V)
        out = nonlinear_positions(init, ei_d, ej_d, t_world, t(np.sqrt(weights)), free_d, V)
    elif kind == GlobalPositionEstimatorType.LINEAR_TRIPLET:
        out = linear_triplet_positions(ei_d, ej_d, t_world, t(weights), V)
    elif kind == GlobalPositionEstimatorType.BATA:
        out = bata_positions(ei_d, ej_d, t_world, free_d, V)
    elif mesh is None:
        out = least_unsquared_deviation_positions(ei_d, ej_d, t_world, free_d, V)
    else:
        comm = mesh_axis(mesh)
        mask = t(np.ones(len(ei), bool))
        shard = [local_shard(a, comm) for a in (ei_d, ej_d, t_world, mask)]
        out = comm.broadcast(least_unsquared_deviation_positions(
            shard[0], shard[1], shard[2], free_d, V, edge_mask=shard[3], mesh=comm))
    out = out.cpu().numpy()
    return {v: out[index[v]] for v in view_ids}
