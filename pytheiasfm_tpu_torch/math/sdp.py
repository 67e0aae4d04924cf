"""Block-structured SDP solvers (Burer-Monteiro / Riemannian staircase).

Counterpart of the JAX package's `math/sdp.py` (the reference's
`theia/math/` SDP family: `SDPSolver` and its options, `sdp_solver.h:51`,
`solver_options.h:43`; `RankRestrictedSDPSolver`,
`rank_restricted_sdp_solver.h:63`; `RiemannianStaircase`,
`riemannian_staircase.h:112`).

Problem class: rotation-synchronization SDPs  min tr(C X)  s.t.  X ⪰ 0,
X_ii = I_3. The factorized problem

    min tr(Yᵀ C Y),  Y ∈ (St(r,3))^n   (each 3×r block has orthonormal rows)

is solved by parallel Riemannian projected-gradient steps: the gradient is
one [3n, 3n] × [3n, r] product, the retraction a batched 3×r polar factor,
and a 3-candidate step-size search keeps it monotone. The staircase lifts
the rank with the most negative certificate eigenvector (shifted power
iteration) and decides on the host once a rank level.

Random starts: the JAX package draws the certificate's power-iteration
start from `jax.random`, which the port cannot reproduce. Here it comes
from an explicit `torch.Generator` with a fixed seed, or from the caller
(`v0`), which is how the tests hand in the JAX package's draw.
"""

from __future__ import annotations

import dataclasses

import torch

from .l1 import seeded_normal

__all__ = [
    "SDPSolverOptions",
    "solve_block_sdp",
    "riemannian_staircase",
    "certificate_min_eig",
    "round_block_solution",
]

# The seeds of the default power-iteration starts: the JAX package uses
# `PRNGKey(0)` in `certificate_min_eig` and `PRNGKey(1)` in the staircase.
_CERTIFICATE_SEED = 0
_STAIRCASE_SEED = 1


@dataclasses.dataclass(frozen=True)
class SDPSolverOptions:
    """Parity: `math/solver_options.h:43-99` (the subset that matters here),
    field for field as the JAX package's."""

    max_iterations: int = 200
    tolerance: float = 1e-8
    rank: int = 3
    max_rank: int = 6  # staircase ceiling (`riemannian_staircase.h:112`)
    power_iterations: int = 64


def _polar_rows(B):
    """Project [.., 3, r] onto matrices with orthonormal rows (closest in
    Frobenius norm): U Vᵀ from the thin SVD."""
    U, _, Vt = torch.linalg.svd(B, full_matrices=False)
    return U @ Vt


def _objective(C, Y):
    return torch.sum(Y * (C @ Y))  # tr(Yᵀ C Y)


def solve_block_sdp(C, Y0, num_blocks: int, rank: int, iters: int = 200):
    """Minimize tr(Yᵀ C Y) over block-Stiefel Y [3n, r].

    Parity class: `RankRestrictedSDPSolver::Solve`
    (`rank_restricted_sdp_solver.h:63`), as the JAX package's
    `solve_block_sdp`: parallel Riemannian gradient steps with a polar
    retraction, three step sizes (2, 1, 0.25 × the step) tried each
    iteration, the first best kept if it lowers the objective.

    Args:
      C: [3n, 3n] symmetric cost; Y0: [3n, r] initial block-Stiefel point.

    Returns:
      (Y [3n, r], objective value as a 0-dim tensor).
    """
    n = num_blocks
    # Lipschitz-ish scale for the initial step: row-sum bound of |C|.
    L = torch.clamp(torch.max(torch.sum(torch.abs(C), dim=1)), min=1e-12)
    base_step = 1.0 / L
    lo, hi = base_step * 1e-4, base_step * 1e4
    factors = torch.tensor([2.0, 1.0, 0.25], dtype=C.dtype, device=C.device)

    Y, step = Y0, base_step
    for _ in range(iters):
        G = C @ Y  # Euclidean gradient / 2
        f0 = torch.sum(Y * G)
        # The three candidates as one batch: [3, 3n, r].
        cand = Y[None] - (step * factors)[:, None, None] * G[None]
        Ys = _polar_rows(cand.reshape(3, n, 3, rank)).reshape(3, 3 * n, rank)
        fs = torch.sum(Ys * (C @ Ys), dim=(1, 2))
        # The first best candidate (`jnp.argmin`'s tie rule), selected on
        # the device: no read back.
        best = torch.argmin(fs).reshape(1)
        improved = torch.min(fs) < f0
        Y = torch.where(improved, torch.index_select(Ys, 0, best)[0], Y)
        # The step follows the winner (x2, x1, x0.25), and shrinks by 0.25
        # when no candidate lowers the objective.
        change = torch.where(improved, torch.index_select(factors, 0, best)[0], 0.25)
        step = torch.clamp(step * change, lo, hi)
    return Y, _objective(C, Y)


def certificate_min_eig(C, Y, num_blocks: int, power_iterations: int = 64, v0=None):
    """Smallest eigenvalue (and vector) of the dual certificate
    S = Λ − C, Λ = blockdiag(sym((C Y) Yᵀ)): X = Y Yᵀ is globally optimal
    iff S ⪰ 0 (`riemannian_staircase.h`'s second-order condition).

    Shifted power iteration on (σI − S) from `v0` [3n] (normalized here;
    None: a normal draw of a generator seeded `_CERTIFICATE_SEED`).
    """
    n = num_blocks
    CY = C @ Y
    Lam = CY.reshape(n, 3, -1) @ Y.reshape(n, 3, -1).mT
    Lam = 0.5 * (Lam + Lam.mT)

    def S_mv(v):
        lam_v = (Lam @ v.reshape(n, 3, 1)).reshape(-1)
        return lam_v - C @ v

    # Upper bound for the shift: ||S|| <= max row sum.
    sigma = torch.max(torch.sum(torch.abs(C), dim=1)) + torch.max(
        torch.sum(torch.abs(Lam), dim=(1, 2))
    )
    if v0 is None:
        v0 = seeded_normal(3 * n, C.dtype, C.device, _CERTIFICATE_SEED)
    v = v0 / torch.linalg.norm(v0)
    for _ in range(power_iterations):
        w = sigma * v - S_mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.dot(v, S_mv(v)), v


def riemannian_staircase(
    C,
    num_blocks: int,
    options: SDPSolverOptions = SDPSolverOptions(),
    Y_init=None,
    v0=None,
):
    """Riemannian staircase: solve at increasing rank until certified.

    Parity: `RiemannianStaircase` (`riemannian_staircase.h:112`), as the
    JAX package's: solve at r = rank..max_rank, lifting with the negative
    certificate eigenvector each level; a lift is kept only if it lowers
    the objective, and the climb stops once the certificate is
    nonnegative. Two host reads a rank level. `v0`: the certificate's
    power-iteration start at every level (None: a normal draw of a
    generator seeded `_STAIRCASE_SEED`).

    Returns:
      (Y [3n, max_rank] zero-padded, objective, min_certificate_eig).
    """
    n = num_blocks
    dtype, device = C.dtype, C.device
    if v0 is None:
        v0 = seeded_normal(3 * n, dtype, device, _STAIRCASE_SEED)

    r = options.rank
    if Y_init is None:
        Y = torch.eye(3, dtype=dtype, device=device).repeat(n, 1)
        if r > 3:
            Y = torch.nn.functional.pad(Y, (0, r - 3))
    else:
        Y = Y_init

    Y, obj = solve_block_sdp(C, Y, n, r, options.max_iterations)
    lam, v = certificate_min_eig(C, Y, n, options.power_iterations, v0)

    for r_next in range(r + 1, options.max_rank + 1):
        # Lift: append the escape direction as a new column where the
        # certificate found negative curvature; re-polar to stay feasible.
        lift = torch.cat([Y, 1e-2 * v[:, None]], dim=1)
        lift = _polar_rows(lift.reshape(n, 3, r_next)).reshape(3 * n, r_next)
        Y_next, obj_next = solve_block_sdp(C, lift, n, r_next, options.max_iterations)
        lam_next, v_next = certificate_min_eig(C, Y_next, n, options.power_iterations, v0)
        # Accept the lift only if it actually improved the objective.
        if bool(obj_next < obj - options.tolerance * torch.abs(obj)):
            Y, obj, lam, v = Y_next, obj_next, lam_next, v_next
        else:
            break
        if bool(lam > -options.tolerance):
            break

    pad = options.max_rank - Y.shape[1]
    if pad > 0:
        Y = torch.nn.functional.pad(Y, (0, pad))
    return Y, obj, lam


def round_block_solution(Y, num_blocks: int):
    """Round a rank-r block-Stiefel solution to n rotation matrices.

    Project Y onto its top-3 left singular subspace, then each 3x3 block
    onto SO(3) with a global determinant-sign fix (the SDP solution is
    sign / gauge ambiguous)."""
    n = num_blocks
    U, s, _ = torch.linalg.svd(Y, full_matrices=False)
    blocks = (U[:, :3] * s[:3]).reshape(n, 3, 3)
    # Majority det sign.
    sign = torch.sign(torch.sum(torch.sign(torch.linalg.det(blocks))))
    sign = torch.where(sign == 0, 1.0, sign)
    blocks = blocks * sign
    Ub, _, Vtb = torch.linalg.svd(blocks)
    det_uv = torch.linalg.det(Ub @ Vtb)
    one = torch.ones_like(det_uv)
    D = torch.stack([one, one, det_uv], dim=-1)
    return (Ub * D[:, None, :]) @ Vtb
