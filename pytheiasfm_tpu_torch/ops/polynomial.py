"""Batched polynomial utilities and real-root finding.

Counterpart of the JAX package's `ops/polynomial.py` (the reference's
`math/closed_form_polynomial_solver.h` and
`find_polynomial_roots_companion_matrix.{h,cc}`). The root finder is ported
as written there: a homogeneous sign sweep over a tan-parameterized grid
covering the whole real line, bisection on each sign change, then Newton
polish. It is not swapped for a companion-matrix `eig`: the count and order
of the roots it returns fill the five-point solver's solution slots.

Coefficient convention: numpy order, ``coeffs[..., 0]`` multiplies the
highest power.
"""

from __future__ import annotations

import torch

__all__ = [
    "polyval",
    "polyder_coeffs",
    "solve_quadratic",
    "solve_cubic",
    "solve_quartic",
    "find_real_polynomial_roots",
]


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation. coeffs [.., D+1] broadcast against x [..]."""
    result = coeffs[..., 0] + torch.zeros_like(x)
    for i in range(1, coeffs.shape[-1]):
        result = result * x + coeffs[..., i]
    return result


def polyder_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients of the derivative polynomial; [.., D+1] -> [.., D]."""
    degree = coeffs.shape[-1] - 1
    powers = torch.arange(degree, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs[..., :-1] * powers


def _ones_where(cond, x):
    return torch.where(cond, torch.ones_like(x), x)


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c -> (roots [.., 2], valid [.., 2]).
    Parity: `theia::SolveQuadraticReals`; stable "citardauq" pairing."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    disc = b * b - 4.0 * a * c
    has_roots = disc >= 0
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sqrt_disc)
    q = torch.where(b == 0, -0.5 * (b + sqrt_disc), q)
    safe_a = _ones_where(a == 0, a)
    safe_q = _ones_where(q == 0, q)
    r1 = torch.where(a == 0, -c / _ones_where(b == 0, b), q / safe_a)
    r2 = torch.where(q == 0, torch.zeros_like(q), c / safe_q)
    linear = a == 0
    valid1 = torch.where(linear, b != 0, has_roots)
    valid2 = torch.where(linear, torch.zeros_like(has_roots), has_roots)
    return torch.stack([r1, r2], dim=-1), torch.stack([valid1, valid2], dim=-1)


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (a nonzero) -> (roots [.., 3],
    valid [.., 3]). Trigonometric (Viete) / Cardano, branchless. Parity:
    `theia::SolveCubicReals`."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    inv_a = 1.0 / a
    p = b * inv_a
    q = c * inv_a
    r = d * inv_a
    A = q - p * p / 3.0
    B = (2.0 * p * p * p - 9.0 * p * q + 27.0 * r) / 27.0
    shift = -p / 3.0

    disc = 0.25 * B * B + A * A * A / 27.0
    three_real = disc <= 0

    mA = torch.clamp(A, max=-1e-30)
    m = 2.0 * torch.sqrt(-mA / 3.0)
    acos_arg = torch.clamp(3.0 * B / (mA * m), -1.0, 1.0)
    phi = torch.arccos(acos_arg) / 3.0
    two_pi_3 = 2.0943951023931953
    t0 = m * torch.cos(phi)
    t1 = m * torch.cos(phi - two_pi_3)
    t2 = m * torch.cos(phi - 2.0 * two_pi_3)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-0.5 * B + sq)
    v = _cbrt(-0.5 * B - sq)
    t_single = u + v

    r0 = torch.where(three_real, t0, t_single) + shift
    r1_ = torch.where(three_real, t1, t_single) + shift
    r2_ = torch.where(three_real, t2, t_single) + shift
    roots = torch.stack([r0, r1_, r2_], dim=-1)
    valid = torch.stack([torch.ones_like(three_real), three_real, three_real], dim=-1)
    return roots, valid


def _cbrt(x):
    """Real cube root (torch has no `cbrt`)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_quartic(a, b, c, d, e, newton_iters: int = 2):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e -> (roots [.., 4],
    valid [.., 4]). Ferrari resolvent cubic + Newton polish. Parity:
    `theia::SolveQuarticReals`."""
    a, b, c, d, e = torch.broadcast_tensors(a, b, c, d, e)
    inv_a = 1.0 / a
    b_, c_, d_, e_ = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    b2 = b_ * b_
    p = c_ - 3.0 * b2 / 8.0
    q = d_ - 0.5 * b_ * c_ + b2 * b_ / 8.0
    r = e_ - 0.25 * b_ * d_ + b2 * c_ / 16.0 - 3.0 * b2 * b2 / 256.0
    shift = -0.25 * b_

    zroots, zvalid = solve_cubic(torch.ones_like(p), 2.0 * p, p * p - 4.0 * r, -q * q)
    z = torch.max(torch.where(zvalid, zroots, -torch.inf), dim=-1).values
    z = torch.clamp(z, min=0.0)
    s = torch.sqrt(z)

    small_s = s < 1e-12
    safe_s = _ones_where(small_s, s)
    half_q = torch.where(small_s, torch.zeros_like(q), 0.5 * q / safe_s)
    t1 = 0.5 * (p + z) - half_q
    t2 = 0.5 * (p + z) + half_q
    biq, biq_valid = solve_quadratic(torch.ones_like(p), p, r)
    y_sq0 = biq[..., 0]
    y_sq1 = biq[..., 1]

    ra, va = solve_quadratic(torch.ones_like(s), s, t1)
    rb, vb = solve_quadratic(torch.ones_like(s), -s, t2)

    sq0 = torch.sqrt(torch.clamp(y_sq0, min=0.0))
    sq1 = torch.sqrt(torch.clamp(y_sq1, min=0.0))
    biq_roots = torch.stack([sq0, -sq0, sq1, -sq1], dim=-1)
    v0 = biq_valid[..., 0] & (y_sq0 >= 0)
    v1 = biq_valid[..., 1] & (y_sq1 >= 0)
    biq_mask = torch.stack([v0, v0, v1, v1], dim=-1)

    fact_roots = torch.cat([ra, rb], dim=-1)
    fact_mask = torch.cat([va, vb], dim=-1)

    y = torch.where(small_s[..., None], biq_roots, fact_roots)
    valid = torch.where(small_s[..., None], biq_mask, fact_mask)
    roots = y + shift[..., None]

    coeffs = torch.stack([a, b, c, d, e], dim=-1)
    dcoeffs = polyder_coeffs(coeffs)
    for _ in range(newton_iters):
        f = polyval(coeffs[..., None, :], roots)
        df = polyval(dcoeffs[..., None, :], roots)
        flat = torch.abs(df) < 1e-30
        step = f / _ones_where(flat, df)
        roots = torch.where(flat, roots, roots - step)
    return roots, valid


def _homogeneous_sign_eval(coeffs, s, c):
    """sum_i coeffs_i * s^(D-i) * c^i — the sign of p(s/c) without overflow
    (c = cos(theta) > 0 on (-pi/2, pi/2))."""
    result = coeffs[..., 0] + torch.zeros_like(s)
    for i in range(1, coeffs.shape[-1]):
        result = result * s + coeffs[..., i] * c**i
    return result


def _sign_nonzero(x):
    """sign(x) with exact zeros counted as positive."""
    s = torch.sign(x)
    return torch.where(s == 0, torch.ones_like(s), s)


def find_real_polynomial_roots(
    coeffs: torch.Tensor,
    grid_size: int = 256,
    bisect_iters: int = 48,
    newton_iters: int = 3,
):
    """All real roots of an arbitrary-degree polynomial, batched and
    branchless. Parity: `theia::FindPolynomialRoots*` restricted to real
    roots.

      1. theta-grid over (-pi/2, pi/2); z = tan(theta) covers all reals.
      2. Homogeneous sign evaluation at the grid nodes (no overflow).
      3. Sign changes mark root brackets; the first D of them are kept.
      4. `bisect_iters` bisection steps in theta per bracket.
      5. `newton_iters` guarded Newton steps on p(z).

    Returns (roots [.., D], valid [.., D]) — fixed-size root slots.
    """
    degree = coeffs.shape[-1] - 1
    batch_shape = coeffs.shape[:-1]
    dtype, device = coeffs.dtype, coeffs.device

    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    coeffs = coeffs / _ones_where(scale == 0, scale)

    half_pi = torch.tensor(1.5707963267948966, dtype=dtype, device=device)
    # |z|_max = cot(margin * pi/2) ~ 6.4e8. The grid is made in f64 and then
    # cast, as the JAX package makes it under x64.
    margin = 1e-9
    theta = (
        torch.linspace(
            -1.0 + margin, 1.0 - margin, grid_size, dtype=torch.float64, device=device
        ).to(dtype)
        * half_pi
    )
    s = torch.sin(theta)
    c = torch.cos(theta)

    vals = _homogeneous_sign_eval(coeffs[..., None, :], s, c)  # [.., G]
    signs = _sign_nonzero(vals)
    change = signs[..., :-1] * signs[..., 1:] < 0  # [.., G-1]

    num_cells = grid_size - 1
    cell_idx = torch.arange(num_cells, device=device)
    keyed = torch.where(change, cell_idx, num_cells)
    order = torch.sort(keyed, dim=-1).values[..., :degree]  # [.., D]
    valid = order < num_cells
    safe_idx = torch.where(valid, order, 0)

    lo = theta[safe_idx]
    hi = theta[torch.where(valid, safe_idx + 1, 0)]
    sign_lo = torch.gather(signs.expand(batch_shape + (grid_size,)), -1, safe_idx)

    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        val_mid = _homogeneous_sign_eval(
            coeffs[..., None, :], torch.sin(mid), torch.cos(mid)
        )
        go_left = _sign_nonzero(val_mid) * sign_lo < 0
        lo, hi = torch.where(go_left, lo, mid), torch.where(go_left, mid, hi)
    roots = torch.tan(0.5 * (lo + hi))

    dcoeffs = polyder_coeffs(coeffs)
    for _ in range(newton_iters):
        f = polyval(coeffs[..., None, :], roots)
        df = polyval(dcoeffs[..., None, :], roots)
        step = f / _ones_where(torch.abs(df) < 1e-30, df)
        new_roots = roots - step
        improved = torch.abs(polyval(coeffs[..., None, :], new_roots)) <= torch.abs(f)
        roots = torch.where(improved, new_roots, roots)

    roots = torch.where(valid, roots, torch.zeros_like(roots))
    return roots, valid
