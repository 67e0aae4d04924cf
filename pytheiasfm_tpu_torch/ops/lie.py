"""SE(3) and Sim(3) as batched pure functions.

Counterpart of the JAX package's `ops/lie.py` (the reference binds
`Sophus::SE3d` / `Sophus::Sim3d`, `pytheia/math/math.cc:92,150`, and uses
them for pose-graph Sim3 optimization).

Conventions: SE3 elements are (R [.., 3, 3], t [.., 3]); tangents are
xi = (rho[3], phi[3]) with exp(xi) = (exp(phi), V(phi) rho). Sim3 elements
are (s [..], R [.., 3, 3], t [.., 3]); tangents are (rho[3], phi[3],
sigma), sigma the log-scale. Near the identity each coefficient switches
to its Taylor series, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import rotation as rot

__all__ = [
    "se3_exp",
    "se3_log",
    "se3_inverse",
    "se3_multiply",
    "se3_action",
    "sim3_exp",
    "sim3_log",
    "sim3_inverse",
    "sim3_multiply",
    "sim3_action",
]

_EPS = 1e-8


def _one_where(cond, x):
    return torch.where(cond, torch.ones_like(x), x)


def _v_coeffs(phi):
    """Coefficients (a1, a2) of V = I + a1 W + a2 W^2 of the SE3 exp."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < _EPS
    theta = torch.sqrt(_one_where(small, theta_sq))
    a1 = torch.where(small, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(theta)) / _one_where(small, theta_sq))
    a2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                     (theta - torch.sin(theta)) / _one_where(small, theta_sq * theta))
    return a1, a2


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _left_jacobian(phi):
    """V(phi): the left Jacobian of SO(3)."""
    W = rot.hat(phi)
    a1, a2 = _v_coeffs(phi)
    return _eye_like(W) + a1[..., None, None] * W + a2[..., None, None] * (W @ W)


def _left_jacobian_inverse(phi):
    """V(phi)^-1 in closed form."""
    W = rot.hat(phi)
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < _EPS
    theta = torch.sqrt(_one_where(small, theta_sq))
    half = 0.5 * theta
    # (1 - theta/2 cot(theta/2)) / theta^2, Taylor 1/12 + theta^2/720.
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / _one_where(small, theta_sq))
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def se3_exp(xi: torch.Tensor):
    """Tangent [.., 6] (rho, phi) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return rot.angle_axis_to_rotation_matrix(phi), _mv(_left_jacobian(phi), rho)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> tangent [.., 6] (rho, phi)."""
    phi = rot.rotation_matrix_to_angle_axis(R)
    return torch.cat([_mv(_left_jacobian_inverse(phi), t), phi], dim=-1)


def se3_inverse(R, t):
    Rt = R.mT
    return Rt, -_mv(Rt, t)


def se3_multiply(R1, t1, R2, t2):
    return R1 @ R2, _mv(R1, t2) + t1


def se3_action(R, t, p):
    return _mv(R, p) + t


# Sim(3): exp through W = c0 I + c1 Omega + c2 Omega^2 with
# c_k = int_0^1 e^{sigma u} {1, sin(theta u) / theta, (1 - cos(theta u)) / theta^2} du.


def _sim3_w_coeffs(theta_sq, sigma):
    theta_small = theta_sq < _EPS
    sigma_small = torch.abs(sigma) < _EPS
    theta = torch.sqrt(_one_where(theta_small, theta_sq))
    s = torch.exp(sigma)
    safe_sigma = _one_where(sigma_small, sigma)
    denom = sigma * sigma + theta_sq
    safe_denom = _one_where(denom < _EPS, denom)

    # c0 = (e^sigma - 1) / sigma.
    c0 = torch.where(sigma_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sigma)

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    # c1: (s (sigma sin - theta cos) + theta) / (theta (sigma^2 + theta^2)).
    c1_general = (s * (sigma * sin_t - theta * cos_t) + theta) / (
        _one_where(theta_small, theta) * safe_denom)
    # theta -> 0: (s (sigma - 1) + 1) / sigma^2.
    c1_theta0 = torch.where(sigma_small, 0.5 + sigma / 3.0,
                            (s * (sigma - 1.0) + 1.0) / _one_where(sigma_small, sigma * sigma))
    # sigma -> 0: (1 - cos theta) / theta^2.
    c1_sigma0 = torch.where(theta_small, 0.5 - theta_sq / 24.0,
                            (1.0 - cos_t) / _one_where(theta_small, theta_sq))
    c1 = torch.where(theta_small, c1_theta0, torch.where(sigma_small, c1_sigma0, c1_general))

    # c2: (c0 - (s (sigma cos + theta sin) - sigma) / (sigma^2 + theta^2)) / theta^2.
    c2_general = (c0 - (s * (sigma * cos_t + theta * sin_t) - sigma) / safe_denom) / (
        _one_where(theta_small, theta_sq))
    # theta -> 0: (s (sigma^2 - 2 sigma + 2) - 2) / (2 sigma^3).
    c2_theta0 = torch.where(
        sigma_small, 1.0 / 6.0 + sigma / 8.0,
        (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0) / _one_where(sigma_small, 2.0 * sigma**3))
    # sigma -> 0: (theta - sin theta) / theta^3.
    c2_sigma0 = torch.where(theta_small, 1.0 / 6.0 - theta_sq / 120.0,
                            (theta - sin_t) / _one_where(theta_small, theta_sq * theta))
    c2 = torch.where(theta_small, c2_theta0, torch.where(sigma_small, c2_sigma0, c2_general))
    return c0, c1, c2


def _sim3_w(phi, sigma):
    W = rot.hat(phi)
    c0, c1, c2 = _sim3_w_coeffs(torch.sum(phi * phi, dim=-1), sigma)
    return (_eye_like(W) * c0[..., None, None] + c1[..., None, None] * W
            + c2[..., None, None] * (W @ W))


def sim3_exp(xi: torch.Tensor):
    """Tangent [.., 7] (rho, phi, sigma) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return (torch.exp(sigma), rot.angle_axis_to_rotation_matrix(phi),
            _mv(_sim3_w(phi, sigma), rho))


def sim3_log(s, R, t):
    """(s, R, t) -> tangent [.., 7]; W inverted by a 3x3 solve."""
    phi = rot.rotation_matrix_to_angle_axis(R)
    sigma = torch.log(torch.as_tensor(s, dtype=R.dtype, device=R.device))
    rho = torch.linalg.solve(_sim3_w(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(s, R, t):
    Rt = R.mT
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * _mv(Rt, t)


def sim3_multiply(s1, R1, t1, s2, R2, t2):
    return s1 * s2, R1 @ R2, s1[..., None] * _mv(R1, t2) + t1


def sim3_action(s, R, t, p):
    return s[..., None] * _mv(R, p) + t
