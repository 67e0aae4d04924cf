"""Planar uncalibrated orthographic pose (a pyTheia addition).

Counterpart of the JAX package's `ops/orthographic.py`
(`PlanarUncalibratedOrthographicPose`,
`theia/sfm/pose/orthographic_four_point.h:13,20`): the pose and
magnification of an orthographic camera observing a planar scene (z = 0)
from 4 or more correspondences.

Model: pixel = m [r1^T; r2^T] X + t2. For planar X the data give a 2x2
affine A and t2 by linear least squares; m^2 is the larger root of
x^2 - (|a1|^2 + |a2|^2) x + (|a1|^2 |a2|^2 - (a1.a2)^2), and the two signs
of (r13, r23) give the two solutions. Closed form, batched.
"""

from __future__ import annotations

import torch

__all__ = ["planar_uncalibrated_orthographic_pose"]


def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def planar_uncalibrated_orthographic_pose(features, world_points, principal_point=None):
    """Orthographic pose + magnification for a planar scene.

    features [.., N, 2] pixels (N >= 4); world_points [.., N, 3] planar
    (z about 0); principal_point optional [.., 2], subtracted from the
    features. Returns (rotations [.., 2, 3, 3], translations [.., 2, 3],
    magnification [..], valid [.., 2]).
    """
    dtype = features.dtype
    if principal_point is not None:
        features = features - principal_point[..., None, :]
    xy = world_points[..., :2]

    # Linear least squares for [A | t]: pixel = A xy + t.
    D = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)  # [.., N, 3]
    sol = torch.linalg.solve_ex(D.mT @ D, D.mT @ features)[0]  # [.., 3, 2]
    A = sol[..., :2, :].mT  # rows a1, a2
    t2 = sol[..., 2, :]

    a1, a2 = A[..., 0, :], A[..., 1, :]
    n1 = torch.sum(a1 * a1, dim=-1)
    n2 = torch.sum(a2 * a2, dim=-1)
    dot = torch.sum(a1 * a2, dim=-1)
    half_b = 0.5 * (n1 + n2)
    disc = torch.sqrt(torch.clamp(half_b**2 - (n1 * n2 - dot**2), min=0.0))
    m_sq = half_b + disc
    m = torch.sqrt(torch.clamp(m_sq, min=1e-20))

    r13 = torch.sqrt(torch.clamp(1.0 - n1 / m_sq, min=0.0))
    # The sign of r23 from a1.a2 + m^2 r13 r23 = 0.
    sign = -torch.sign(dot)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    r23 = sign * torch.sqrt(torch.clamp(1.0 - n2 / m_sq, min=0.0))

    def build(r13_s, r23_s):
        r1 = torch.cat([a1 / m[..., None], r13_s[..., None]], dim=-1)
        r2 = torch.cat([a2 / m[..., None], r23_s[..., None]], dim=-1)
        # Re-orthonormalize and complete with r3.
        r1n = _normalize(r1)
        r2n = _normalize(r2 - torch.sum(r2 * r1n, dim=-1, keepdim=True) * r1n)
        return torch.stack([r1n, r2n, torch.linalg.cross(r1n, r2n, dim=-1)], dim=-2)

    rotations = torch.stack([build(r13, r23), build(-r13, -r23)], dim=-3)
    # The orthographic z-offset is unobservable: t3 = 0, (x, y) scaled by
    # 1 / m so that m [R | t] reprojects.
    trans = torch.cat([t2 / m[..., None], torch.zeros_like(t2[..., :1])], dim=-1)
    translations = torch.stack([trans, trans], dim=-2)

    # Validity: the residual of the metric-upgrade equations.
    resid = torch.abs(dot + m_sq * r13 * r23) / torch.clamp(m_sq, min=1e-20)
    ok = resid < (1e-3 if dtype == torch.float32 else 1e-8)
    return rotations, translations, m, torch.stack([ok, ok], dim=-1)
