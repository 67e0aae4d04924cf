"""Batched P3P: absolute pose from three 2D-3D correspondences.

Counterpart of the JAX package's `ops/p3p.py` (`theia::PoseFromThreePoints`,
`perspective_three_point.h:56`): Grunert's distance formulation, reduced to
one quartic in closed form (the JAX package's sympy-derived coefficients),
a 2-D Newton polish of the distance ratios, and a rigid alignment of the
three camera-frame points to the world points.

  feature_points [.., 3, 2]  calibrated (normalized) image points
  world_points   [.., 3, 3]  corresponding 3D points
  -> rotations [.., 4, 3, 3], translations [.., 4, 3], valid [.., 4]
with p_cam = R @ p_world + t (up to four solutions, masked).
"""

from __future__ import annotations

import torch

from . import polynomial as poly
from .triangulation import _det3, _svd

__all__ = ["pose_from_three_points", "align_point_triads"]


def align_point_triads(world_pts, cam_pts):
    """Rigid alignment q = R p + t for small point sets (Horn / Umeyama, no
    scale). world_pts/cam_pts [.., N, 3] -> (R [..,3,3], t [..,3])."""
    p_mean = torch.mean(world_pts, dim=-2, keepdim=True)
    q_mean = torch.mean(cam_pts, dim=-2, keepdim=True)
    H = (cam_pts - q_mean).mT @ (world_pts - p_mean)
    U, _, Vh = _svd(H)
    det = _det3(U @ Vh)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = (U * D[..., None, :]) @ Vh
    t = q_mean[..., 0, :] - (R @ p_mean[..., 0, :, None])[..., 0]
    return R, t


def pose_from_three_points(feature_points: torch.Tensor, world_points: torch.Tensor):
    """Solve P3P for a batch of minimal samples.

    Grunert's system in the distances s_i = |P_i - C|: with u = s2/s1 and
    v = s3/s1 the two ratio equations eliminate to a quartic in v; u
    follows linearly, the distances by back-substitution, the pose by
    three-point rigid alignment. Parity: `PoseFromThreePoints`
    (`perspective_three_point.h:56`); up to 4 masked solutions, invalid
    ones set to (I, 0).
    """
    dtype = feature_points.dtype
    bearings = torch.cat([feature_points, torch.ones_like(feature_points[..., :1])], dim=-1)
    bearings = bearings / torch.linalg.norm(bearings, dim=-1, keepdim=True)
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = world_points[..., 0, :], world_points[..., 1, :], world_points[..., 2, :]

    # Squared side lengths and bearing cosines; the scene scale is
    # normalized so the quartic's coefficients stay O(1) in f32.
    A = torch.sum((P2 - P3) ** 2, dim=-1)  # a^2, opposite P1
    B = torch.sum((P1 - P3) ** 2, dim=-1)  # b^2
    C = torch.sum((P1 - P2) ** 2, dim=-1)  # c^2
    scale_sq = (A + B + C) / 3.0
    safe_scale = torch.clamp(scale_sq, min=1e-20)
    A = A / safe_scale
    B = B / safe_scale
    C = C / safe_scale
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    # Quartic in v = s3/s1 (the JAX package's coefficients; common factor
    # B^2 dropped).
    a4 = A**2 - 2 * A * B - 2 * A * C + B**2 - 4 * B * C * ca**2 + 2 * B * C + C**2
    a3 = 4 * (
        -(A**2) * cb
        + A * B * ca * cg
        + A * B * cb
        + 2 * A * C * cb
        - B**2 * ca * cg
        + 2 * B * C * ca**2 * cb
        + B * C * ca * cg
        - B * C * cb
        - C**2 * cb
    )
    a2 = 2 * (
        2 * A**2 * cb**2
        + A**2
        - 4 * A * B * ca * cb * cg
        - 2 * A * B * cg**2
        - 4 * A * C * cb**2
        - 2 * A * C
        + 2 * B**2 * ca**2
        + 2 * B**2 * cg**2
        - B**2
        - 2 * B * C * ca**2
        - 4 * B * C * ca * cb * cg
        + 2 * C**2 * cb**2
        + C**2
    )
    a1 = 4 * (
        -(A**2) * cb
        + A * B * ca * cg
        + 2 * A * B * cb * cg**2
        - A * B * cb
        + 2 * A * C * cb
        - B**2 * ca * cg
        + B * C * ca * cg
        + B * C * cb
        - C**2 * cb
    )
    a0 = A**2 - 4 * A * B * cg**2 + 2 * A * B - 2 * A * C + B**2 - 2 * B * C + C**2

    v, v_valid = poly.solve_quartic(a4, a3, a2, a1, a0, newton_iters=3)

    # u from the difference of the two ratio equations (linear in u).
    Ab, Bb, Cb = A[..., None], B[..., None], C[..., None]
    cab, cbb, cgb = ca[..., None], cb[..., None], cg[..., None]
    denom = 2.0 * Bb * (cgb - cab * v)
    numer = (Ab - Bb - Cb) * v * v - 2.0 * (Ab - Cb) * cbb * v + (Ab + Bb - Cb)
    safe = torch.abs(denom) > 1e-12
    u = numer / torch.where(safe, denom, torch.ones_like(denom))

    # 2-D Newton polish of (u, v) on Grunert's ratio equations.
    for _ in range(4):
        g1 = Bb * (u * u + v * v - 2.0 * u * v * cab) - Ab * (1.0 + v * v - 2.0 * v * cbb)
        g2 = Bb * (1.0 + u * u - 2.0 * u * cgb) - Cb * (1.0 + v * v - 2.0 * v * cbb)
        d1u = Bb * (2.0 * u - 2.0 * v * cab)
        d1v = Bb * (2.0 * v - 2.0 * u * cab) - Ab * (2.0 * v - 2.0 * cbb)
        d2u = Bb * (2.0 * u - 2.0 * cgb)
        d2v = -Cb * (2.0 * v - 2.0 * cbb)
        det_j = d1u * d2v - d1v * d2u
        ok_j = torch.abs(det_j) > 1e-20
        inv_det = 1.0 / torch.where(ok_j, det_j, torch.ones_like(det_j))
        du = (g1 * d2v - g2 * d1v) * inv_det
        dv = (g2 * d1u - g1 * d2u) * inv_det
        u = torch.where(ok_j, u - du, u)
        v = torch.where(ok_j, v - dv, v)

    # Distances: s1 from the b^2 equation, then s2 = u s1, s3 = v s1, with
    # the scene scale restored.
    s1_sq = Bb * safe_scale[..., None] / torch.clamp(1.0 + v * v - 2.0 * v * cbb, min=1e-12)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=0.0))
    s2 = u * s1
    s3 = v * s1
    valid = v_valid & safe & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points and rigid alignment per candidate.
    cam_pts = torch.stack(
        [s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
         s3[..., None] * f3[..., None, :]],
        dim=-2,
    )  # [.., 4, 3, 3]
    # A candidate with a non-finite point would align to a non-finite pose,
    # which the checks below reject; it is zeroed so that no NaN reaches
    # the SVD.
    finite = torch.all(torch.isfinite(cam_pts).flatten(-2), dim=-1)
    cam_pts = torch.where(finite[..., None, None], cam_pts, torch.zeros_like(cam_pts))
    valid = valid & finite
    world_b = world_points[..., None, :, :].expand(cam_pts.shape)
    R, t = align_point_triads(world_b, cam_pts)

    # The three points must reproject finite and in front.
    depths = (R @ world_b.mT + t[..., :, None])[..., 2, :]
    valid = valid & torch.all(depths > 0, dim=-1) & torch.all(torch.isfinite(t), dim=-1)
    t = torch.where(valid[..., None], t, torch.zeros_like(t))
    eye = torch.eye(3, dtype=dtype, device=R.device).expand(R.shape)
    R = torch.where(valid[..., None, None], R, eye)
    return R, t, valid
