"""Minimal solvers with known camera rotation, batched over leading axes.

Counterpart of the JAX package's `ops/known_rotation.py`
(`theia/sfm/pose/position_from_two_rays.{h,cc}`, the 2-point absolute
position, and `relative_pose_from_two_points_with_known_rotation.{h,cc}`,
the 2-point relative position). Features arrive pre-rotated into the
world-aligned frame (`R^T [u, v, 1]`, dehomogenized), as the reference
expects; each solver is a tiny dense linear solve, written over any number
of leading axes as the port's P3P is.
"""

from __future__ import annotations

import torch

from .triangulation import _chunked, _eigh

__all__ = ["position_from_two_rays", "relative_pose_from_two_points_with_known_rotation"]


def position_from_two_rays(rotated_feature1, point1, rotated_feature2, point2):
    """Camera position from two 2D-3D correspondences with known rotation.

    Parity: `theia::PositionFromTwoRays` (`position_from_two_rays.h`):
    solve the 4x3 system  [I2 | -f_i] c = p_i.xy - f_i p_i.z  in least
    squares. rotated_feature1/2 [.., 2], point1/2 [.., 3]. Returns
    (position [.., 3], valid [..]).
    """
    dtype, device = point1.dtype, point1.device
    batch = point1.shape[:-1]
    eye2 = torch.eye(2, dtype=dtype, device=device).expand(batch + (2, 2))
    lhs = torch.cat([
        torch.cat([eye2, -rotated_feature1[..., :, None]], dim=-1),
        torch.cat([eye2, -rotated_feature2[..., :, None]], dim=-1),
    ], dim=-2)  # [.., 4, 3]
    rhs = torch.cat([
        point1[..., :2] - rotated_feature1 * point1[..., 2:3],
        point2[..., :2] - rotated_feature2 * point2[..., 2:3],
    ], dim=-1)  # [.., 4]
    AtA = lhs.mT @ lhs
    Atb = (lhs.mT @ rhs[..., None])[..., 0]
    # Rank-3 check via the conditioning of the normal matrix.
    eigs = _eigh(AtA)[0]
    valid = eigs[..., 0] > 1e-10 * torch.clamp(eigs[..., -1], min=1e-12)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    position = torch.linalg.solve(AtA + 1e-12 * eye3, Atb[..., None])[..., 0]
    return position, valid


def relative_pose_from_two_points_with_known_rotation(rotated_features1, rotated_features2):
    """Unit relative position from 2 correspondences with known rotations.

    Parity: `theia::RelativePoseFromTwoPointsWithKnownRotation`
    (`relative_pose_from_two_points_with_known_rotation.h`): the epipolar
    constraint on rotated (world-aligned) features is linear in t; the
    solution is the null vector of the stacked 2x3 system (its sign is the
    SVD's, so only +-t is determined). rotated_features1/2 [.., 2, 2].
    Returns (position [.., 3], valid [..]).
    """
    p, q = rotated_features1, rotated_features2
    A = torch.stack([
        -p[..., 1] + q[..., 1],
        -q[..., 0] + p[..., 0],
        p[..., 1] * q[..., 0] - p[..., 0] * q[..., 1],
    ], dim=-1)  # [.., 2, 3]
    _, s, vh = _chunked(lambda c: torch.linalg.svd(c, full_matrices=True), A)
    t = vh[..., -1, :]
    # A 1-D kernel needs the two singular values non-degenerate.
    valid = s[..., 1] > 1e-10 * torch.clamp(s[..., 0], min=1e-12)
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12), valid
