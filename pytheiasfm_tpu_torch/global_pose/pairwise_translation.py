"""Batched relative-translation refinement with known rotations.

Counterpart of the JAX package's `global_pose/pairwise_translation.py`
(`theia/sfm/bundle_adjustment/optimize_relative_position_with_known_
rotation.{h,cc}`). All view-graph edges refine at once: one `[E, K]` padded
correspondence table, IRLS with a fixed iteration count, the smallest
eigenvector of each edge's 3x3 weighted constraint Gram matrix, and a
cheirality majority vote for the sign.
"""

from __future__ import annotations

import torch

from ..ops import rotation as rotops
from ..ops import triangulation as tri

__all__ = ["optimize_relative_positions_with_known_rotations"]


def optimize_relative_positions_with_known_rotations(
    rot1,  # [E, 3] angle-axis of view 1 (world->camera)
    rot2,  # [E, 3] angle-axis of view 2
    x1,  # [E, K, 2] normalized features in view 1
    x2,  # [E, K, 2] normalized features in view 2
    mask,  # [E, K] valid correspondence slots
    init_position,  # [E, 3] current relative position estimates
    iters: int = 20,
):
    """Returns ([E, 3] refined unit relative positions, [E] success)."""
    dtype = x1.dtype
    kMinWeight = 1e-7
    R1 = rotops.angle_axis_to_rotation_matrix(rot1)
    R2 = rotops.angle_axis_to_rotation_matrix(rot2)
    h1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    rf1 = h1 @ R1  # R1^T x1 per row
    rf2 = h2 @ R2
    # Constraint vectors c_k = R1 (rf2 x rf1)
    # (CreateConstraintMatrix, optimize_relative_position_...cc:23-43).
    c = torch.linalg.cross(rf2, rf1, dim=-1) @ R1.mT  # [E, K, 3]
    c = c * mask[..., None].to(dtype)

    w = torch.where(mask, 1.0, kMinWeight).to(dtype)
    t = init_position
    for _ in range(iters):
        w = torch.clamp(w, min=kMinWeight)
        lhs = (c * (1.0 / w)[..., None]).mT @ c
        # Null vector of the weighted Gram matrix: the eigenvector of the
        # smallest eigenvalue (eigh returns ascending order). The batch is
        # split where cuSOLVER refuses it (`ops/triangulation._eigh`).
        _, vecs = tri._eigh(lhs)
        t = vecs[..., :, 0]
        w = torch.abs((c @ t[..., None])[..., 0])
        w = torch.where(mask, w, kMinWeight)

    # Sign: majority of correspondences in front of both cameras
    # (MajorityOfPointsInFrontOfCameras).
    R_rel = R2 @ R1.mT
    in_front = tri.is_triangulated_point_in_front_of_cameras(
        x1, x2, R_rel[:, None], t[:, None]
    )
    votes = torch.sum(in_front & mask, dim=-1)
    count = torch.sum(mask, dim=-1)
    n = torch.clamp(count, min=1)
    t = torch.where((votes > n // 2)[:, None], t, -t)
    ok = count >= 5
    # Keep the original estimate for under-constrained edges.
    t0 = init_position / torch.clamp(
        torch.linalg.norm(init_position, dim=-1, keepdim=True), min=1e-12
    )
    t = torch.where(ok[:, None], t, t0)
    return t, ok
