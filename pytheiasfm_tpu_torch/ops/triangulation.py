"""Two-view triangulation and the cheirality test.

Counterpart of the JAX package's `ops/triangulation.py`
(`theia/sfm/triangulation/triangulation.{h,cc}`). The functions that two-view
verification uses are ported: optimal two-view triangulation (epipolar
correction + DLT) and the cheirality test. The N-view methods port with the
structure slice.
"""

from __future__ import annotations

import torch

from . import rotation as rot

__all__ = [
    "essential_matrix_from_two_projection_matrices",
    "find_optimal_image_points",
    "triangulate",
    "triangulate_dlt",
    "is_triangulated_point_in_front_of_cameras",
]


# cuSOLVER's batched symmetric eigensolver, as torch 2.11 with CUDA 12.8
# calls it on an H100, refuses batches of 32768 or more 4x4 matrices
# (CUSOLVER_STATUS_INVALID_VALUE); batches of 16384 take about 0.5 ms.
_EIGH_BATCH = 16384


def _eigh(a):
    """`torch.linalg.eigh` over any batch, in chunks that cuSOLVER takes.
    Returns (eigenvalues, eigenvectors)."""
    batch = a.shape[:-2]
    flat = a.reshape(-1, *a.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in torch.split(flat, _EIGH_BATCH)]
    vals = torch.cat([v for v, _ in parts]).reshape(*batch, -1)
    vecs = torch.cat([v for _, v in parts]).reshape(*batch, *a.shape[-2:])
    return vals, vecs


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def essential_matrix_from_two_projection_matrices(pose1, pose2):
    """E such that x1^T E x2 = 0 for calibrated projections [..,3,4].

    Parity: `theia::EssentialMatrixFromTwoProjectionMatrices`
    (`sfm/pose/util.cc`). E = [t]_x R with R = R1 R2^T, t = t1 - R t2.
    """
    R1, t1 = pose1[..., :3], pose1[..., 3]
    R2, t2 = pose2[..., :3], pose2[..., 3]
    R = R1 @ R2.mT
    t = t1 - (R @ t2[..., None])[..., 0]
    return rot.hat(t) @ R


def _mv(M, v):
    """M [.., m, n] times v [.., n], broadcast over the leading axes. Written
    as a sum of columns: over one small matrix per point, elementwise
    kernels beat cuBLAS's batched products of 3x3 matrices many times."""
    return sum(M[..., :, j] * v[..., j : j + 1] for j in range(M.shape[-1]))


def _bilinear(x, M, y):
    """x^T M y over the last axes."""
    return torch.sum(x * _mv(M, y), dim=-1)


def find_optimal_image_points(ematrix, point1, point2):
    """First-order optimal epipolar correction of a correspondence.

    Parity: `FindOptimalImagePoints` (`triangulation.cc:66-105`, the
    Lindstrom 'niter1' update): returns corrected (point1, point2) with
    x1'^T E x2' ~= 0, minimally displaced from the inputs.
    """
    p1 = _homogeneous(point1)
    p2 = _homogeneous(point2)
    E2 = ematrix[..., :2, :2]

    line1 = _mv(ematrix[..., :2, :], p2)
    line2 = _mv(ematrix.mT[..., :2, :], p1)

    a = _bilinear(line1, E2, line2)
    b = 0.5 * (torch.sum(line1 * line1, dim=-1) + torch.sum(line2 * line2, dim=-1))
    c = _bilinear(p1, ematrix, p2)
    d = torch.sqrt(torch.clamp(b * b - a * c, min=0.0))
    lam = c / (b + d)

    line1_new = line1 - lam[..., None] * _mv(E2, line1)
    line2_new = line2 - lam[..., None] * _mv(E2.mT, line2)
    lam = lam * (2.0 * d) / (
        torch.sum(line1_new * line1_new, dim=-1) + torch.sum(line2_new * line2_new, dim=-1)
    )

    zero = torch.zeros_like(lam)[..., None]
    c1 = p1 - torch.cat([lam[..., None] * line1_new, zero], dim=-1)
    c2 = p2 - torch.cat([lam[..., None] * line2_new, zero], dim=-1)
    return c1[..., :2] / c1[..., 2:3], c2[..., :2] / c2[..., 2:3]


def triangulate_dlt(pose1, pose2, point1, point2):
    """Two-view DLT: nullspace of the 4x4 design matrix.

    Parity: `theia::TriangulateDLT` (`triangulation.cc:160`). Poses
    [.., 3, 4] broadcast against points [.., 2]. Returns a homogeneous
    [.., 4] point of unit norm; its sign is arbitrary, as the JAX package's
    (`eigh` of D^T D).
    """
    rows = [
        point1[..., 0:1] * pose1[..., 2, :] - pose1[..., 0, :],
        point1[..., 1:2] * pose1[..., 2, :] - pose1[..., 1, :],
        point2[..., 0:1] * pose2[..., 2, :] - pose2[..., 0, :],
        point2[..., 1:2] * pose2[..., 2, :] - pose2[..., 1, :],
    ]
    # Smallest right singular vector via eigh of D^T D (4x4, batched), with
    # D^T D summed over the design's rows as outer products.
    dtd = sum(r[..., :, None] * r[..., None, :] for r in rows)
    _, vecs = _eigh(dtd)
    return vecs[..., :, 0]


def triangulate(pose1, pose2, point1, point2):
    """Optimal two-view triangulation: epipolar correction then DLT.

    Parity: `theia::Triangulate` (`triangulation.cc:109-125`).
    """
    E = essential_matrix_from_two_projection_matrices(pose1, pose2)
    c1, c2 = find_optimal_image_points(E, point1, point2)
    return triangulate_dlt(pose1, pose2, c1, c2)


def is_triangulated_point_in_front_of_cameras(point1, point2, rotation, position):
    """Cheirality test without explicit triangulation.

    Parity: `theia::IsTriangulatedPointInFrontOfCameras`
    (`triangulation.cc:219-236`): point1/point2 are normalized image points
    [.., 2], rotation [.., 3, 3] and position [.., 3] the relative pose
    (camera 2 w.r.t. camera 1).
    """
    dir1 = _homogeneous(point1)
    # dir2 = R^T x2, written as sum_j x2_j R[j, :] so that a block of
    # hypotheses broadcasts against all points without expanding R per point.
    x2 = _homogeneous(point2)
    dir2 = sum(x2[..., j : j + 1] * rotation[..., j, :] for j in range(3))
    dir1_sq = torch.sum(dir1 * dir1, dim=-1)
    dir2_sq = torch.sum(dir2 * dir2, dim=-1)
    dir1_dir2 = torch.sum(dir1 * dir2, dim=-1)
    dir1_pos = torch.sum(dir1 * position, dim=-1)
    dir2_pos = torch.sum(dir2 * position, dim=-1)
    return (dir2_sq * dir1_pos - dir1_dir2 * dir2_pos > 0) & (
        dir1_dir2 * dir1_pos - dir1_sq * dir2_pos > 0
    )
