"""Essential-matrix utilities and the Sampson error.

Counterpart of the JAX package's `ops/epipolar.py`
(`theia/sfm/pose/essential_matrix_utils.{h,cc}`, `sfm/pose/util.cc`). Two-view
verification needs the calibrated path: the closed-form essential-matrix
decomposition (ported as written, not replaced by an SVD), the cheirality
pose choice, the squared Sampson distance, and for the homography count the
Hartley normalization and the four-point homography. The 7/8-point and
focal recovery functions port with the uncalibrated path.

Convention: ``x2^T * F * x1 = 0`` — `points1` live in image 1, `points2` in
image 2.
"""

from __future__ import annotations

import torch

from . import triangulation as tri

__all__ = [
    "normalize_image_points",
    "four_point_homography",
    "decompose_essential_matrix",
    "get_best_pose_from_essential_matrix",
    "squared_sampson_distance",
]


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def normalize_image_points(points: torch.Tensor, mask: torch.Tensor | None = None):
    """Hartley isotropic normalization: zero mean, mean distance sqrt(2).

    points [.., N, 2] -> (normalized points, T [..,3,3]) with x' = T x.
    Parity: `NormalizeImagePoints` (`sfm/pose/util.cc`).
    """
    if mask is None:
        mean = torch.mean(points, dim=-2, keepdim=True)
        centered = points - mean
        rms = torch.mean(torch.linalg.norm(centered, dim=-1), dim=-1)
    else:
        w = mask.to(points.dtype)[..., None]
        count = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
        mean = torch.sum(points * w, dim=-2, keepdim=True) / count
        centered = (points - mean) * w
        rms = torch.sum(torch.linalg.norm(centered, dim=-1), dim=-1) / count[..., 0, 0]
    scale = (2.0**0.5) / torch.clamp(rms, min=1e-12)
    normalized = centered * scale[..., None, None]
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, zeros, -scale * mean[..., 0, 0]], dim=-1),
            torch.stack([zeros, scale, -scale * mean[..., 0, 1]], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return normalized, T


def four_point_homography(points1, points2, mask=None):
    """Normalized DLT homography from >= 4 correspondences.

    points1/points2 [.., N, 2] -> (H [.., 3, 3], success) with x2 ~ H x1,
    scaled to h33 = 1. Parity: `theia::FourPointHomography`
    (`four_point_homography.h:48`).
    """
    n1, T1 = normalize_image_points(points1, mask)
    n2, T2 = normalize_image_points(points2, mask)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    # Two rows per correspondence (standard DLT).
    row1 = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], dim=-1)
    row2 = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([row1, row2], dim=-2)
    if mask is not None:
        A = A * torch.cat([mask, mask], dim=-1)[..., None].to(A.dtype)
    AtA = A.mT @ A
    _, vecs = torch.linalg.eigh(AtA)
    H = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    H = torch.linalg.inv(T2) @ H @ T1
    scale = H[..., 2, 2]
    ok = torch.abs(scale) > 1e-12
    H = H / torch.where(ok, scale, torch.ones_like(scale))[..., None, None]
    return H, ok


def decompose_essential_matrix(E: torch.Tensor):
    """E [.., 3, 3] -> (R1, R2, t): the four pose candidates are
    (R1, +-t), (R2, +-t). Parity: `theia::DecomposeEssentialMatrix`
    (`essential_matrix_utils.h:52`).

    Closed form (Horn 1990): with E = [b]x R, bb^T = (tr(EE^T)/2) I - EE^T
    gives the baseline up to sign and R = (cof(E) -+ [b]x E)/(b.b) the two
    rotations, followed by one Newton orthogonalization step.
    """
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    EEt = E @ E.mT
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    bbT = (tr / 2)[..., None, None] * eye - EEt
    diag = torch.stack([bbT[..., 0, 0], bbT[..., 1, 1], bbT[..., 2, 2]], -1)
    j = torch.argmax(diag, dim=-1)
    col = torch.gather(bbT, -1, j[..., None, None].expand(j.shape + (3, 1)))[..., 0]
    denom = torch.gather(diag, -1, j[..., None])[..., 0]
    b = col / torch.sqrt(torch.clamp(denom, min=1e-30))[..., None]
    bb = torch.clamp(torch.sum(b * b, dim=-1), min=1e-30)

    # cof(E) via cross products of columns: adj rows are c1xc2, c2xc0,
    # c0xc1; cof = adj^T.
    c0, c1, c2 = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    adj = torch.stack(
        [
            torch.linalg.cross(c1, c2, dim=-1),
            torch.linalg.cross(c2, c0, dim=-1),
            torch.linalg.cross(c0, c1, dim=-1),
        ],
        dim=-2,
    )
    cofE = adj.mT

    zeros = torch.zeros_like(b[..., 0])
    Bx = torch.stack(
        [
            torch.stack([zeros, -b[..., 2], b[..., 1]], -1),
            torch.stack([b[..., 2], zeros, -b[..., 0]], -1),
            torch.stack([-b[..., 1], b[..., 0], zeros], -1),
        ],
        dim=-2,
    )
    BE = Bx @ E
    R1 = (cofE - BE) / bb[..., None, None]
    R2 = (cofE + BE) / bb[..., None, None]

    def _orth(R):
        # One Newton step toward the orthogonal polar factor:
        # R <- R (3I - R^T R)/2; exact rotations are fixed points.
        return R @ (1.5 * eye - 0.5 * (R.mT @ R))

    R1 = _orth(R1)
    R2 = _orth(R2)
    t = b / torch.sqrt(torch.clamp(tr / 2, min=1e-30))[..., None]
    return R1, R2, t


def get_best_pose_from_essential_matrix(E, points1, points2, mask=None):
    """Choose the pose (R, position) with maximal cheirality support.

    Parity: `theia::GetBestPoseFromEssentialMatrix`
    (`essential_matrix_utils.h:67`). Returns (R [..,3,3], position [..,3],
    count [..]); `position` is the camera-2 center in camera-1 coordinates
    (position = -R^T t). Ties go to the first candidate, as `jnp.argmax`
    gives them.
    """
    R1, R2, t = decompose_essential_matrix(E)
    candidates_R = [R1, R1, R2, R2]
    candidates_t = [t, -t, t, -t]
    counts = []
    for R, tc in zip(candidates_R, candidates_t):
        pos = -(R.mT @ tc[..., None])[..., 0]
        in_front = tri.is_triangulated_point_in_front_of_cameras(
            points1, points2, R[..., None, :, :], pos[..., None, :]
        )
        if mask is not None:
            in_front = in_front & mask
        counts.append(torch.sum(in_front, dim=-1))
    counts = torch.stack(counts, dim=-1)  # [.., 4]
    best = torch.argmax(counts, dim=-1)
    R_all = torch.stack(candidates_R, dim=-3)  # [.., 4, 3, 3]
    t_all = torch.stack(candidates_t, dim=-2)  # [.., 4, 3]
    R_best = torch.gather(
        R_all, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3))
    )[..., 0, :, :]
    t_best = torch.gather(t_all, -2, best[..., None, None].expand(best.shape + (1, 3)))[
        ..., 0, :
    ]
    pos_best = -(R_best.mT @ t_best[..., None])[..., 0]
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]
    return R_best, pos_best, best_count


def squared_sampson_distance(F, points1, points2):
    """Squared Sampson distance of correspondences under x2^T F x1 = 0.

    F [.., 3, 3] against points [.., N, 2] (F broadcasts over N). Parity:
    `theia::SquaredSampsonDistance` (`sfm/pose/util.cc`). The products are
    written as broadcast sums over the 3x3 entries so that a block of
    hypotheses [.., H, 3, 3] scores against points [.., 1, N, 2] without
    expanding either operand.
    """
    x1 = _homog(points1)
    x2 = _homog(points2)
    Fr = F[..., None, :, :]  # broadcast over N
    Fx1 = sum(x1[..., j : j + 1] * Fr[..., :, j] for j in range(3))  # F x1
    Ftx2 = sum(x2[..., j : j + 1] * Fr[..., j, :] for j in range(3))  # F^T x2
    num = torch.sum(x2 * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num * num / torch.clamp(denom, min=1e-30)
