"""Epipolar geometry: 7/8-point F, essential-matrix utilities, the Sampson
error, focal-length recovery.

Counterpart of the JAX package's `ops/epipolar.py`
(`theia/sfm/pose/{eight,seven}_point_fundamental_matrix.{h,cc}`,
`essential_matrix_utils.{h,cc}`, `fundamental_matrix_util.{h,cc}`,
`sfm/pose/util.cc`): the closed-form essential-matrix decomposition (ported
as written, not replaced by an SVD), the cheirality pose choice, the squared
Sampson distance, the Hartley normalization, the four-point homography, the
normalized 7/8-point fundamental matrix and Bougnoux's focal lengths.

Nullspaces come from the JAX package's solvers (`eigh` of A^T A, the SVD of
a 3x3 F), chunked where cuSOLVER's batched solvers refuse large batches
(`ops/triangulation._eigh`, `_svd`); an eigenvector's sign and a
two-dimensional nullspace's basis are the solver's own.

Convention: ``x2^T * F * x1 = 0`` — `points1` live in image 1, `points2` in
image 2.
"""

from __future__ import annotations

import torch

from . import polynomial as poly
from . import triangulation as tri
from .rotation import hat

__all__ = [
    "normalize_image_points",
    "eight_point_fundamental_matrix",
    "seven_point_fundamental_matrix",
    "four_point_homography",
    "project_to_essential",
    "decompose_essential_matrix",
    "get_best_pose_from_essential_matrix",
    "squared_sampson_distance",
    "fundamental_matrix_from_projection_matrices",
    "focal_lengths_from_fundamental_matrix",
    "shared_focal_lengths_from_fundamental_matrix",
    "essential_matrix_from_fundamental_matrix",
    "compose_fundamental_matrix",
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


def _epipolar_design_matrix(points1, points2):
    """Rows outer(x2_homog, x1_homog).flatten() so that row @ vec(F) = 0
    encodes x2^T F x1 = 0 with F flattened row-major."""
    p1 = _homog(points1)
    p2 = _homog(points2)
    return (p2[..., :, None] * p1[..., None, :]).reshape(points1.shape[:-1] + (9,))


def _least_right_singular_vector(F):
    """The right singular vector of F [.., 3, 3] for its least singular
    value: the right nullvector of a rank-2 F."""
    return tri._svd(F)[2][..., -1, :]


def eight_point_fundamental_matrix(points1, points2, mask=None):
    """Normalized 8-point algorithm; N >= 8 (masked least squares).

    points1/points2 [.., N, 2] -> (F [.., 3, 3], success). Parity:
    `theia::NormalizedEightPointFundamentalMatrix`
    (`eight_point_fundamental_matrix.h:58`): Hartley normalization, the
    nullspace as the least eigenvector of A^T A, the rank-2 projection
    U diag(s1, s2, 0) V^T, denormalization, unit Frobenius norm.
    """
    n1, T1 = normalize_image_points(points1, mask)
    n2, T2 = normalize_image_points(points2, mask)
    A = _epipolar_design_matrix(n1, n2)  # [.., N, 9]
    if mask is not None:
        A = A * mask[..., None].to(A.dtype)
    _, vecs = tri._eigh(A.mT @ A)
    F = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 3))
    U, sv, Vh = tri._svd(F)
    sv = sv * torch.tensor([1.0, 1.0, 0.0], dtype=sv.dtype, device=sv.device)
    F = (U * sv[..., None, :]) @ Vh
    # Denormalize: x2^T F x1 with normalized coords -> T2^T F T1.
    F = T2.mT @ F @ T1
    norm = torch.linalg.norm(F.flatten(-2), dim=-1)
    ok = norm > 1e-12
    return F / torch.clamp(norm, min=1e-12)[..., None, None], ok


def seven_point_fundamental_matrix(points1, points2):
    """7-point algorithm: 1 or 3 F candidates from the 2D nullspace.

    points1/points2 [.., 7, 2] -> (F [.., 3, 3, 3], valid [.., 3]).
    Parity: `theia::SevenPointFundamentalMatrix`
    (`seven_point_fundamental_matrix.h:52`). det(a F1 + (1-a) F2) = 0 is a
    cubic in a, interpolated from its values at a = 0, 1, -1, 2 and solved
    in closed form. F1, F2 span the nullspace; its basis is the solver's,
    so the candidates equal the JAX package's as a set, not in order.
    """
    A = _epipolar_design_matrix(points1, points2)  # [.., 7, 9]
    _, vecs = tri._eigh(A.mT @ A)
    shape = A.shape[:-2] + (3, 3)
    F1 = vecs[..., :, 0].reshape(shape)
    F2 = vecs[..., :, 1].reshape(shape)
    d0, d1, dm1, d2 = (tri._det3(n * F1 + (1.0 - n) * F2) for n in (0.0, 1.0, -1.0, 2.0))
    # c3 a^3 + c2 a^2 + c1 a + c0 through the four nodes.
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - c0
    odd = 0.5 * (d1 - dm1)  # c3 + c1
    c3 = (d2 - 4.0 * c2 - c0 - 2.0 * odd) / 6.0
    c1 = odd - c3
    roots, valid = poly.solve_cubic(c3, c2, c1, c0)
    # A cubic that degenerates to a quadratic (c3 ~ 0) is masked out.
    biggest = torch.amax(torch.abs(torch.stack([c3, c2, c1, c0], -1)), dim=-1)
    valid = valid & ~(torch.abs(c3) < 1e-12 * biggest)[..., None]
    a = roots[..., :, None, None]
    F = a * F1[..., None, :, :] + (1.0 - a) * F2[..., None, :, :]
    norm = torch.linalg.norm(F.flatten(-2), dim=-1)
    return F / torch.clamp(norm, min=1e-12)[..., None, None], valid


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


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold (singular values (1, 1, 0))."""
    U, _, Vh = tri._svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vh


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


def fundamental_matrix_from_projection_matrices(P1, P2):
    """F from two general projection matrices [.., 3, 4].

    Parity: `theia::FundamentalMatrixFromProjectionMatrices`
    (`fundamental_matrix_util.h`): F = [e2]_x P2 P1^+, e2 the image of
    camera 1's center (the nullvector of P1).
    """
    c1 = torch.linalg.svd(P1, full_matrices=True)[2][..., -1, :]
    e2 = (P2 @ c1[..., None])[..., 0]
    return hat(e2) @ (P2 @ torch.linalg.pinv(P1))


def compose_fundamental_matrix(f1, f2, R, t):
    """F = K2^-T [t]_x R K1^-1 with diagonal K = diag(f, f, 1).

    Parity: `theia::ComposeFundamentalMatrix` (`fundamental_matrix_util.h`).
    """
    E = hat(t) @ R
    k1 = torch.stack([1.0 / f1, 1.0 / f1, torch.ones_like(f1)], dim=-1)
    k2 = torch.stack([1.0 / f2, 1.0 / f2, torch.ones_like(f2)], dim=-1)
    return k2[..., :, None] * E * k1[..., None, :]


def essential_matrix_from_fundamental_matrix(F, f1, f2):
    """E = K2^T F K1 with K = diag(f, f, 1).

    Parity: `theia::EssentialMatrixFromFundamentalMatrix`
    (`fundamental_matrix_util.h`).
    """
    k1 = torch.stack([f1, f1, torch.ones_like(f1)], dim=-1)
    k2 = torch.stack([f2, f2, torch.ones_like(f2)], dim=-1)
    return k2[..., :, None] * F * k1[..., None, :]


def _bougnoux_f_sq(F, e):
    """Bougnoux's squared focal length of the image F maps lines into, with
    e the nullvector of F (F e = 0) and the principal points at the origin:
    p = (0, 0, 1), II = diag(1, 1, 0),
        f^2 = -(p^T [e]x II F^T p)(p^T F p) / (p^T [e]x II F^T II F p).
    Invariant to the scale and sign of e."""
    ep = hat(e)
    Ft = F.mT
    # left = p^T [e]x II F^T: the third row of [e]x, its third entry dropped.
    left = ep[..., 2, 0:1] * Ft[..., 0, :] + ep[..., 2, 1:2] * Ft[..., 1, :]
    num = -left[..., 2] * F[..., 2, 2]
    den = left[..., 0] * F[..., 0, 2] + left[..., 1] * F[..., 1, 2]
    return num / torch.where(torch.abs(den) < 1e-30, torch.ones_like(den), den)


def focal_lengths_from_fundamental_matrix(F):
    """Recover the two focal lengths from F (Bougnoux's closed form).

    Parity: `theia::FocalLengthsFromFundamentalMatrix`
    (`fundamental_matrix_util.h`). Assumes principal points at the origin.
    Returns (f1, f2, valid). With x2^T F x1 = 0, F maps image-1 points to
    image-2 lines: F with its right nullvector gives image 2's focal, F^T
    with F's left nullvector image 1's.
    """
    e1 = _least_right_singular_vector(F)
    e2 = _least_right_singular_vector(F.mT)
    f2_sq = _bougnoux_f_sq(F, e1)
    f1_sq = _bougnoux_f_sq(F.mT, e2)
    valid = (f1_sq > 0) & (f2_sq > 0)
    f1 = torch.sqrt(torch.clamp(f1_sq, min=0.0))
    f2 = torch.sqrt(torch.clamp(f2_sq, min=0.0))
    return f1, f2, valid


def shared_focal_lengths_from_fundamental_matrix(F):
    """One focal length shared by both views: the geometric mean of the
    Bougnoux pair. Parity: the JAX package's
    `shared_focal_lengths_from_fundamental_matrix`."""
    f1, f2, valid = focal_lengths_from_fundamental_matrix(F)
    return torch.sqrt(torch.clamp(f1 * f2, min=1e-12)), valid
