"""Bundle-adjustment types and the per-observation pieces the LM kernels share.

Counterpart of the JAX package's `ba/lm.py` (the reference's Ceres-based
`bundle_adjuster.{h,cc}`, `bundle_adjustment.{h,cc}`). Ported: the options,
summary and enums; the reprojection residual of one observation
(`_residual_at_point`, parity with `theia::ReprojectionError`); the
homogeneous-point tangent bases; and the closed-form small inverses.

The solver of the main path is `ba/iterative_schur.py`. Not ported, each
raising `NotImplementedError` that names its ROADMAP item:
  - the flat implicit-PCG kernel (`bundle_adjust`, `hessian_blocks`), which
    the JAX entry takes for INVERSE_DEPTH tracks and degenerate slot
    layouts: item A5b;
  - view priors (`use_position_priors`, `use_orientation_priors`,
    `use_gravity_priors`; off by default): item A5c.

Parameter blocks: extrinsics [V, 6] ([position, angle-axis]), intrinsics
[G, P] per shared intrinsics group, points [T, 3] (XYZW, dehomogenised) or
[T, 4] (XYZW_MANIFOLD, a unit 4-vector stepped in a 3-D tangent chart).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ..models import intrinsics as intr
from ..models.intrinsics import OptimizeIntrinsicsType
from ..ops import rotation as rotops
from .losses import LossFunctionType

__all__ = [
    "BundleAdjustmentOptions",
    "BundleAdjustmentSummary",
    "TrackParametrizationType",
    "LinearSolverType",
    "OptimizeIntrinsicsType",
    "bundle_adjust",
    "hessian_blocks",
    "inv3x3",
    "inv_small_spd",
]

FLAT_KERNEL_ITEM = "ROADMAP item A5b"
PRIORS_ITEM = "ROADMAP item A5c"


class TrackParametrizationType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:93-95`."""

    XYZW = 0
    XYZW_MANIFOLD = 1
    INVERSE_DEPTH = 2


class LinearSolverType(enum.IntEnum):
    """Camera-system solver selection (parity with the reference's Ceres
    configuration, `reconstruction_estimator_options.h:291-300`): AUTO takes
    the dense Schur at up to `entry.DENSE_SCHUR_MAX_CAMERAS` cameras with
    frozen intrinsics, the iterative Schur otherwise."""

    AUTO = 0
    DENSE_SCHUR = 1
    ITERATIVE_SCHUR = 2


@dataclasses.dataclass(frozen=True)
class BundleAdjustmentOptions:
    """Parity: `theia::BundleAdjustmentOptions` (`bundle_adjustment.h:87-167`),
    every field of the JAX package's options with its default."""

    loss_function_type: LossFunctionType = LossFunctionType.TRIVIAL
    robust_loss_width: float = 2.0
    max_num_iterations: int = 100
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    linear_solver_type: LinearSolverType = LinearSolverType.AUTO
    # bf16 matvec operands in the iterative kernel's PCG (f32 accumulation),
    # parity: `use_mixed_precision_solves` (`bundle_adjustment.h:111`).
    use_mixed_precision_solves: bool = False
    # PCG controls (ITERATIVE_SCHUR + SCHUR_JACOBI); the tolerance is Ceres's
    # forcing tolerance eta = 0.1.
    linear_solver_iterations: int = 40
    linear_solver_tolerance: float = 0.1
    initial_trust_region_radius: float = 1e4
    # LM iterations a device launch in the JAX package (a TPU watchdog
    # limit; its chunks compute what one loop computes). The port runs one
    # loop; the field is kept for parity and has no effect.
    max_iterations_per_launch: int = 25
    optimize_cameras: bool = True
    optimize_points: bool = True
    intrinsics_to_optimize: OptimizeIntrinsicsType = OptimizeIntrinsicsType.NONE
    track_parametrization_type: TrackParametrizationType = TrackParametrizationType.XYZW
    use_position_priors: bool = False
    use_orientation_priors: bool = False
    use_gravity_priors: bool = False
    verbose: bool = False
    # A device mesh in the JAX package. The port runs on one device; a mesh
    # raises in the entry (ROADMAP item G1).
    mesh: object = None


@dataclasses.dataclass
class BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustmentSummary` (`bundle_adjustment.h:170`).
    Plain Python values. `final_mu` is the LM damping at the end;
    `converged` says the function tolerance stopped the loop;
    `num_linear_solver_iterations` (the port's own) counts the PCG steps of
    all LM iterations."""

    success: bool
    initial_cost: float
    final_cost: float
    num_iterations: int
    final_mu: float | None = None
    converged: bool | None = None
    num_linear_solver_iterations: int | None = None


# ---------------------------------------------------------------------------
# Residuals.
# ---------------------------------------------------------------------------


def _pixel_of(params, p_cam, present_models, model_idx):
    """Project camera-frame points through the observations' camera model.
    Only PINHOLE is ported, so a problem holds one model; the JAX package
    selects among several by `model_idx` (`lax.switch`)."""
    if len(present_models) != 1:
        raise NotImplementedError("a problem with several camera models is not ported yet "
                                  "(ROADMAP item A1b)")
    return intr.camera_to_pixel(params, p_cam, present_models[0])


def _residual_at_point(e6, params, p_world, uv, sqrt_info, present_models, model_idx):
    """Weighted reprojection residuals [.., 2] of world points [.., 3].

    Mirrors `theia::ReprojectionError` (`camera/reprojection_error.h:50-115`):
    translate, freeze the residual of a point within 1e-4 of the camera
    centre, rotate, project through the camera model, weight by the sqrt
    information of the feature covariance.
    """
    adjusted = p_world - e6[..., :3]
    too_close = torch.sum(adjusted * adjusted, dim=-1, keepdim=True) < 1e-8
    p_cam = rotops.angle_axis_rotate_point(e6[..., 3:], adjusted)
    pixel = _pixel_of(params, p_cam, present_models, model_idx)
    r = sqrt_info * (pixel - uv)
    return torch.where(too_close, torch.zeros((), dtype=r.dtype, device=r.device), r)


def _tangent_basis4(x4):
    """Orthonormal basis [.., 4, 3] of the tangent space at unit 4-vectors
    x4 [.., 4] (Householder construction: the homogeneous-point manifold of
    `SetHomogeneousPointParametrization`, bundle_adjuster.h:121)."""
    n = torch.linalg.norm(x4, dim=-1, keepdim=True)
    xh = x4 / torch.clamp(n, min=1e-12)
    one = torch.ones((), dtype=x4.dtype, device=x4.device)
    sign = torch.where(xh[..., 3] >= 0, one, -one)
    v = torch.cat([xh[..., :3], xh[..., 3:] + sign[..., None]], dim=-1)
    vv = torch.clamp(torch.sum(v * v, dim=-1), min=1e-12)
    eye = torch.eye(4, dtype=x4.dtype, device=x4.device)
    H = eye - 2.0 * v[..., :, None] * v[..., None, :] / vv[..., None, None]
    return H[..., :, :3]


def _point_tangent_basis4(x4):
    """Well-conditioned projective tangent basis [.., 4, 3] at unit
    4-vectors x4 [.., 4].

    Solves (dp/dx4) B = I_3 on the chart p = xyz / w: B = w B_s inv(M3) with
    M3 = [I | -p] B_s, so the point block is conditioned as in the
    Euclidean parametrization. The orthonormal sphere basis instead carries
    a factor ~1/w a unit step and stalled f32 LM at 0.21 m on the 2152-view
    ring (the JAX package's `ba/lm.py:231-264`). Where |w| <= 1e-3 (points
    near infinity) it falls back to the sphere basis."""
    n = torch.linalg.norm(x4, dim=-1, keepdim=True)
    xh = x4 / torch.clamp(n, min=1e-12)
    Bs = _tangent_basis4(x4)
    w = xh[..., 3]
    safe = torch.abs(w) > 1e-3
    wsafe = torch.where(safe, w, torch.ones_like(w))
    p = xh[..., :3] / wsafe[..., None]
    M3 = Bs[..., :3, :] - p[..., :, None] * Bs[..., 3:4, :]
    Bc = wsafe[..., None, None] * (Bs @ inv3x3(M3))
    return torch.where(safe[..., None, None], Bc, Bs)


# ---------------------------------------------------------------------------
# Small inverses.
# ---------------------------------------------------------------------------


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate over determinant, the
    determinant floored at 1e-30 in magnitude as the JAX package does)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def inv_small_spd(A, K: int):
    """Batched small SPD inverse without a LAPACK loop: closed form for
    K in {1, 3}, a 3+3 block Schur on `inv3x3` for K = 6, `torch.linalg.inv`
    otherwise."""
    if K == 1:
        return 1.0 / torch.where(torch.abs(A) < 1e-30, torch.full_like(A, 1e-30), A)
    if K == 3:
        return inv3x3(A)
    if K == 6:
        A11 = A[..., :3, :3]
        A12 = A[..., :3, 3:]
        A22 = A[..., 3:, 3:]
        A11i = inv3x3(A11)
        S = A22 - A12.mT @ A11i @ A12
        Si = inv3x3(S)
        X = A11i @ A12
        B12 = -(X @ Si)
        B11 = A11i - B12 @ X.mT
        top = torch.cat([B11, B12], dim=-1)
        bot = torch.cat([B12.mT, Si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    return torch.linalg.inv(A)


# ---------------------------------------------------------------------------
# What is not ported.
# ---------------------------------------------------------------------------


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def bundle_adjust(*args, **kwargs):
    """The flat implicit-PCG LM kernel (INVERSE_DEPTH, degenerate slot
    layouts): not ported."""
    _not_ported("the flat implicit-PCG bundle adjustment (ba/lm.bundle_adjust)",
                FLAT_KERNEL_ITEM)


def hessian_blocks(*args, **kwargs):
    """The flat kernel's Hessian blocks: not ported."""
    _not_ported("ba/lm.hessian_blocks", FLAT_KERNEL_ITEM)


def check_no_priors(options: BundleAdjustmentOptions) -> None:
    """Raise when the options ask for view priors (not ported)."""
    if options.use_position_priors or options.use_orientation_priors or (
        options.use_gravity_priors
    ):
        _not_ported("bundle adjustment with view priors (use_*_priors)", PRIORS_ITEM)
