"""The port's geometry kernels against the JAX package's: rotations, the
polynomial root finder, the five-point solver, the essential-matrix
decomposition and pose choice, the Sampson distance and the cheirality test.

Tolerances: 1e-8 relative in f64. The five-point solutions are compared as
sets (valid solutions only, E up to sign) to 1e-8 in f64 given the same
nullspace basis; in f32 the solution nearest the truth is compared, to the
JAX package's own f32 accuracy bar of 5e-3. The two SVD libraries return different
bases of the 4D nullspace, and the root finder's brackets depend on that
parametrization, so end to end the solvers are held to the same recovery
of the true E instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import epipolar as jepi
from pytheiasfm_tpu.ops import five_point as jfp
from pytheiasfm_tpu.ops import polynomial as jpoly
from pytheiasfm_tpu.ops import rotation as jrot
from pytheiasfm_tpu.ops import triangulation as jtri
from pytheiasfm_tpu_torch.ops import epipolar as tepi
from pytheiasfm_tpu_torch.ops import five_point as tfp
from pytheiasfm_tpu_torch.ops import polynomial as tpoly
from pytheiasfm_tpu_torch.ops import rotation as trot
from pytheiasfm_tpu_torch.ops import triangulation as ttri


def _close(t, j, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _synth(rng, B, N, noise=0.0):
    """Random relative poses with N correspondences each (normalized), as
    `tests/test_minimal_solvers.py` builds them."""
    aa = rng.normal(size=(B, 3)) * 0.3
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    t = rng.normal(size=(B, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    pts = rng.uniform(-1, 1, size=(B, N, 3)) + np.asarray([0, 0, 4.0])
    x1 = pts[..., :2] / pts[..., 2:3]
    p2 = np.einsum("bij,bnj->bni", R, pts) + t[:, None, :]
    x2 = p2[..., :2] / p2[..., 2:3]
    if noise:
        x1 = x1 + rng.normal(size=x1.shape) * noise
        x2 = x2 + rng.normal(size=x2.shape) * noise
    return x1, x2, R, t


ROTATION_FNS = [
    ("angle_axis_to_rotation_matrix", "aa"),
    ("rotation_matrix_to_angle_axis", "R"),
    ("angle_axis_to_quaternion", "aa"),
    ("quaternion_to_angle_axis", "q"),
    ("quaternion_to_rotation_matrix", "q"),
    ("rotation_matrix_to_quaternion", "R"),
    ("hat", "aa"),
    ("project_to_so3", "M"),
]


@pytest.mark.parametrize("name,arg", ROTATION_FNS)
def test_rotation_conversions(rng, name, arg):
    aa = rng.normal(size=(64, 3))
    aa[0] = 0.0  # theta = 0 branch
    aa[1] = [1e-5, -2e-5, 0.0]  # Taylor branch
    aa[2] = [np.pi - 1e-7, 0.0, 0.0]  # near pi
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    q = np.asarray(jrot.angle_axis_to_quaternion(jnp.asarray(aa)))
    inputs = dict(aa=aa, R=R, q=q, M=R + 0.05 * rng.normal(size=R.shape))
    x = inputs[arg]
    _close(getattr(trot, name)(torch.tensor(x)), getattr(jrot, name)(jnp.asarray(x)))


def test_rotation_two_argument_functions(rng):
    a, b = rng.normal(size=(2, 32, 3))
    p = rng.normal(size=(32, 3))
    for name, (u, v) in (
        ("multiply_rotations", (a, b)),
        ("relative_rotation_from_two_rotations", (a, b)),
        ("apply_relative_rotation", (a, b)),
        ("angle_axis_rotate_point", (a, p)),
        ("align_rotations", (a, b)),
    ):
        got = getattr(trot, name)(torch.tensor(u), torch.tensor(v))
        _close(got, getattr(jrot, name)(jnp.asarray(u), jnp.asarray(v)))
    _close(trot.vee(trot.hat(torch.tensor(a))), a)


def test_find_real_polynomial_roots(rng):
    # Degree-10 polynomials with 0..10 real roots (products of real linear
    # and irreducible quadratic factors), plus random coefficients.
    polys = []
    for n_real in range(0, 11, 2):
        roots = rng.uniform(-3, 3, size=n_real)
        c = np.poly(roots) if n_real else np.ones(1)
        for _ in range((10 - n_real) // 2):
            c = np.polymul(c, [1.0, rng.normal(), 1.0 + rng.uniform(1, 2)])
        polys.append(c)
    polys += list(rng.normal(size=(10, 11)))
    coeffs = np.stack(polys)
    rt, vt = tpoly.find_real_polynomial_roots(torch.tensor(coeffs))
    rj, vj = jpoly.find_real_polynomial_roots(jnp.asarray(coeffs))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    _close(rt, rj, rtol=1e-8, atol=1e-9)


def test_closed_form_polynomial_solvers(rng):
    c = rng.normal(size=(5, 40))
    for name, n in (("solve_quadratic", 3), ("solve_cubic", 4), ("solve_quartic", 5)):
        rt, vt = getattr(tpoly, name)(*torch.tensor(c[:n]))
        rj, vj = getattr(jpoly, name)(*jnp.asarray(c[:n]))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        sel = np.asarray(vj)
        _close(rt.numpy()[sel], np.asarray(rj)[sel], rtol=1e-7, atol=1e-8)


def _solution_sets_match(Et, vt, Ej, vj, tol):
    """Per sample: the valid solutions (up to sign) of both agree."""
    solved = 0
    for b in range(len(Et)):
        st = [Et[b, k] for k in range(10) if vt[b, k]]
        sj = [Ej[b, k] for k in range(10) if vj[b, k]]
        assert len(st) == len(sj), (b, len(st), len(sj))
        for e in sj:
            best = min(min(np.abs(e - f).max(), np.abs(e + f).max()) for f in st)
            assert best < tol, (b, best)
        solved += bool(sj)
    return solved


def _jax_nullspace(x1, x2):
    """The nullspace basis the JAX solver takes: the last four rows of the
    SVD of the 5x9 design matrix (`five_point.py:119-132`)."""
    h1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    h2 = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Q = (h2[..., :, None] * h1[..., None, :]).reshape(x1.shape[:-1] + (9,))
    return np.asarray(jnp.linalg.svd(Q, full_matrices=True)[2][..., -4:, :])


def _closest(E, valid, E_gt):
    """Per sample: the valid solution nearest the truth (up to sign)."""
    out = np.full(E_gt.shape, np.nan)
    for b in range(len(E)):
        cands = [E[b, k] * np.sign(np.sum(E[b, k] * E_gt[b])) for k in range(10) if valid[b, k]]
        if cands:
            out[b] = min(cands, key=lambda e: np.abs(e - E_gt[b]).max())
    return out


def _recovers(E, valid, E_gt, tol):
    return np.abs(_closest(E, valid, E_gt) - E_gt).max(axis=(1, 2)) < tol


def test_five_point_from_the_same_nullspace_f64(rng):
    """Given JAX's nullspace basis, the port's solver returns the JAX
    solver's solution set to 1e-8."""
    x1, x2, *_ = _synth(rng, 32, 5)
    x1, x2 = jnp.asarray(x1), jnp.asarray(x2)
    Ej, vj = jax.jit(jfp.five_point_relative_pose)(x1, x2)
    Et, vt = tfp.essentials_from_nullspace(torch.tensor(_jax_nullspace(x1, x2)))
    solved = _solution_sets_match(Et.numpy(), vt.numpy(), np.asarray(Ej), np.asarray(vj), 1e-8)
    assert solved == 32


def test_five_point_from_the_same_nullspace_f32(rng):
    """In f32 the degree-10 coefficients carry rounding that differs with
    the order of the 10x10 determinant's operations, so spurious roots can
    differ and each recovered solution is only as accurate as f32 allows:
    the JAX package's own f32 bar is 5e-3 from the truth
    (`tests/test_minimal_solvers.py:78`). Wherever both recover the truth
    to that bar, the two solutions nearest it agree to the same 5e-3 (the
    largest gap measured on this seed is 2.4e-3)."""
    x1, x2, R, t = _synth(rng, 64, 5)
    E_gt = _essential(R, t)
    E_gt /= np.linalg.norm(E_gt, axis=(1, 2), keepdims=True)
    x1, x2 = jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    Ej, vj = jax.jit(jfp.five_point_relative_pose)(x1, x2)
    Et, vt = tfp.essentials_from_nullspace(torch.tensor(_jax_nullspace(x1, x2)))
    cj = _closest(np.asarray(Ej), np.asarray(vj), E_gt)
    ct = _closest(Et.numpy(), vt.numpy(), E_gt)
    both = (np.abs(cj - E_gt).max(axis=(1, 2)) < 5e-3) & (np.abs(ct - E_gt).max(axis=(1, 2)) < 5e-3)
    assert both.sum() >= 40
    np.testing.assert_allclose(ct[both], cj[both], atol=5e-3)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 5e-3)])
def test_five_point_recovers_ground_truth_as_jax_does(rng, dtype, tol):
    """End to end, each package with its own SVD: the port recovers the true
    E on as many of 256 samples as the JAX solver, within 2% (rates
    measured on two seeds of 512: f64 492/492 and 498/503, f32 417/415 and
    413/411, port/JAX)."""
    x1, x2, R, t = _synth(rng, 256, 5)
    E_gt = _essential(R, t)
    E_gt /= np.linalg.norm(E_gt, axis=(1, 2), keepdims=True)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    Et, vt = tfp.five_point_relative_pose(
        torch.tensor(x1, dtype=tdtype), torch.tensor(x2, dtype=tdtype)
    )
    Ej, vj = jax.jit(jfp.five_point_relative_pose)(
        jnp.asarray(x1, dtype), jnp.asarray(x2, dtype)
    )
    rt = _recovers(Et.numpy(), vt.numpy(), E_gt, tol).sum()
    rj = _recovers(np.asarray(Ej), np.asarray(vj), E_gt, tol).sum()
    assert rt >= rj - 0.02 * 256, (rt, rj)
    assert rt >= (0.9 if dtype == np.float64 else 0.7) * 256, rt


def test_five_point_non_minimal(rng):
    x1, x2, *_ = _synth(rng, 8, 12, noise=1e-3)
    Ej, vj = jax.jit(jfp.five_point_relative_pose)(jnp.asarray(x1), jnp.asarray(x2))
    null = _jax_nullspace(jnp.asarray(x1), jnp.asarray(x2))
    Et, vt = tfp.essentials_from_nullspace(torch.tensor(null))
    _solution_sets_match(Et.numpy(), vt.numpy(), np.asarray(Ej), np.asarray(vj), 1e-8)


def _essential(R, t):
    return np.stack([np.cross(np.eye(3), t[b]) @ R[b] for b in range(len(R))])


def test_decompose_and_best_pose(rng):
    x1, x2, R, t = _synth(rng, 16, 20)
    E = _essential(R, t) * rng.choice([-1.0, 1.0], size=(16, 1, 1))
    for a, b in zip(tepi.decompose_essential_matrix(torch.tensor(E)),
                    jepi.decompose_essential_matrix(jnp.asarray(E))):
        _close(a, b)
    got = tepi.get_best_pose_from_essential_matrix(
        torch.tensor(E), torch.tensor(x1), torch.tensor(x2)
    )
    want = jepi.get_best_pose_from_essential_matrix(
        jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)
    )
    for a, b in zip(got, want):
        _close(a, b)
    _close(got[0], R, rtol=1e-8, atol=1e-9)
    mask = rng.uniform(size=(16, 20)) < 0.7
    got = tepi.get_best_pose_from_essential_matrix(
        torch.tensor(E), torch.tensor(x1), torch.tensor(x2), mask=torch.tensor(mask)
    )
    want = jepi.get_best_pose_from_essential_matrix(
        jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), mask=jnp.asarray(mask)
    )
    for a, b in zip(got, want):
        _close(a, b)


def test_sampson_and_cheirality(rng):
    x1, x2, R, t = _synth(rng, 6, 50, noise=1e-3)
    E = _essential(R, t)
    _close(
        tepi.squared_sampson_distance(torch.tensor(E), torch.tensor(x1), torch.tensor(x2)),
        jepi.squared_sampson_distance(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)),
        atol=1e-14,
    )
    # A block of hypotheses [P, H] against points [P, 1, N]: the broadcast
    # form the RANSAC scorer uses.
    Eh = E[:, None] + 0.01 * rng.normal(size=(6, 4, 3, 3))
    got = tepi.squared_sampson_distance(
        torch.tensor(Eh), torch.tensor(x1)[:, None], torch.tensor(x2)[:, None]
    )
    want = jax.vmap(jax.vmap(jepi.squared_sampson_distance, (0, None, None)))(
        jnp.asarray(Eh), jnp.asarray(x1), jnp.asarray(x2)
    )
    _close(got, want, atol=1e-14)
    pos = -np.einsum("bji,bj->bi", R, t)
    flip = rng.choice([-1.0, 1.0], size=(6, 1))
    got = ttri.is_triangulated_point_in_front_of_cameras(
        torch.tensor(x1), torch.tensor(x2), torch.tensor(R)[:, None],
        torch.tensor(pos * flip)[:, None],
    )
    want = jtri.is_triangulated_point_in_front_of_cameras(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(R)[:, None],
        jnp.asarray(pos * flip)[:, None],
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[flip[:, 0] > 0].all()
