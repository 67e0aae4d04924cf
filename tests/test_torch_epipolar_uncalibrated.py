"""The port's uncalibrated epipolar solvers, P3P and the DLT PnP against the
JAX package's, on the CPU in f64 (the JAX tests run with x64), at the sizes
of `tests/test_minimal_solvers.py`.

Bars:
  - F (8-point, masked and not; `project_to_essential`, `compose_*`,
    `essential_matrix_from_fundamental_matrix`,
    `fundamental_matrix_from_projection_matrices`) to 1e-8 after unit
    Frobenius norm and sign;
  - seven-point candidates as sets (valid ones, up to sign) to 1e-8: the
    two solvers' bases of the 2-D nullspace differ, the candidate set does
    not;
  - focal lengths to 1e-8 relative; in f32 both packages to 5e-4 of the
    truth (the JAX package's own f32 error on the scene is 1.6e-4);
  - P3P solution sets (valid ones) to 1e-8, the validity masks equal;
    collinear points give a masked invalid result with no NaN;
  - `align_point_triads` and `dlt_pnp` (with a mask) to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import epipolar as jepi
from pytheiasfm_tpu.ops import p3p as jp3p
from pytheiasfm_tpu.ops import pnp as jpnp
from pytheiasfm_tpu_torch.ops import epipolar as tepi
from pytheiasfm_tpu_torch.ops import p3p as tp3p
from pytheiasfm_tpu_torch.ops import pnp as tpnp
from test_minimal_solvers import synth_relative_pose
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-8
F32_REL = 5e-4


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)[..., None, None]


def _same_up_to_sign(a, b):
    a, b = _unit(a), _unit(b)
    sign = np.sign(np.sum(a * b, axis=(-2, -1)))[..., None, None]
    return np.abs(a - sign * b).max()


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
def test_eight_point_fundamental_matches_jax(rng, masked):
    x1, x2, *_ = synth_relative_pose(rng, 16, 24, noise=1e-3)
    x1 = x1 * 700.0 + 30.0  # pixel-like scale, off the origin
    x2 = x2 * 700.0 - 20.0
    mask = rng.uniform(size=(16, 24)) < 0.8 if masked else None
    if masked:
        x2 = np.where(mask[..., None], x2, rng.normal(size=x2.shape) * 300)
    Fj, okj = jepi.eight_point_fundamental_matrix(
        jnp.asarray(x1), jnp.asarray(x2), None if mask is None else jnp.asarray(mask))
    Ft, okt = tepi.eight_point_fundamental_matrix(
        _t(x1), _t(x2), None if mask is None else _t(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert _same_up_to_sign(Ft.numpy(), Fj) < TOL
    np.testing.assert_allclose(np.linalg.svd(Ft.numpy(), compute_uv=False)[:, 2], 0, atol=1e-12)


def test_seven_point_candidates_match_jax_as_sets(rng):
    x1, x2, *_ = synth_relative_pose(rng, 16, 7)
    Fj, vj = jepi.seven_point_fundamental_matrix(jnp.asarray(x1), jnp.asarray(x2))
    Ft, vt = tepi.seven_point_fundamental_matrix(_t(x1), _t(x2))
    Fj, vj, Ft, vt = np.asarray(Fj), np.asarray(vj), Ft.numpy(), vt.numpy()
    for b in range(16):
        want = [Fj[b, k] for k in range(3) if vj[b, k]]
        got = [Ft[b, k] for k in range(3) if vt[b, k]]
        assert len(got) == len(want) >= 1
        for w in want:
            assert min(_same_up_to_sign(g, w) for g in got) < TOL
        for g in got:
            np.testing.assert_allclose(np.linalg.det(g), 0.0, atol=1e-12)


def test_essential_and_composition_utilities_match_jax(rng):
    x1, x2, R, t, _, _ = synth_relative_pose(rng, 8, 12, noise=1e-3)
    Fj, _ = jepi.eight_point_fundamental_matrix(jnp.asarray(x1), jnp.asarray(x2))
    Ft, _ = tepi.eight_point_fundamental_matrix(_t(x1), _t(x2))
    assert _same_up_to_sign(tepi.project_to_essential(Ft).numpy(),
                            jepi.project_to_essential(Fj)) < TOL
    f1, f2 = rng.uniform(500, 1500, 8), rng.uniform(500, 1500, 8)
    Cj = jepi.compose_fundamental_matrix(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(R),
                                         jnp.asarray(t))
    Ct = tepi.compose_fundamental_matrix(_t(f1), _t(f2), _t(R), _t(t))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=TOL, atol=1e-14)
    Ej = jepi.essential_matrix_from_fundamental_matrix(Cj, jnp.asarray(f1), jnp.asarray(f2))
    Et = tepi.essential_matrix_from_fundamental_matrix(Ct, _t(f1), _t(f2))
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=TOL, atol=1e-14)
    P1 = rng.normal(size=(8, 3, 4))
    P2 = rng.normal(size=(8, 3, 4))
    Pj = jepi.fundamental_matrix_from_projection_matrices(jnp.asarray(P1), jnp.asarray(P2))
    Pt = tepi.fundamental_matrix_from_projection_matrices(_t(P1), _t(P2))
    assert _same_up_to_sign(Pt.numpy(), Pj) < TOL


def test_focal_lengths_match_jax(rng):
    """`tests/test_minimal_solvers.py::test_focal_lengths_from_fundamental`'s
    scene in both packages, in f64 and in f32."""
    x1, x2, R, t, _, _ = synth_relative_pose(rng, 8, 8)
    f1, f2 = np.full(8, 800.0), np.full(8, 1100.0)
    F = np.asarray(jepi.compose_fundamental_matrix(jnp.asarray(f1), jnp.asarray(f2),
                                                   jnp.asarray(R), jnp.asarray(t)))
    j1, j2, jv = (np.asarray(x) for x in jepi.focal_lengths_from_fundamental_matrix(
        jnp.asarray(F)))
    t1, t2, tv = (x.numpy() for x in tepi.focal_lengths_from_fundamental_matrix(_t(F)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(t1, j1, rtol=TOL)
    np.testing.assert_allclose(t2, j2, rtol=TOL)
    js, jsv = jepi.shared_focal_lengths_from_fundamental_matrix(jnp.asarray(F))
    ts, tsv = tepi.shared_focal_lengths_from_fundamental_matrix(_t(F))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    # f32: both packages to F32_REL (the JAX package's own f32 error here
    # reaches 1.6e-4, past the f64 test's 1e-4).
    for r1, r2, rv in (
        (np.asarray(x) for x in jepi.focal_lengths_from_fundamental_matrix(
            jnp.asarray(F, jnp.float32))),
        (x.numpy() for x in tepi.focal_lengths_from_fundamental_matrix(
            torch.tensor(F, dtype=torch.float32))),
    ):
        good = rv & np.isfinite(r1) & np.isfinite(r2)
        assert good.sum() >= 6
        np.testing.assert_allclose(r1[good], 800.0, rtol=F32_REL)
        np.testing.assert_allclose(r2[good], 1100.0, rtol=F32_REL)


def test_p3p_solution_sets_match_jax(rng):
    _, x2, _, _, _, pts = synth_relative_pose(rng, 32, 3)
    Rj, tj, vj = (np.asarray(a) for a in jp3p.pose_from_three_points(jnp.asarray(x2),
                                                                      jnp.asarray(pts)))
    Rt, tt, vt = (a.numpy() for a in tp3p.pose_from_three_points(_t(x2), _t(pts)))
    np.testing.assert_array_equal(vt, vj)
    assert vt.any(axis=-1).all()
    np.testing.assert_allclose(np.where(vt[..., None, None], Rt, 0),
                               np.where(vj[..., None, None], Rj, 0), atol=TOL)
    np.testing.assert_allclose(np.where(vt[..., None], tt, 0), np.where(vj[..., None], tj, 0),
                               atol=TOL)


def test_p3p_collinear_is_masked_without_nan():
    world = np.asarray([[0.0, 0, 5], [0.1, 0, 5], [0.2, 0, 5]])[None]
    feat = world[..., :2] / world[..., 2:3]
    R, t, valid = tp3p.pose_from_three_points(_t(feat), _t(world))
    _, _, jvalid = jp3p.pose_from_three_points(jnp.asarray(feat), jnp.asarray(world))
    assert not valid.any() and not np.asarray(jvalid).any()
    assert torch.isfinite(R).all() and torch.isfinite(t).all()


def test_align_point_triads_and_dlt_pnp_match_jax(rng):
    p = rng.normal(size=(6, 5, 3))
    q = p @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=3) \
        + rng.normal(size=p.shape) * 1e-2
    Rj, tj = jp3p.align_point_triads(jnp.asarray(p), jnp.asarray(q))
    Rt, tt = tp3p.align_point_triads(_t(p), _t(q))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=TOL)

    _, x2, R, t, _, pts = synth_relative_pose(rng, 4, 40, noise=1e-3)
    mask = np.ones((4, 40), bool)
    mask[:, 30:] = False
    x2[:, 30:] += 0.3  # masked rows are outliers
    Rj, cj, okj = jpnp.dlt_pnp(jnp.asarray(x2), jnp.asarray(pts), mask=jnp.asarray(mask))
    Rt, ct, okt = tpnp.dlt_pnp(_t(x2), _t(pts), mask=_t(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=TOL)
    np.testing.assert_allclose(Rt.numpy(), R, atol=5e-3)
