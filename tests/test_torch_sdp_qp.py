"""The port's box QP and constrained L1 (`math/qp.py`), block SDP
(`math/sdp.py`) and the SDP rotation estimators (LAGRANGE_DUAL, HYBRID) with
the L1-only one, each against the JAX function on the same numpy-seeded
inputs: the cases of `tests/test_math_solvers.py` and the graphs of
`tests/test_sdp_and_positions.py`. CPU, f64.

Random starts: the JAX staircase draws its power-iteration start from
`jax.random.PRNGKey(1)` (`certificate_min_eig` alone from `PRNGKey(0)`);
the tests draw the same vector with `jax.random` and hand it to the port
(`v0`). Bars where the start is shared: the QP / L1 solutions 1e-8; the
certificate's eigenvalue and vector 1e-8; the staircase's objective 1e-10
relative and its Y 1e-7 (on the noiseless graph the objective is flat
along the gauge, and 200 fixed steps move the iterate by 1.6e-8 between
the packages, the objective by 3e-14); the rounded rotations 1e-7 rad after
the gauge alignment. With the port's own generator (the default start):
1e-6 rad after the gauge alignment, and the JAX tests' bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.global_pose import rotation_estimator as jrot
from pytheiasfm_tpu.math import qp as jqp
from pytheiasfm_tpu.math import sdp as jsdp
from pytheiasfm_tpu.ops import rotation as jrotops
from pytheiasfm_tpu_torch.global_pose import rotation_estimator as trot
from pytheiasfm_tpu_torch.math import qp as tqp
from pytheiasfm_tpu_torch.math import sdp as tsdp
from pytheiasfm_tpu_torch.ops import rotation as rotops
from test_sdp_and_positions import _make_rotation_graph, _max_rotation_error_deg
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

T = torch.as_tensor
SOLUTION_TOL = 1e-8
SHARED_ROTATION_TOL_RAD = 1e-7
OWN_START_ROTATION_TOL_RAD = 1e-6


def _jax_normal(key, n):
    return T(np.asarray(jax.random.normal(jax.random.PRNGKey(key), (n,), jnp.float64)))


def _aligned_angle(a, b):
    """Largest angle (rad) between angle-axis sets a and b [V, 3] after
    aligning a onto b by one global rotation (`align_orientations`)."""
    a, b = T(np.asarray(a)), T(np.asarray(b))
    rel = rotops.angle_axis_to_rotation_matrix(rotops.align_orientations(b, a)) @ (
        rotops.angle_axis_to_rotation_matrix(b).mT)
    return float(torch.linalg.norm(rotops.rotation_matrix_to_angle_axis(rel), dim=-1).max())


# ---------------------------------------------------------------- math/qp


def _box_case(name):
    if name == "projection":
        rng = np.random.default_rng(51)
        n = 32
        c = rng.normal(size=n) * 3
        return np.eye(n), -c, -np.ones(n), np.ones(n), 200
    rng = np.random.default_rng(52)
    n = 16
    A = rng.normal(size=(n, n))
    return A @ A.T + np.eye(n), rng.normal(size=n), np.full(n, -0.3), np.full(n, 0.3), 500


@pytest.mark.parametrize("name", ["projection", "general_psd"])
def test_box_qp_matches_jax(name):
    P, q, lower, upper, iters = _box_case(name)
    Pj = jnp.asarray(P)
    want = np.asarray(jqp.solve_box_qp(lambda v: Pj @ v, jnp.asarray(q), jnp.asarray(lower),
                                       jnp.asarray(upper), outer_iters=iters))
    Pt = T(P)
    got = tqp.solve_box_qp(lambda v: Pt @ v, T(q), T(lower), T(upper),
                           outer_iters=iters).numpy()
    assert np.abs(got - want).max() <= SOLUTION_TOL
    # The JAX test's own bar: the projected gradient vanishes (KKT).
    pg = np.clip(got - (P @ got + q), lower, upper) - got
    assert np.abs(pg).max() < 1e-4


def test_constrained_l1_matches_jax():
    rng = np.random.default_rng(53)
    n = 24
    b = rng.normal(size=n)
    h = rng.normal(size=n) * 0.5

    def eye(v):
        return v

    want = np.asarray(jqp.solve_constrained_l1(eye, eye, jnp.asarray(b), eye, eye,
                                               jnp.asarray(h), n, outer_iters=400))
    got = tqp.solve_constrained_l1(eye, eye, T(b), eye, eye, T(h), n, outer_iters=400).numpy()
    assert np.abs(got - want).max() <= SOLUTION_TOL
    assert np.abs(got - np.maximum(b, h)).max() < 1e-3


# ---------------------------------------------------------------- math/sdp

# The graphs of `test_lagrange_dual_rotation_noiseless` / `_noisy`: (seed,
# views, extra edges a view, relative-rotation noise in degrees).
GRAPHS = {"noiseless": (41, 12, 2, 0.0), "noisy": (42, 20, 4, 2.0)}
JAX_BARS_DEG = {"noiseless": 0.1, "noisy": 5.0}


def _jax_cost(ei, ej, rel, V):
    """The JAX package's cost matrix, assembled as its
    `lagrange_dual_rotation_averaging` assembles it."""
    R_rel = jax.vmap(jrotops.angle_axis_to_rotation_matrix)(jnp.asarray(rel))
    rows_i = (3 * ei[:, None, None] + np.arange(3)[None, :, None]).repeat(3, 2)
    cols_j = (3 * ej[:, None, None] + np.arange(3)[None, None, :]).repeat(3, 1)
    C = jnp.zeros((3 * V, 3 * V))
    C = C.at[rows_i, cols_j].add(-jnp.swapaxes(R_rel, -1, -2))
    return C.at[cols_j.swapaxes(1, 2), rows_i.swapaxes(1, 2)].add(-R_rel)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def sdp_case(request):
    seed, V, extra, noise = GRAPHS[request.param]
    gt, ei, ej, rel = _make_rotation_graph(np.random.default_rng(seed), V, extra, noise)
    Cj = _jax_cost(ei, ej, rel, V)
    eye = jnp.tile(jnp.eye(3), (V, 1))
    out = dict(name=request.param, V=V, gt=gt, edges=(ei, ej, rel), C=np.array(Cj))
    Y, obj = jsdp.solve_block_sdp(Cj, eye, V, 3, 200)
    out["solve"] = (np.array(Y), float(obj))
    lam, v = jsdp.certificate_min_eig(Cj, Y, V, 64)
    out["certificate"] = (float(lam), np.array(v))
    Y, obj, lam = jsdp.riemannian_staircase(Cj, V)
    out["staircase"] = (np.array(Y), float(obj), float(lam))
    out["rounded"] = np.array(jsdp.round_block_solution(Y, V))
    aa, lam = jrot.lagrange_dual_rotation_averaging(
        jnp.array(ei), jnp.array(ej), jnp.array(rel), V)
    out["lagrange_dual"] = (np.array(aa), float(lam))
    return out


def _port_edges(case):
    ei, ej, rel = case["edges"]
    return T(ei).long(), T(ej).long(), T(rel)


def test_cost_matrix_matches_jax(sdp_case):
    C = trot._dual_cost(*_port_edges(sdp_case), sdp_case["V"]).numpy()
    assert np.abs(C - sdp_case["C"]).max() <= 1e-15


def test_solve_block_sdp_matches_jax(sdp_case):
    V = sdp_case["V"]
    start = torch.eye(3, dtype=torch.float64).repeat(V, 1)
    Y, obj = tsdp.solve_block_sdp(T(sdp_case["C"]), start, V, 3, 200)
    want_Y, want_obj = sdp_case["solve"]
    assert abs(float(obj) - want_obj) <= 1e-10 * abs(want_obj)
    assert np.abs(Y.numpy() - want_Y).max() <= 1e-7
    # Each 3-row block stays orthonormal.
    blocks = Y.reshape(V, 3, 3)
    assert float(torch.abs(blocks @ blocks.mT - torch.eye(3, dtype=Y.dtype)).max()) <= 1e-12


def test_certificate_min_eig_matches_jax(sdp_case):
    V = sdp_case["V"]
    lam, v = tsdp.certificate_min_eig(T(sdp_case["C"]), T(sdp_case["solve"][0]), V, 64,
                                      v0=_jax_normal(0, 3 * V))
    want_lam, want_v = sdp_case["certificate"]
    assert abs(float(lam) - want_lam) <= SOLUTION_TOL * max(1.0, abs(want_lam))
    assert np.abs(v.numpy() - want_v).max() <= SOLUTION_TOL


def test_riemannian_staircase_matches_jax(sdp_case):
    V = sdp_case["V"]
    Y, obj, lam = tsdp.riemannian_staircase(T(sdp_case["C"]), V, v0=_jax_normal(1, 3 * V))
    want_Y, want_obj, want_lam = sdp_case["staircase"]
    assert Y.shape == want_Y.shape == (3 * V, tsdp.SDPSolverOptions().max_rank)
    assert abs(float(obj) - want_obj) <= 1e-10 * abs(want_obj)
    assert abs(float(lam) - want_lam) <= 1e-7 * max(1.0, abs(want_lam))
    assert np.abs(Y.numpy() - want_Y).max() <= 1e-7


def test_round_block_solution_matches_jax_up_to_gauge(sdp_case):
    """The same rotations as the JAX rounding of the same Y, up to one
    global rotation (singular vectors are sign and basis ambiguous)."""
    V = sdp_case["V"]
    R = tsdp.round_block_solution(T(sdp_case["staircase"][0]), V).numpy()
    want = sdp_case["rounded"]
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    gauge = np.einsum("nji,njk->nik", want, R)  # R_jax_iᵀ R_port_i, one G for all i
    assert np.abs(gauge - gauge[0]).max() <= 1e-10


def test_lagrange_dual_rotations_match_jax(sdp_case):
    V = sdp_case["V"]
    want_aa, want_lam = sdp_case["lagrange_dual"]
    aa, lam = trot.lagrange_dual_rotation_averaging(*_port_edges(sdp_case), V,
                                                    v0=_jax_normal(1, 3 * V))
    assert _aligned_angle(aa, want_aa) <= SHARED_ROTATION_TOL_RAD
    assert abs(float(lam) - want_lam) <= 1e-7 * max(1.0, abs(want_lam))
    # With the port's own start.
    aa, _ = trot.lagrange_dual_rotation_averaging(*_port_edges(sdp_case), V)
    assert _aligned_angle(aa, want_aa) <= OWN_START_ROTATION_TOL_RAD
    assert _max_rotation_error_deg(sdp_case["gt"], aa.numpy()) < JAX_BARS_DEG[sdp_case["name"]]


# ----------------------------------------- HYBRID and L1-only rotations


def test_hybrid_rotations_match_jax():
    """`test_hybrid_rotation`'s graph (seed 43, 16 views, 1 deg noise)."""
    gt, ei, ej, rel = _make_rotation_graph(np.random.default_rng(43), 16, 3, 1.0)
    free = np.ones(16, bool)
    want = np.asarray(jrot.hybrid_rotation_averaging(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel), jnp.asarray(free), 16))
    edges = (T(ei).long(), T(ej).long(), T(rel))
    got = trot.hybrid_rotation_averaging(*edges, T(free), 16, v0=_jax_normal(1, 48))
    assert _aligned_angle(got, want) <= SHARED_ROTATION_TOL_RAD
    got = trot.hybrid_rotation_averaging(*edges, T(free), 16)
    assert _aligned_angle(got, want) <= OWN_START_ROTATION_TOL_RAD
    assert _max_rotation_error_deg(gt, got.numpy()) < 3.0


def test_l1_rotation_global_matches_jax():
    """`test_l1_rotation_global`'s graph (seed 44, 10 views, view 0 fixed):
    no random start, so the orientations themselves are compared."""
    rng = np.random.default_rng(44)
    gt, ei, ej, rel = _make_rotation_graph(rng, 10, extra_edges=3)
    init = gt + np.asarray(rng.normal(size=(10, 3))) * 0.05
    init[0] = gt[0]
    free = np.ones(10, bool)
    free[0] = False
    want = np.asarray(jrot.l1_rotation_global(
        jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel),
        jnp.asarray(free), 10))
    got = trot.l1_rotation_global(T(init), T(ei).long(), T(ej).long(), T(rel), T(free), 10)
    rel_R = rotops.angle_axis_to_rotation_matrix(got) @ rotops.angle_axis_to_rotation_matrix(
        T(want)).mT
    assert float(torch.linalg.norm(rotops.rotation_matrix_to_angle_axis(rel_R), dim=-1).max()) \
        <= SOLUTION_TOL
    assert _max_rotation_error_deg(gt, got.numpy()) < 0.5
