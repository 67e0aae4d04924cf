"""The port's dense-Schur bundle adjustment (`pytheiasfm_tpu_torch/ba/dense_schur.py`)
against the JAX package's (`ba/dense_schur.py`), on the CPU.

Inputs: `tests/test_dense_schur._make_problem(default_rng(42))` (8 views, 60
tracks of 4 views, 0.5 px noise, 2% perturbation, views 0 and 1 frozen) in
its track-slot layout. Bars, f64: the same LM iteration count, initial and
final cost to 1e-8 relative, extrinsics and points to 1e-7 (absolute, values
of order 1-10). Cases: XYZW, XYZW_MANIFOLD, a per-DOF camera mask
(orientations frozen), a Huber loss, and position + orientation + gravity
priors. f32 and mixed precision (bf16 block products): the final cost to
1e-4 relative. The exact joint covariance: every free block to 1e-8
relative of the largest entry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import dense_schur as jds
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions
from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.ba.losses import LossFunctionType as JLoss
from pytheiasfm_tpu_torch.ba import dense_schur as tds
from pytheiasfm_tpu_torch.utils import counters
from test_dense_schur import _make_problem
from test_torch_bundle_adjustment import _t_options
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

COST_REL = 1e-8
STATE_TOL = 1e-7
F32_COST_REL = 1e-4
COV_REL = 1e-8


def kernel_problem(name):
    """(problem dict, points, camera_free, priors (numpy 9-tuple or None),
    JAX options) of a named case on `_make_problem`."""
    p = _make_problem(np.random.default_rng(42))
    pts, cam_free, priors = p["pts"], p["cam_free"], None
    options = JOptions(max_num_iterations=30)
    if name == "manifold":
        pts = np.concatenate([pts, np.ones((p["T"], 1))], 1)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        options = JOptions(max_num_iterations=30, track_parametrization_type=JTP.XYZW_MANIFOLD)
    elif name == "dof_mask":
        cam_free = np.zeros((p["V"], 6), bool)
        cam_free[2:, :3] = True  # positions move, orientations stay
    elif name == "huber":
        options = JOptions(max_num_iterations=30, loss_function_type=JLoss.HUBER,
                           robust_loss_width=0.5)
    elif name == "priors":
        priors = make_priors(p["ext"], np.random.default_rng(5))
        options = JOptions(max_num_iterations=30, use_position_priors=True,
                           use_orientation_priors=True, use_gravity_priors=True)
    return p, pts, cam_free, priors, options


def make_priors(ext, rng):
    """Position, orientation and gravity priors near the extrinsics ext
    [V, 6], unset on view 3, as the entry lays them out."""
    from pytheiasfm_tpu_torch.ops import rotation as rotops

    V = len(ext)
    R = rotops.angle_axis_to_rotation_matrix(torch.as_tensor(ext[:, 3:])).numpy()
    mask = np.ones(V)
    mask[3] = 0.0
    info = np.eye(3) * 20.0 + rng.normal(size=(V, 3, 3))
    return (ext[:, :3] + rng.normal(size=(V, 3)) * 0.05, info, mask,
            ext[:, 3:] + rng.normal(size=(V, 3)) * 0.01, info * 10.0, mask,
            -R[:, :, 2] + rng.normal(size=(V, 3)) * 0.01, info, mask)


def dense_args(p, pts, cam_free, dtype=np.float64):
    V, T, L = p["V"], p["T"], p["L"]
    args = [p["ext"], p["intr"], pts, p["view_group"], p["group_model_idx"], p["track_views"],
            p["uv"].reshape(T, L, 2), p["info"].reshape(T, L, 2), p["mask"].reshape(T, L),
            cam_free, p["pt_free"]]
    args = [a.astype(dtype) if a.dtype == np.float64 else a for a in args]
    kw = dict(present_models=(0,), num_views=V, num_tracks=T, max_track_len=L, num_groups=1)
    return args, kw


def _prior_tensors(priors, dtype, to):
    return None if priors is None else tuple(to(np.asarray(a, dtype)) for a in priors)


def run_dense(name, dtype=np.float64, jopt=None):
    p, pts, cam_free, priors, options = kernel_problem(name)
    options = jopt or options
    args, kw = dense_args(p, pts, cam_free, dtype)
    jout = jds.bundle_adjust_dense(*(jnp.asarray(a) for a in args), options=options,
                                   priors=_prior_tensors(priors, dtype, jnp.asarray), **kw)
    counters.reset()
    tout = tds.bundle_adjust_dense(*(torch.as_tensor(a) for a in args),
                                   options=_t_options(options),
                                   priors=_prior_tensors(priors, dtype, torch.as_tensor), **kw)
    assert counters.snapshot() == {"ba_launch": 1}
    return ([np.asarray(x) for x in jout[:3]], jout[3], [x.numpy() for x in tout[:3]],
            tout[3])


DENSE_CASES = ["xyzw", "manifold", "dof_mask", "huber", "priors"]


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_kernel_f64(name):
    jout, js, tout, ts = run_dense(name)
    assert ts.num_iterations == int(js.num_iterations) > 1
    assert ts.linear_solver == "dense" and ts.num_linear_solver_iterations == 0
    assert ts.initial_cost == pytest.approx(float(js.initial_cost), rel=COST_REL)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.success and bool(js.success)
    assert ts.final_cost < 0.5 * ts.initial_cost
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=0, atol=STATE_TOL * max(1.0, np.abs(want).max()))
    p = _make_problem(np.random.default_rng(42))
    np.testing.assert_array_equal(tout[0][:2], p["ext"][:2])  # frozen views stay
    if name == "dof_mask":
        np.testing.assert_array_equal(tout[0][:, 3:], p["ext"][:, 3:])


@pytest.mark.parametrize("name,mixed", [("xyzw", False), ("xyzw", True), ("manifold", True),
                                        ("priors", False)])
def test_dense_kernel_f32_and_mixed_precision(name, mixed):
    options = dataclasses.replace(kernel_problem(name)[4], use_mixed_precision_solves=mixed)
    jout, js, tout, ts = run_dense(name, np.float32, options)
    assert tout[0].dtype == np.float32 and ts.success
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=F32_COST_REL)
    assert ts.final_cost < 0.1 * ts.initial_cost


def test_dense_rejects_inverse_depth():
    p, pts, cam_free, _, _ = kernel_problem("xyzw")
    args, kw = dense_args(p, pts, cam_free)
    options = _t_options(JOptions(track_parametrization_type=JTP.INVERSE_DEPTH))
    with pytest.raises(ValueError, match="INVERSE_DEPTH"):
        tds.bundle_adjust_dense(*(torch.as_tensor(a) for a in args), options=options, **kw)


def test_failed_factorization_rejects_the_step(monkeypatch):
    """A Cholesky that fails makes the step non-finite, so LM rejects it
    and raises the damping x4, as the JAX kernel does with its NaN step;
    nothing switches to another solver."""
    p, pts, cam_free, _, options = kernel_problem("xyzw")
    args, kw = dense_args(p, pts, cam_free)
    cholesky_ex = torch.linalg.cholesky_ex

    def failing(S):
        L, info = cholesky_ex(S)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    ext, _, out_pts, s = tds.bundle_adjust_dense(
        *(torch.as_tensor(a) for a in args),
        options=_t_options(dataclasses.replace(options, max_num_iterations=3)), **kw)
    assert s.num_iterations == 3 and s.final_cost == s.initial_cost and not s.converged
    assert s.final_mu == pytest.approx(1e-4 * 4 ** 3)
    np.testing.assert_array_equal(ext.numpy(), p["ext"])
    np.testing.assert_array_equal(out_pts.numpy(), pts)


def test_joint_covariance_matches_jax():
    p = _make_problem(np.random.default_rng(42), V=8, T=40, L=4)
    args, kw = dense_args(p, p["pts"], p["cam_free"])
    want = jds.joint_covariance_dense(*(jnp.asarray(a) for a in args), options=JOptions(), **kw)
    got = tds.joint_covariance_dense(*(torch.as_tensor(a) for a in args),
                                     options=_t_options(JOptions()), **kw)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=COV_REL * np.abs(w).max())
    assert float(got[3]) == 2 * int(p["mask"].sum())


def test_lm_decides_on_f64_costs():
    """In f32 the LM loop compares costs evaluated in f64 (an f32 cost
    carries rounding noise near the function tolerance): the summary's
    final cost is the f64 cost of the f32 state it returns."""
    from pytheiasfm_tpu_torch.ba.dense_schur import _Layout

    p, pts, cam_free, _, options = kernel_problem("xyzw")
    args, kw = dense_args(p, pts, cam_free, np.float32)
    targs = [torch.as_tensor(a) for a in args]
    ext, intr, out_pts, s = tds.bundle_adjust_dense(*targs, options=_t_options(options), **kw)
    assert ext.dtype == torch.float32 and s.success
    lay = _Layout(*targs[3:9], (0,), kw["num_views"], kw["num_tracks"], kw["max_track_len"],
                  _t_options(options), torch.float32)
    cost = lay.prob.cost(ext.double(), intr, out_pts.double())
    assert cost.dtype == torch.float64 and s.final_cost == float(cost)
