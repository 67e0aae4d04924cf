"""The port's flat implicit-PCG bundle adjustment (`pytheiasfm_tpu_torch/ba/lm.py`
`bundle_adjust`, `hessian_blocks`) against the JAX package's (`ba/lm.py`), on
the CPU.

Kernel inputs: `tests/test_dense_schur._make_problem(default_rng(42))` as a
flat observation table. Bars, f64: the same LM iteration count, initial and
final cost to 1e-8 relative, extrinsics, intrinsics and points to 1e-7
(absolute; values of order 1-10, focal length 800 relative). Cases: XYZW,
XYZW_MANIFOLD, INVERSE_DEPTH (reference view: a track's first slot), free
focal length + radial distortion, a per-DOF camera mask, a Huber loss and
priors. f32: the final cost to 1e-4 relative. `hessian_blocks`: to 1e-10
relative of the largest entry.

Entries, field by field at 1e-7 (f64), at the reference-default options
(free focal + radial intrinsics): INVERSE_DEPTH tracks on the
`random_reconstruction` scene of `test_torch_bundle_adjustment.py`, and a
scene with one track seen by all 8 views among 9000 tracks of 2, whose slot
padding (16384 x 8 slots) exceeds four times its observations, so that both
entries take the flat kernel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.ba import lm as jlm
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions
from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.models.intrinsics import OptimizeIntrinsicsType as JOI
from pytheiasfm_tpu.models.intrinsics import intrinsics_subset_mask as j_subset_mask
from pytheiasfm_tpu.utils import synthetic as jsyn
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba import entry as tentry
from pytheiasfm_tpu_torch.ba import lm as tlm
from pytheiasfm_tpu_torch.ops import rotation as rotops
from pytheiasfm_tpu_torch.utils import counters
from test_torch_bundle_adjustment import (
    COST_REL,
    F32_COST_REL,
    STATE_TOL,
    _entry_scene,
    _reference_default_options,
    _t_options,
)
from test_torch_dense_schur import kernel_problem
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

FOCAL_RADIAL = JOI.FOCAL_LENGTH | JOI.RADIAL_DISTORTION


def flat_case(name, dtype=np.float64):
    """(args, kwargs, priors, JAX options) of a named flat-kernel case."""
    base = "priors" if name == "priors" else "dof_mask" if name == "dof_mask" else (
        "huber" if name == "huber" else "manifold" if name == "manifold" else "xyzw")
    p, pts, cam_free, priors, options = kernel_problem(base)
    V, T = p["V"], p["T"]
    P = p["intr"].shape[1]
    intr, intr_free = p["intr"], np.zeros((1, P), bool)
    ref, bearing = np.zeros(T, np.int32), np.zeros((T, 3))
    if name == "invdepth":
        # Reference view: the first slot; bearing and depth of the current
        # point in it.
        ref = p["track_views"][:, 0].astype(np.int32)
        ext = torch.as_tensor(p["ext"][ref])
        p_ref = rotops.angle_axis_rotate_point(ext[:, 3:], torch.as_tensor(pts) - ext[:, :3])
        depth = torch.linalg.norm(p_ref, dim=-1, keepdim=True)
        bearing = (p_ref / depth).numpy()
        pts = (1.02 / depth).numpy()
        options = JOptions(max_num_iterations=30, track_parametrization_type=JTP.INVERSE_DEPTH)
    elif name == "focal_radial":
        intr = p["intr"].copy()
        intr[0, 0] *= 1.02
        intr_free = j_subset_mask(0, FOCAL_RADIAL)[None, :P]
        options = JOptions(max_num_iterations=40, intrinsics_to_optimize=FOCAL_RADIAL)
    args = [p["ext"], intr, pts, p["view_group"], p["group_model_idx"], p["obs_view"],
            p["obs_track"], p["uv"], p["info"], p["mask"], cam_free, p["pt_free"], intr_free,
            ref, bearing]
    args = [a.astype(dtype) if a.dtype == np.float64 else a for a in args]
    kw = dict(present_models=(0,), num_views=V, num_tracks=T, num_groups=1)
    if priors is not None:
        priors = tuple(np.asarray(a, dtype) for a in priors)
    return args, kw, priors, options


def run_flat(name, dtype=np.float64):
    args, kw, priors, options = flat_case(name, dtype)
    jout = jlm.bundle_adjust(*(jnp.asarray(a) for a in args), options=options,
                             priors=None if priors is None else tuple(map(jnp.asarray, priors)),
                             **kw)
    counters.reset()
    tout = tlm.bundle_adjust(*(torch.as_tensor(a) for a in args), options=_t_options(options),
                             priors=None if priors is None else tuple(map(torch.as_tensor, priors)),
                             **kw)
    assert counters.snapshot() == {"ba_launch": 1}
    return ([np.asarray(x) for x in jout[:3]], jout[3], [x.numpy() for x in tout[:3]],
            tout[3], args)


FLAT_CASES = ["xyzw", "manifold", "invdepth", "focal_radial", "dof_mask", "huber", "priors"]


@pytest.mark.parametrize("name", FLAT_CASES)
def test_flat_kernel_f64(name):
    jout, js, tout, ts, args = run_flat(name)
    assert ts.num_iterations == int(js.num_iterations) > 1
    assert ts.linear_solver == "flat" and ts.num_linear_solver_iterations >= ts.num_iterations
    assert ts.initial_cost == pytest.approx(float(js.initial_cost), rel=COST_REL)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.success and bool(js.success)
    assert ts.final_cost < 0.5 * ts.initial_cost
    assert ts.final_mu == pytest.approx(float(js.final_mu), rel=1e-6)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=0, atol=STATE_TOL * max(1.0, np.abs(want).max()))
    moved = np.abs(tout[1] - args[1]).max(axis=0) > 0
    if name == "focal_radial":
        assert moved[0] and moved[5] and not moved[1:5].any()
    else:
        assert not moved.any()


def test_flat_kernel_f32():
    jout, js, tout, ts, _ = run_flat("invdepth", np.float32)
    assert tout[0].dtype == np.float32 and ts.success
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=F32_COST_REL)


def test_hessian_blocks_match_jax():
    recon = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=3, pixel_noise=0.5)
    sel_v, sel_t = recon.view_estimated.copy(), recon.track_estimated.copy()
    prob = jentry._gather_problem(recon, sel_v, sel_t, np.float64)
    options = JOptions(loss_function_type=1, robust_loss_width=0.5)  # Huber
    args = [np.zeros((8, 6)), np.zeros((64, 3)), prob["intrinsics_rows"], prob["obs_view"],
            prob["obs_track"], prob["obs_uv"], prob["obs_sqrt_info"], prob["obs_mask"]]
    args[0][:6] = prob["extrinsics"]
    args[1][:40] = prob["points"]
    kw = dict(model=0, num_views=8, num_tracks=64)
    want = jlm.hessian_blocks(*(jnp.asarray(a) for a in args), options=options, **kw)
    got = tlm.hessian_blocks(*(torch.as_tensor(a) for a in args), options=_t_options(options),
                             **kw)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * max(1.0, np.abs(w).max()))


# ------------------------------------------------------------------ entries


def _assert_same_container(tr, jr, names=("view_extrinsics", "intrinsics", "points")):
    for name in names:
        want = getattr(jr, name)
        np.testing.assert_allclose(getattr(tr, name), want, rtol=0,
                                   atol=STATE_TOL * max(1.0, np.abs(want).max()), err_msg=name)


def long_track_scene():
    """8 views, track 0 seen by every view, 9000 tracks of 2 views, 0.3 px
    noise, the points perturbed by 0.02 (the same numpy draws for both
    packages)."""
    recon = jsyn.random_reconstruction(num_views=8, num_tracks=1, seed=3, pixel_noise=0.3)
    rng = np.random.default_rng(11)
    T = 9000
    pts = rng.uniform(-3, 3, (T, 3))
    va = rng.integers(0, 8, T)
    vb = (va + 1 + rng.integers(0, 6, T)) % 8
    first = recon.num_tracks()
    recon.add_tracks_bulk(T)
    ov = np.concatenate([va, vb])
    ot = np.tile(np.arange(first, first + T), 2)
    ext = recon.view_extrinsics[ov]
    R = rotops.angle_axis_to_rotation_matrix(torch.as_tensor(ext[:, 3:])).numpy()
    p_cam = np.einsum("oij,oj->oi", R, np.concatenate([pts, pts]) - ext[:, :3])
    q = recon.intrinsics[0]
    uv = q[0] * p_cam[:, :2] / p_cam[:, 2:] + q[3:5] + rng.normal(size=(2 * T, 2)) * 0.3
    recon.add_observations_bulk(ov.astype(np.int32), ot.astype(np.int32), uv)
    recon.points[first:, :3] = pts + rng.normal(size=(T, 3)) * 0.02
    recon.points[first:, 3] = 1.0
    recon.track_estimated[first:] = True
    recon.view_extrinsics[2:] += rng.normal(size=(6, 6)) * 0.002
    return recon


class KernelRecorder:
    """Records which kernel an entry calls (wraps the entry module's three
    kernel names)."""

    NAMES = {"bundle_adjust_dense": "dense", "bundle_adjust_iterative": "iterative",
             "bundle_adjust": "flat"}

    def __init__(self, monkeypatch, module):
        self.calls = []
        for name, label in self.NAMES.items():
            fn = getattr(module, name)

            def wrapped(*a, _fn=fn, _label=label, **k):
                self.calls.append(_label)
                return _fn(*a, **k)

            monkeypatch.setattr(module, name, wrapped)


def entry_both(monkeypatch, jr, fn, jopt, topt, *args, dtype=np.float64):
    """The same entry in both packages on copies of `jr`: (JAX container,
    JAX summary, port container, port summary, JAX kernels called)."""
    tr = convert.reconstruction(jr)
    rec = KernelRecorder(monkeypatch, jentry)
    js = getattr(jentry, fn)(jopt, *args, jr, dtype=dtype)
    ts = getattr(tentry, fn)(topt, *args, tr, dtype=dtype, device="cpu")
    return jr, js, tr, ts, rec.calls


def test_inverse_depth_entry_f64(monkeypatch):
    jopt, topt = _reference_default_options()
    jopt = dataclasses.replace(jopt, track_parametrization_type=JTP.INVERSE_DEPTH)
    topt = dataclasses.replace(topt, track_parametrization_type=(
        tlm.TrackParametrizationType.INVERSE_DEPTH))
    jr, js, tr, ts, calls = entry_both(monkeypatch, _entry_scene(True),
                                       "bundle_adjust_reconstruction", jopt, topt)
    assert calls == ["flat"] and ts.linear_solver == "flat"
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.final_cost < 0.5 * ts.initial_cost
    _assert_same_container(tr, jr)
    np.testing.assert_allclose(tr.track_inverse_depth, jr.track_inverse_depth, rtol=1e-7, atol=0)
    assert (tr.track_inverse_depth[tr.track_estimated] > 0).all()


def test_long_track_takes_the_flat_kernel(monkeypatch):
    jopt, topt = _reference_default_options()
    jr, js, tr, ts, calls = entry_both(monkeypatch, long_track_scene(),
                                       "bundle_adjust_reconstruction", jopt, topt)
    assert calls == ["flat"] and ts.linear_solver == "flat"
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.final_cost < 0.1 * ts.initial_cost
    _assert_same_container(tr, jr)
