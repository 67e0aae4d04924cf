"""The port's bundle adjustment (`pytheiasfm_tpu_torch/ba/`) against the JAX
package's (`ba/iterative_schur.py`, `ba/entry.py`), on the CPU.

Kernel inputs: `tests/test_dense_schur._make_problem` (8 views, 60 tracks of
4 views, 0.5 px noise, 2% perturbation, two views frozen), in the layouts
of each package's own `_slot_layout` / `_rowchunk_layout` (held equal).
Bars, f64 with the JAX tests' options: the same LM iteration count; initial
and final cost to 1e-8 relative; extrinsics, intrinsics and points to 1e-7
(absolute; values of order 1-10, focal length 800 relative). One f32 case
at the defaults: final cost to 1e-4 relative. Mixed precision (bf16 matvec
operands): final cost to 1e-4 relative.

Entries: `random_reconstruction` (8 views, 150 tracks, 0.3 px noise) with
perturbed views, points and focal lengths, at the reference-default BA
options (XYZW_MANIFOLD, free focal + radial): one intrinsics group per view
(joint intrinsics in PCG) and all views in one group (exact elimination).
The container after the call agrees field by field to 1e-7 (f64) and the
final cost to 1e-4 relative (f32, the default dtype).

The two-level coarse preconditioner (1024 views, as
`tests/test_iterative_schur.py`'s coarse case, f64): its matrix equals the
exact coarse Schur complement; the first step agrees to 1e-8 and the third
to 1e-5 relative; after 25 steps (`slow`) the final cost agrees to 1e-5
relative, and a 1e-15 change of the input moves it by less than 1e-10. The
gaps are the JAX kernel's closed-form inverse of the Schur-Jacobi blocks,
which on this scene's near-singular blocks errs by up to 1.8e-4 of the
preconditioned residual; the port inverts them by pivoted LU
(`tests/torch_ba_rounding_study.py` shows both). The same problem with the
slot threshold lowered so that the coarse level is built from every 4th
track: its matrix against the stride-1 build of the kept tracks scaled by
4, the first step's cost to 1e-8, and after 25 steps the port's cost at or
below the JAX kernel's and within 2e-3 of it (there the JAX kernel's path
is chaotic under 1e-15 changes of its input; the port's is not).
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.ba import iterative_schur as jis
from pytheiasfm_tpu.ba import lm as jlm
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions
from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.models.intrinsics import OptimizeIntrinsicsType as JOI
from pytheiasfm_tpu.models.intrinsics import intrinsics_subset_mask as j_subset_mask
from pytheiasfm_tpu.sfm.estimator_options import ReconstructionEstimatorOptions as JREO
from pytheiasfm_tpu.sfm.estimator_options import set_bundle_adjustment_options as j_set_ba
from pytheiasfm_tpu.utils.synthetic import random_reconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba import entry as tentry
from pytheiasfm_tpu_torch.ba import iterative_schur as tis
from pytheiasfm_tpu_torch.ba import lm as tlm
from pytheiasfm_tpu_torch.models.intrinsics import OptimizeIntrinsicsType as TOI
from pytheiasfm_tpu_torch.models.intrinsics import intrinsics_subset_mask as t_subset_mask
from pytheiasfm_tpu_torch.sfm.estimator_options import ReconstructionEstimatorOptions as TREO
from pytheiasfm_tpu_torch.sfm.estimator_options import set_bundle_adjustment_options as t_set_ba
from pytheiasfm_tpu_torch.utils import counters
from test_dense_schur import _make_problem
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

COST_REL = 1e-8
STATE_TOL = 1e-7
F32_COST_REL = 1e-4
FOCAL_RADIAL = JOI.FOCAL_LENGTH | JOI.RADIAL_DISTORTION


def _t_options(jopt):
    """The port's options with the same field values as the JAX ones."""
    fields = {f.name: getattr(jopt, f.name) for f in dataclasses.fields(jopt)}
    fields["intrinsics_to_optimize"] = TOI(int(fields["intrinsics_to_optimize"]))
    fields["track_parametrization_type"] = tlm.TrackParametrizationType(
        int(fields["track_parametrization_type"]))
    fields["linear_solver_type"] = tlm.LinearSolverType(int(fields["linear_solver_type"]))
    return tlm.BundleAdjustmentOptions(**fields)


def _kernel_inputs(p, intr=None, view_group=None, intr_free=None, pts=None):
    V, T, L = p["V"], p["T"], p["L"]
    slot = dict(track_views=p["track_views"], mask=p["mask"].reshape(T, L))
    rc = jentry._rowchunk_layout(slot, V)
    intr = p["intr"] if intr is None else intr
    G = intr.shape[0]
    args = [
        p["ext"], intr, p["pts"] if pts is None else pts,
        p["view_group"] if view_group is None else view_group, np.zeros(G, np.int32),
        p["track_views"], p["uv"].reshape(T, L, 2), p["info"].reshape(T, L, 2),
        p["mask"].reshape(T, L), rc["row_view"], rc["rc_src"], rc["rc_mask"],
        p["cam_free"], p["pt_free"],
        np.zeros((G, intr.shape[1]), bool) if intr_free is None else intr_free,
    ]
    kw = dict(present_models=(0,), num_views=V, num_tracks=T, max_track_len=L,
              num_rows=rc["R"], row_chunk=rc["C"], num_groups=G)
    return args, kw


def _run_kernels(args, kw, jopt, dtype=np.float64):
    args = [a.astype(dtype) if a.dtype == np.float64 else a for a in args]
    je, jq, jp, js = jis.bundle_adjust_iterative(*(jnp.asarray(a) for a in args), options=jopt,
                                                 **kw)
    counters.reset()
    te, tq, tp, ts = tis.bundle_adjust_iterative(*(torch.as_tensor(a) for a in args),
                                                 options=_t_options(jopt), **kw)
    assert counters.snapshot() == {"ba_launch": 1}
    jout = [np.asarray(x) for x in (je, jq, jp)]
    return jout, js, [x.numpy() for x in (te, tq, tp)], ts


def _case(name):
    p = _make_problem(np.random.default_rng(42))
    P = p["intr"].shape[1]
    if name == "xyzw":
        return _kernel_inputs(p), JOptions(max_num_iterations=30)
    if name == "manifold_focal_radial":
        pts4 = np.concatenate([p["pts"], np.ones((p["T"], 1))], 1)
        pts4 /= np.linalg.norm(pts4, axis=1, keepdims=True)
        intr = p["intr"].copy()
        intr[0, 0] *= 1.02
        free = j_subset_mask(0, FOCAL_RADIAL)[None, :P]
        return _kernel_inputs(p, intr=intr, intr_free=free, pts=pts4), JOptions(
            max_num_iterations=40, intrinsics_to_optimize=FOCAL_RADIAL,
            track_parametrization_type=JTP.XYZW_MANIFOLD)
    if name == "joint_groups":
        vg = np.zeros(p["V"], np.int32)
        vg[p["V"] // 2:] = 1
        intr = np.concatenate([p["intr"], p["intr"]])
        intr[1, 0] *= 1.01
        free = np.repeat(j_subset_mask(0, JOI.FOCAL_LENGTH)[None, :P], 2, 0)
        return _kernel_inputs(p, intr=intr, view_group=vg, intr_free=free), JOptions(
            max_num_iterations=40, intrinsics_to_optimize=JOI.FOCAL_LENGTH)
    if name == "mixed_precision":
        return _kernel_inputs(p), JOptions(max_num_iterations=30,
                                           use_mixed_precision_solves=True)
    raise KeyError(name)


KERNEL_CASES = ["xyzw", "manifold_focal_radial", "joint_groups"]


@pytest.fixture(scope="module", params=KERNEL_CASES)
def kernel_f64(request):
    (args, kw), jopt = _case(request.param)
    return request.param, _run_kernels(args, kw, jopt)


def test_iterative_kernel_f64(kernel_f64):
    name, (jout, js, tout, ts) = kernel_f64
    assert ts.num_iterations == int(js.num_iterations) > 1
    assert ts.initial_cost == pytest.approx(float(js.initial_cost), rel=COST_REL)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.success and bool(js.success)
    assert ts.final_mu == pytest.approx(float(js.final_mu), rel=1e-6)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=0, atol=STATE_TOL * max(1.0, np.abs(want).max()))


def test_iterative_kernel_moves_the_free_intrinsics(kernel_f64):
    name, (jout, _, tout, _) = kernel_f64
    p = _make_problem(np.random.default_rng(42))
    if name == "xyzw":
        np.testing.assert_array_equal(tout[1], p["intr"])
    else:
        moved = np.abs(tout[1] - _case(name)[0][0][1]).max(axis=0) > 0
        assert moved[0] and not moved[3:5].any()  # focal moves, principal point does not


@pytest.mark.parametrize("name", ["xyzw", "mixed_precision"])
def test_iterative_kernel_f32_and_mixed_precision(name):
    (args, kw), jopt = _case(name)
    jout, js, tout, ts = _run_kernels(args, kw, jopt, dtype=np.float32)
    assert tout[0].dtype == np.float32
    assert ts.success
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=F32_COST_REL)
    assert ts.final_cost < 0.01 * ts.initial_cost


def test_layouts_match(kernel_f64):
    """`_gather_problem`, `_slot_layout` and `_rowchunk_layout` give equal
    arrays in both packages on an entry problem."""
    jr = _entry_scene(shared_group=False)
    tr = convert.reconstruction(jr)
    sel_v, sel_t = jr.view_estimated.copy(), jr.track_estimated.copy()
    jp = jentry._gather_problem(jr, sel_v, sel_t, np.float64)
    tp = tentry._gather_problem(tr, sel_v, sel_t, np.float64)
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    Tp = jentry._pad_soft(jr.num_tracks(), 64, 16384, 8192)
    js, ts = jentry._slot_layout(jp, Tp, np.float64), tentry._slot_layout(tp, Tp, np.float64)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    jrc, trc = jentry._rowchunk_layout(js, 64), tentry._rowchunk_layout(ts, 64)
    for k in jrc:
        np.testing.assert_array_equal(trc[k], jrc[k])
    aa = np.random.default_rng(3).normal(size=(20, 3))
    aa[0] = 0.0
    pts = np.random.default_rng(4).normal(size=(20, 3))
    np.testing.assert_allclose(tentry._rodrigues_np(aa, pts), jentry._rodrigues_np(aa, pts),
                               rtol=0, atol=1e-14)
    for n in (1, 5, 17, 300, 70000, 200000):
        assert tentry._pad_pow2(n) == jentry._pad_pow2(n)
        assert tentry._pad_bucket(n) == jentry._pad_bucket(n)
        assert tentry._pad_soft(n, 8, 512, 256) == jentry._pad_soft(n, 8, 512, 256)


# ------------------------------------------------------------------ entries


def _entry_scene(shared_group):
    recon = random_reconstruction(num_views=8, num_tracks=150, seed=5, pixel_noise=0.3)
    rng = np.random.default_rng(9)
    recon.view_extrinsics[1:, :3] += rng.normal(size=(7, 3)) * 0.02
    recon.view_extrinsics[1:, 3:] += rng.normal(size=(7, 3)) * 0.002
    recon.points[:, :3] += rng.normal(size=(150, 3)) * 0.02
    recon.intrinsics[:, 0] *= 1.0 + rng.normal(size=len(recon.intrinsics)) * 0.01
    if shared_group:
        recon.view_group[:] = 0
    return recon


def _reference_default_options():
    return j_set_ba(JREO(), 8), t_set_ba(TREO(), 8)


def _entry_both(fn, shared_group, dtype, *args):
    jr = _entry_scene(shared_group)
    tr = convert.reconstruction(jr)
    jopt, topt = _reference_default_options()
    js = getattr(jentry, fn)(jopt, *args, jr, dtype=dtype)
    ts = getattr(tentry, fn)(topt, *args, tr, dtype=dtype, device="cpu")
    return jr, js, tr, ts


PARTIAL = (list(range(2, 8)), list(range(0, 150, 2)))


@pytest.mark.parametrize("shared_group", [False, True])
@pytest.mark.parametrize("fn", ["bundle_adjust_reconstruction",
                                "bundle_adjust_partial_reconstruction"])
def test_entry_f64_field_by_field(fn, shared_group):
    args = PARTIAL if fn == "bundle_adjust_partial_reconstruction" else ()
    jr, js, tr, ts = _entry_both(fn, shared_group, np.float64, *args)
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    # The partial call keeps the perturbed odd tracks where they are.
    assert ts.final_cost < (0.2 if args else 0.02) * ts.initial_cost
    for name in ("view_extrinsics", "intrinsics", "points"):
        want = getattr(jr, name)
        np.testing.assert_allclose(getattr(tr, name), want, rtol=0,
                                   atol=STATE_TOL * max(1.0, np.abs(want).max()), err_msg=name)
    for name in ("view_estimated", "track_estimated", "view_group"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))
    if fn == "bundle_adjust_partial_reconstruction":
        fixed = _entry_scene(shared_group)
        np.testing.assert_array_equal(tr.view_extrinsics[:2], fixed.view_extrinsics[:2])
        np.testing.assert_array_equal(tr.points[1::2], fixed.points[1::2])


def test_entry_f32_defaults():
    """In f32 the JAX package's LM stop falls on rounding noise: near the
    optimum a proposal predicts a decrease of 4e-8 of the cost, under
    f32's resolution, and its measured change is noise of 2e-6 to 1.5e-5
    relative. The function-tolerance stop (1e-6) fires the first time the
    noise falls under it: here after 7 iterations, over eight scene seeds
    after 6-19. The port decides on f64 costs (`lm.run_lm`) and stops here
    after 5. So the iteration counts are not held; the final cost is, to
    1e-4 relative (measured 4.3e-7)."""
    jr, js, tr, ts = _entry_both("bundle_adjust_reconstruction", True, np.float32)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=F32_COST_REL)
    np.testing.assert_allclose(tr.view_extrinsics, jr.view_extrinsics, rtol=0, atol=1e-3)


def test_view_and_track_entries():
    jopt, topt = _reference_default_options()
    for fn, arg in (("bundle_adjust_views", [3, 4]), ("bundle_adjust_tracks", [1, 2, 3])):
        jr = _entry_scene(True)
        tr = convert.reconstruction(jr)
        js = getattr(jentry, fn)(jopt, arg, jr, np.float64)
        ts = getattr(tentry, fn)(topt, arg, tr, np.float64, device="cpu")
        assert ts.num_iterations == int(js.num_iterations), fn
        assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL), fn
        np.testing.assert_allclose(tr.view_extrinsics, jr.view_extrinsics, rtol=0, atol=1e-7)
        np.testing.assert_allclose(tr.points, jr.points, rtol=0, atol=1e-7)
    # The one-view and one-track entries are the plural ones on one id.
    for one, many, arg in (("bundle_adjust_view", "bundle_adjust_views", 6),
                           ("bundle_adjust_track", "bundle_adjust_tracks", 9)):
        a, b = (convert.reconstruction(_entry_scene(True)) for _ in range(2))
        sa = getattr(tentry, one)(topt, arg, a, np.float64, device="cpu")
        sb = getattr(tentry, many)(topt, [arg], b, np.float64, device="cpu")
        assert sa == sb
        np.testing.assert_array_equal(a.view_extrinsics, b.view_extrinsics)
        np.testing.assert_array_equal(a.points, b.points)


def test_what_is_not_ported_raises():
    """Nothing raises any more: a device mesh runs (a 1-rank mesh here, the
    solve on one device's trajectory; 4 ranks in `test_torch_mesh_sfm.py`),
    and so do the dense Schur, the flat kernel, the priors and the
    covariance (`test_dispatch_matches_jax`, `test_torch_dense_schur.py`,
    `test_torch_flat_ba.py`, `test_torch_ba_priors_cov.py`)."""
    from torch_mesh_cases import one_rank_mesh

    tr = convert.reconstruction(_entry_scene(True))
    _, topt = _reference_default_options()
    on_mesh = copy.deepcopy(tr)
    with one_rank_mesh() as mesh:
        s_mesh = tentry.bundle_adjust_reconstruction(dataclasses.replace(topt, mesh=mesh),
                                                     on_mesh, dtype=np.float64, device="cpu")
    s_one = tentry.bundle_adjust_reconstruction(topt, tr, dtype=np.float64, device="cpu")
    assert s_mesh.linear_solver == s_one.linear_solver == "iterative"
    assert s_mesh.num_iterations == s_one.num_iterations
    np.testing.assert_allclose(on_mesh.view_extrinsics, tr.view_extrinsics, rtol=0, atol=1e-12)
    np.testing.assert_allclose(on_mesh.points, tr.points, rtol=0, atol=1e-12)
    summary, covariances, vf = tentry.bundle_adjust_views_with_cov(topt, [1], tr,
                                                                    device="cpu")
    assert summary.success and covariances[1].shape == (6, 6) and vf > 0


@pytest.mark.parametrize("route", ["dense", "iterative", "flat", "forced_iterative"])
def test_dispatch_matches_jax(monkeypatch, route):
    """The entry sends each problem to the JAX entry's kernel: calibrated
    (frozen intrinsics, <= 1024 padded views) to the dense Schur; free
    intrinsics, or a forced ITERATIVE_SCHUR, to the iterative Schur;
    INVERSE_DEPTH tracks to the flat kernel (for a problem without a usable
    slot layout, `test_torch_flat_ba.test_long_track_takes_the_flat_kernel`).
    The container agrees field by field at 1e-7 (f64)."""
    from test_torch_flat_ba import _assert_same_container, entry_both

    jopt, topt = _reference_default_options()
    calibrated = dict(intrinsics_to_optimize=JOI.NONE, track_parametrization_type=JTP.XYZW)
    changes = {
        "dense": calibrated,
        "iterative": {},
        "flat": dict(track_parametrization_type=JTP.INVERSE_DEPTH),
        "forced_iterative": dict(calibrated, linear_solver_type=jlm.LinearSolverType.ITERATIVE_SCHUR),
    }[route]
    jopt = dataclasses.replace(jopt, **changes)
    jr, js, tr, ts, calls = entry_both(monkeypatch, _entry_scene(True),
                                       "bundle_adjust_reconstruction", jopt, _t_options(jopt))
    want = "iterative" if route == "forced_iterative" else route
    assert calls == [want] and ts.linear_solver == want
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    _assert_same_container(tr, jr)


@pytest.fixture(scope="module")
def coarse_problem():
    p = _make_problem(np.random.default_rng(42), V=1024, T=1500, L=4, noise=0.3, perturb=0.005)
    return _kernel_inputs(p)


def test_coarse_preconditioner_is_the_exact_coarse_schur(coarse_problem, monkeypatch):
    """V = 1024 switches the two-level preconditioner on (the JAX kernel's
    gate, aggregates of 16 views). Its matrix, Cholesky-factored, equals
    R^T S~ R applied column by column through the PCG operator, plus the
    exact extras (damping, the frozen cameras' identity, the ridges)."""
    args, kw = coarse_problem
    opt = _t_options(JOptions(max_num_iterations=1))
    seen = {}
    factor = tis._Problem._coarse_factor

    def keep_factor(self, *a):
        seen["prob"], seen["chol"] = self, factor(self, *a)
        return seen["chol"]

    def keep_operator(S_mv, precond, g, options, comm=None):
        seen["S_mv"] = S_mv
        raise StopIteration

    monkeypatch.setattr(tis._Problem, "_coarse_factor", keep_factor)
    monkeypatch.setattr(tis, "_pcg", keep_operator)
    with pytest.raises(StopIteration):
        tis.bundle_adjust_iterative(*(torch.as_tensor(a) for a in args), options=opt, **kw)
    prob = seen["prob"]
    assert prob.use_coarse and prob.group == 16 and prob.Vc == 64
    Vc, cov = prob.Vc, prob.coarse_of_view
    RSR = torch.zeros(6 * Vc, 6 * Vc, dtype=torch.float64)
    for c in range(Vc):
        for i in range(6):
            x = torch.zeros(prob.V, 6, dtype=torch.float64)
            x[cov == c, i] = 1.0
            RSR[:, 6 * c + i] = prob.views_to_coarse(seen["S_mv"]((x,))[0]).reshape(-1)
    frozen = torch.zeros(6 * Vc, dtype=torch.float64)
    frozen[:6] = 2.0  # views 0 and 1, in aggregate 0, are frozen
    want = RSR + torch.diag(frozen) + 1e-7 * torch.eye(6 * Vc, dtype=torch.float64)
    got = seen["chol"] @ seen["chol"].T
    assert float((got - want).abs().max()) < 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("iterations,rel", [(1, COST_REL), (3, 1e-5)])
def test_coarse_preconditioner_steps_match_jax(coarse_problem, iterations, rel):
    """The first LM steps through the coarse level agree with the JAX
    kernel's: 1e-8 after one step and 1e-5 after three (measured 5.7e-10 and
    8.0e-7). The steps part by the error of the JAX kernel's closed-form
    inverse of the Schur-Jacobi blocks (see below), which grows as the
    damping falls."""
    args, kw = coarse_problem
    jout, js, tout, ts = _run_kernels(
        args, kw, JOptions(max_num_iterations=iterations, function_tolerance=0.0))
    assert ts.num_iterations == int(js.num_iterations) == iterations
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=rel)
    np.testing.assert_allclose(tout[0], jout[0], rtol=0, atol=1e-5)


@pytest.mark.slow
def test_coarse_preconditioner_reaches_the_jax_basin(coarse_problem):
    """The JAX test's own run (25 iterations, function tolerance 0). At
    mu ~ 1e-6 some Schur-Jacobi blocks have condition numbers near 1e9, and
    the JAX kernel's closed-form inverse errs on them by up to 1.8e-4 of
    the preconditioned residual: a 1e-15 change of its input moves its
    25-step cost over 70.0485-70.0489. The port's pivoted LU does not amplify rounding so.
    Held: the final cost within 1e-5 of the JAX kernel's (measured 3.9e-6),
    and the port's cost moved by less than 1e-10 relative by a 1e-15
    relative change of the points (measured 1e-14). `slow`: about 30 s on
    one CPU thread, most of it the 25 steps of both packages."""
    args, kw = coarse_problem
    options = JOptions(max_num_iterations=25, function_tolerance=0.0)
    jout, js, tout, ts = _run_kernels(args, kw, options)
    assert ts.success and ts.num_iterations == int(js.num_iterations) == 25
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=1e-5)
    moved = list(args)
    moved[2] = args[2] * (1 + 1e-15 * np.random.default_rng(0).normal(size=args[2].shape))
    *_, moved_summary = tis.bundle_adjust_iterative(
        *(torch.as_tensor(a) for a in moved), options=_t_options(options), **kw)
    assert moved_summary.final_cost == pytest.approx(ts.final_cost, rel=1e-10)


def test_coarse_preconditioner_every_4th_track_matches_jax(coarse_problem, monkeypatch):
    """Past `_SCAN_SLOT_THRESHOLD` slots (1.1M) both kernels build the coarse
    level from every 4th track, scaled by 4. With the threshold set to 1000
    in both modules the 1024-view problem (6,000 slots) takes that path.
    Held: the port's coarse matrix equals the one built at stride 1 from the
    same linearization with the other tracks' blocks zeroed and the kept
    ones' scaled by 4 (1e-12 of its largest entry); the first LM step's
    cost agrees with the JAX kernel's to 1e-8 (measured 2.1e-9).

    From the third step on, the JAX kernel's path is chaotic on this
    subsampled level: a 1e-15 relative change of the points moves its
    3-step cost over 76.352-76.506 and its 25-step cost over 70.061-70.125
    (its closed-form Schur-Jacobi inverse; ROADMAP.md section 3), while the
    port's pivoted LU moves its own by under 1e-10. So after 25 steps the
    port's cost is held at or below the JAX kernel's and within 2e-3 of it
    (measured 70.0482 against 70.1110), and the port's 3-step cost within
    1e-8 of itself under that change."""
    import jax

    monkeypatch.setattr(tis, "_SCAN_SLOT_THRESHOLD", 1000)
    monkeypatch.setattr(jis, "_SCAN_SLOT_THRESHOLD", 1000)
    jax.clear_caches()  # the JAX kernel reads the threshold when it traces
    try:
        args, kw = coarse_problem
        seen = []
        factor = tis._Problem._coarse_factor

        def keep_factor(self, W, Y, U_slot, extras_v, elim):
            chol = factor(self, W, Y, U_slot, extras_v, elim)
            if not seen:
                seen.append((self, W, Y, U_slot, extras_v, elim, chol))
            return chol

        monkeypatch.setattr(tis._Problem, "_coarse_factor", keep_factor)
        _, js, _, ts = _run_kernels(args, kw, JOptions(max_num_iterations=1,
                                                       function_tolerance=0.0))
        assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
        prob, W, Y, U_slot, extras_v, elim, chol = seen[0]
        assert prob.use_coarse and prob.coarse_stride == 4 and prob.T * prob.L == 6000
        kept = (torch.arange(prob.T) % 4 == 0).to(W.dtype)[:, None, None, None]
        prob.coarse_stride = 1
        want = factor(prob, W, 4.0 * kept * Y, 4.0 * kept * U_slot, extras_v, elim)
        got, want = chol @ chol.T, want @ want.T
        assert float((got - want).abs().max()) < 1e-12 * float(want.abs().max())

        _, js, _, ts = _run_kernels(args, kw, JOptions(max_num_iterations=25,
                                                       function_tolerance=0.0))
        assert ts.success and ts.num_iterations == int(js.num_iterations) == 25
        assert ts.final_cost <= float(js.final_cost) * (1 + 1e-9)
        assert ts.final_cost == pytest.approx(float(js.final_cost), rel=2e-3)

        three = _t_options(JOptions(max_num_iterations=3, function_tolerance=0.0))
        moved = list(args)
        moved[2] = args[2] * (1 + 1e-15 * np.random.default_rng(0).normal(size=args[2].shape))
        costs = [tis.bundle_adjust_iterative(*(torch.as_tensor(a) for a in x), options=three,
                                             **kw)[-1].final_cost for x in (args, moved)]
        assert costs[1] == pytest.approx(costs[0], rel=1e-8)
    finally:
        jax.clear_caches()


def test_coarse_gate_uses_the_padded_view_count():
    """553 views pad to 768 (no coarse level); 1000 pad to 1024 (coarse)."""
    assert tentry._pad_soft(553, 8, 512, 256) == 768
    assert tentry._pad_soft(1000, 8, 512, 256) == 1024
