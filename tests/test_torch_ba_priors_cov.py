"""View priors and covariance in the port's bundle adjustment against the JAX
package's, on the CPU.

Scenes: `random_reconstruction` (6 views, 40 tracks, 0.5 px noise), the
scenes of `tests/test_ba_priors_cov.py`, with perturbed camera positions.
Priors: position, orientation and gravity priors on every view but one,
through each of the three kernels the entry dispatches to (dense Schur:
the calibrated defaults; iterative Schur: forced by `linear_solver_type`;
flat: INVERSE_DEPTH tracks), the kernel checked in both packages, the
container field by field at 1e-7 (f64). Covariance: the `*_with_cov`
entries and `compute_reconstruction_covariance` (the exact dense inverse
and the selected-block PCG), each block and the variance factor at 1e-8
relative of the largest entry.
"""

import dataclasses

import numpy as np
import pytest

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions
from pytheiasfm_tpu.ba.lm import LinearSolverType as JLS
from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.utils import synthetic as jsyn
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba import entry as tentry
from pytheiasfm_tpu_torch.ops import rotation as rotops
from test_torch_bundle_adjustment import COST_REL, _t_options
from test_torch_flat_ba import _assert_same_container, entry_both
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

COV_REL = 1e-8


def prior_scene(seed=71):
    """`random_reconstruction` with its positions perturbed by 0.05 and
    priors on every view but view 2: positions at ground truth, orientations
    and gravity near it."""
    import torch

    rng = np.random.default_rng(seed)
    recon = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=seed, pixel_noise=0.5)
    gt = recon.view_extrinsics.copy()
    recon.view_extrinsics[:, :3] += rng.normal(size=(6, 3)) * 0.05
    R = rotops.angle_axis_to_rotation_matrix(torch.as_tensor(gt[:, 3:])).numpy()
    for v in range(6):
        if v == 2:
            continue
        vp = recon.view_priors[v]
        vp.position = gt[v, :3]
        vp.position_sqrt_information = np.eye(3) * 1e3
        vp.orientation = gt[v, 3:] + rng.normal(size=3) * 0.002
        vp.orientation_sqrt_information = np.eye(3) * 100.0
        vp.gravity = -R[v, :, 2] + rng.normal(size=3) * 0.002
        vp.gravity_sqrt_information = None if v == 3 else np.eye(3) * 50.0
    return recon, gt


PRIOR_ROUTES = {
    "dense": {},
    "iterative": dict(linear_solver_type=JLS.ITERATIVE_SCHUR),
    "flat": dict(track_parametrization_type=JTP.INVERSE_DEPTH),
}


@pytest.mark.parametrize("route", list(PRIOR_ROUTES))
def test_priors_through_each_kernel(monkeypatch, route):
    jopt = JOptions(use_position_priors=True, use_orientation_priors=True,
                    use_gravity_priors=True, **PRIOR_ROUTES[route])
    recon, gt = prior_scene()
    jr, js, tr, ts, calls = entry_both(monkeypatch, recon, "bundle_adjust_reconstruction",
                                       jopt, _t_options(jopt))
    assert calls == [route] and ts.linear_solver == route
    assert ts.success and ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    _assert_same_container(tr, jr, ("view_extrinsics", "points"))
    # The strong position priors pull the perturbed views back (view 2 has
    # none).
    pulled = [0, 1, 3, 4, 5]
    assert np.abs(tr.view_extrinsics[pulled, :3] - gt[pulled, :3]).max() < 5e-3


def test_priors_off_leave_the_problem_alone(monkeypatch):
    """Priors set on the views but not asked for change nothing."""
    recon, _ = prior_scene()
    plain = convert.reconstruction(recon)
    for v in range(6):
        plain.view_priors[v] = dataclasses.replace(plain.view_priors[v], position=None,
                                                   orientation=None, gravity=None)
    with_priors = convert.reconstruction(recon)
    topt = _t_options(JOptions())
    sa = tentry.bundle_adjust_reconstruction(topt, plain, np.float64, device="cpu")
    sb = tentry.bundle_adjust_reconstruction(topt, with_priors, np.float64, device="cpu")
    assert sa == sb
    np.testing.assert_array_equal(plain.view_extrinsics, with_priors.view_extrinsics)


def _assert_blocks(got, want):
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=COV_REL * scale, err_msg=k)


@pytest.mark.parametrize("fn,ids", [("bundle_adjust_views_with_cov", [1, 4]),
                                    ("bundle_adjust_tracks_with_cov", [0, 1, 2])])
def test_with_cov_entries(fn, ids):
    recon = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=73, pixel_noise=0.5)
    tr = convert.reconstruction(recon)
    jopt = JOptions()
    js, jcov, jvf = getattr(jentry, fn)(jopt, ids, recon, np.float64)
    ts, tcov, tvf = getattr(tentry, fn)(_t_options(jopt), ids, tr, np.float64, device="cpu")
    assert ts.num_iterations == int(js.num_iterations)
    assert tvf == pytest.approx(jvf, rel=COV_REL) and tvf > 0
    _assert_blocks(tcov, jcov)
    for c in tcov.values():
        assert np.linalg.eigvalsh(c).min() > 0
    one = fn.replace("views", "view").replace("tracks", "track")
    s1, c1, vf1 = getattr(tentry, one)(_t_options(jopt), ids[0], convert.reconstruction(recon),
                                        np.float64, device="cpu")
    assert c1.shape == tcov[ids[0]].shape and vf1 > 0


@pytest.fixture(scope="module")
def solved_scene():
    recon = jsyn.random_reconstruction(num_views=6, num_tracks=40, seed=74, pixel_noise=0.5)
    jentry.bundle_adjust_reconstruction(JOptions(), recon, np.float64)
    return recon


@pytest.mark.parametrize("selected", [False, True])
def test_reconstruction_covariance(solved_scene, selected):
    kw = dict(view_ids=[2, 5], track_ids=[0, 7, 11]) if selected else {}
    want = jentry.compute_reconstruction_covariance(JOptions(), solved_scene,
                                                    constant_views=(0, 1), **kw)
    got = tentry.compute_reconstruction_covariance(
        _t_options(JOptions()), convert.reconstruction(solved_scene), constant_views=(0, 1),
        device="cpu", **kw)
    assert got[2] == pytest.approx(want[2], rel=COV_REL) and got[2] > 0
    _assert_blocks(got[0], want[0])
    _assert_blocks(got[1], want[1])
    if selected:
        assert set(got[0]) == {2, 5} and set(got[1]) == {0, 7, 11}
    else:
        assert len(got[0]) == 4 and len(got[1]) == solved_scene.track_estimated.sum()


def test_selected_covariance_agrees_with_the_dense_inverse(solved_scene):
    """The port's two covariance paths agree (the JAX test's check, at
    1e-8 in place of its 1e-3)."""
    topt = _t_options(JOptions())
    tr = convert.reconstruction(solved_scene)
    dense = tentry.compute_reconstruction_covariance(topt, tr, constant_views=(0, 1),
                                                     device="cpu")
    sel = tentry.compute_reconstruction_covariance(topt, tr, constant_views=(0, 1),
                                                   view_ids=[3], track_ids=[4], device="cpu")
    assert sel[2] == pytest.approx(dense[2], rel=COV_REL)
    _assert_blocks(sel[0], {3: dense[0][3]})
    _assert_blocks(sel[1], {4: dense[1][4]})

