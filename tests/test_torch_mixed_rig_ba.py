"""Bundle adjustment over several camera models in one problem (a mixed rig),
the port against the JAX package, on the CPU, in f64.

The scene is the JAX test's `test_ba_mixed_camera_models`
(`tests/test_ba_advanced.py`): a PINHOLE `random_reconstruction` (4 views,
60 tracks, seed 1) with a DIVISION_UNDISTORTION one (4 views, 60 tracks,
seed 2), both with 0.3 px of pixel noise, grafted in as a second
intrinsics group, views and points perturbed by the same numpy draws for
both packages, two gauge views a group held. The rows of each model are projected by that model only
(`ba/lm._pixel_of`), through each kernel that the entry dispatches to: the
dense Schur (frozen intrinsics), the iterative Schur (free focal and
radial: joint intrinsics in PCG) and the flat kernel (INVERSE_DEPTH).
Bars: the same kernel and LM iteration count, the final cost within 1e-6
relative, the container's extrinsics within 1e-6; the covariance of the
solved rig within 1e-8 relative to its largest entry; the outlier filter's
reprojection pass (`_reproject_all_kernel`) within 1e-10 px^2 of JAX's.

The eight-model rig of `tools.camera_rig` (`chip_smoke.py` phase 10) at
test size, 6 views and 40 tracks a model, through the iterative Schur with
every model's focal length and radial distortion free: the same LM
iterations, the final cost within 1e-6 relative, extrinsics within 1e-6
and intrinsics within 1e-6 relative.

A PINHOLE + FISHEYE + DOUBLE_SPHERE rig at wide angles (up to 100 degrees
off the axis for the fisheye models) gives finite residuals and Jacobians,
each row equal to its own model's.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions
from pytheiasfm_tpu.ba.lm import TrackParametrizationType as JTP
from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as JM
from pytheiasfm_tpu.models.intrinsics import OptimizeIntrinsicsType as JOI
from pytheiasfm_tpu.sfm import reconstruction_estimator_utils as jreu
from pytheiasfm_tpu.utils import synthetic as jsyn
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba import entry as tentry
from pytheiasfm_tpu_torch.ba import lm as tlm
from pytheiasfm_tpu_torch.models import intrinsics as tintr
from pytheiasfm_tpu_torch.sfm import reconstruction_estimator_utils as treu
from test_torch_bundle_adjustment import _t_options
from test_torch_flat_ba import KernelRecorder
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

M = tintr.CameraIntrinsicsModelType
COST_REL = 1e-6
EXTRINSICS_TOL = 1e-6
COV_REL = 1e-8
# The JAX test's scene is noise-free, so its optimum costs 1e-24, rounding
# noise, where no relative bar on the cost means anything; here the
# observations carry 0.3 px of noise.
PIXEL_NOISE = 0.3


def mixed_scene(seed=42):
    """The JAX test's two-model scene, perturbed: (JAX container, free
    views, all tracks)."""
    recon = jsyn.random_reconstruction(num_views=4, num_tracks=60, seed=1, model=JM.PINHOLE,
                                       pixel_noise=PIXEL_NOISE)
    extra = jsyn.random_reconstruction(num_views=4, num_tracks=60, seed=2,
                                       model=JM.DIVISION_UNDISTORTION, pixel_noise=PIXEL_NOISE)
    offs_v = recon.num_views()
    for v in range(extra.num_views()):
        nv = recon.add_view(f"mixed_{v}", group_id=None, prior=extra.view_priors[v])
        recon.view_extrinsics[nv] = extra.view_extrinsics[v]
        recon.view_estimated[nv] = True
    g = recon.view_group[offs_v]
    recon.intrinsics[g] = extra.intrinsics[extra.view_group[0]]
    recon.group_model[g] = JM.DIVISION_UNDISTORTION
    for t in range(extra.num_tracks()):
        nt = recon.add_track(extra.points[t])
        for row in extra.track_observations(t):
            recon.add_observation(offs_v + int(extra.obs_view[row]), nt, extra.obs_uv[row])
    rng = np.random.default_rng(seed)
    free = [v for v in range(recon.num_views()) if v not in (0, 1, offs_v, offs_v + 1)]
    recon.view_extrinsics[free] += rng.normal(size=(len(free), 6)) * 0.005
    recon.points[:, :3] += rng.normal(size=(recon.num_tracks(), 3)) * 0.01
    return recon, free, list(range(recon.num_tracks()))


KERNELS = {
    "dense": {},
    "iterative": dict(intrinsics_to_optimize=JOI.FOCAL_LENGTH | JOI.RADIAL_DISTORTION),
    "flat": dict(track_parametrization_type=JTP.INVERSE_DEPTH),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_mixed_rig_bundle_adjustment_matches_jax(monkeypatch, kernel):
    jr, free, tracks = mixed_scene()
    assert sorted({int(m) for m in jr.group_model}) == [M.PINHOLE, M.DIVISION_UNDISTORTION]
    tr = convert.reconstruction(jr)
    jopt = JOptions(max_num_iterations=60, **KERNELS[kernel])
    rec = KernelRecorder(monkeypatch, jentry)
    js = jentry.bundle_adjust_partial_reconstruction(jopt, free, tracks, jr, dtype=np.float64)
    ts = tentry.bundle_adjust_partial_reconstruction(_t_options(jopt), free, tracks, tr,
                                                     dtype=np.float64, device="cpu")
    assert rec.calls == [kernel] and ts.linear_solver == kernel
    assert ts.success and bool(js.success)
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    assert ts.final_cost < 0.1 * ts.initial_cost
    np.testing.assert_allclose(tr.view_extrinsics, jr.view_extrinsics, rtol=0,
                               atol=EXTRINSICS_TOL)
    if kernel == "iterative":
        np.testing.assert_allclose(tr.intrinsics, jr.intrinsics, rtol=1e-6, atol=1e-9)


def test_eight_model_rig_matches_jax(monkeypatch):
    import test_torch_global_pose as S

    from pytheiasfm_tpu_torch.sfm.view_graph import ViewGraph
    from pytheiasfm_tpu_torch.tools import camera_rig

    rig = camera_rig.build_rig(views_per_group=6, tracks_per_group=40)
    assert sorted(int(m) for m in rig.recon.group_model) == list(range(8))
    free = camera_rig.perturb(rig)
    tr = rig.recon
    jr, _ = S.to_jax(tr, ViewGraph())
    tracks = [int(t) for t in np.nonzero(tr.track_estimated)[0]]
    jopt = JOptions(intrinsics_to_optimize=JOI.FOCAL_LENGTH | JOI.RADIAL_DISTORTION)
    rec = KernelRecorder(monkeypatch, jentry)
    js = jentry.bundle_adjust_partial_reconstruction(jopt, free, tracks, jr, dtype=np.float64)
    ts = tentry.bundle_adjust_partial_reconstruction(_t_options(jopt), free, tracks, tr,
                                                     dtype=np.float64, device="cpu")
    assert rec.calls == ["iterative"] and ts.linear_solver == "iterative"
    assert ts.success and bool(js.success)
    assert ts.num_iterations == int(js.num_iterations)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=COST_REL)
    np.testing.assert_allclose(tr.view_extrinsics, jr.view_extrinsics, rtol=0,
                               atol=EXTRINSICS_TOL)
    np.testing.assert_allclose(tr.intrinsics, jr.intrinsics, rtol=1e-6, atol=1e-9)
    assert max(camera_rig.group_position_errors(rig, tr.view_extrinsics)) < 0.05


@pytest.fixture(scope="module")
def solved_rig():
    jr, free, tracks = mixed_scene()
    jentry.bundle_adjust_partial_reconstruction(JOptions(), free, tracks, jr, dtype=np.float64)
    return jr


@pytest.mark.parametrize("selected", [False, True])
def test_mixed_rig_covariance_matches_jax(solved_rig, selected):
    """The dense joint covariance and the selected-block PCG
    (`ba/covariance.py`) of views of both models. The two groups share no
    track, so each fixes its own gauge by two constant views."""
    kw = dict(view_ids=[2, 6], track_ids=[0, 70]) if selected else {}
    gauge = (0, 1, 4, 5)
    want = jentry.compute_reconstruction_covariance(JOptions(), solved_rig,
                                                    constant_views=gauge, **kw)
    got = tentry.compute_reconstruction_covariance(
        _t_options(JOptions()), convert.reconstruction(solved_rig), constant_views=gauge,
        device="cpu", **kw)
    assert got[2] == pytest.approx(want[2], rel=COV_REL) and got[2] > 0
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        assert set(g) == set(w)
        scale = max(np.abs(b).max() for b in w.values())
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=COV_REL * scale, err_msg=k)


def test_mixed_rig_reprojection_matches_jax():
    """The outlier filter's pass over every observation row of the rig,
    each through its own model."""
    jr, _, _ = mixed_scene()
    jerr, jdepth = jreu.compute_reprojection_errors(jr)
    terr, tdepth = treu.compute_reprojection_errors(convert.reconstruction(jr), device="cpu")
    assert np.max(np.asarray(jerr)) > 1.0  # the perturbation shows
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tdepth, np.asarray(jdepth), rtol=0, atol=1e-12)


def _wide_rig(rng):
    """Three groups (PINHOLE, FISHEYE, DOUBLE_SPHERE), two views each near
    the identity, 40 points a view: pinhole rows up to 40 degrees off the
    axis, fisheye and double-sphere rows up to 100 degrees (some behind
    the image plane)."""
    models = (M.PINHOLE, M.FISHEYE, M.DOUBLE_SPHERE)
    intr = torch.as_tensor(np.stack([
        tintr.make_intrinsics_np(M.PINHOLE, 800.0, 1.0, 0.0, (640, 480), (0.01, 0.001)),
        tintr.make_intrinsics_np(M.FISHEYE, 400.0, 1.0, 0.0, (640, 480), (0.01, 0.001, 0.0005,
                                                                         0.0001)),
        tintr.make_intrinsics_np(M.DOUBLE_SPHERE, 300.0, 1.0, 0.0, (640, 480), (0.2, 0.6)),
    ]))
    V, per_view = 6, 40
    view_group = torch.arange(V) // 2
    ext = torch.as_tensor(np.concatenate([rng.normal(size=(V, 3)) * 0.05,
                                          rng.normal(size=(V, 3)) * 0.02], 1))
    obs_view = torch.arange(V).repeat_interleave(per_view)
    max_deg = torch.tensor([40.0, 100.0, 100.0])[view_group[obs_view]]
    theta = torch.deg2rad(torch.as_tensor(rng.uniform(0, 1, len(obs_view)))) * max_deg
    phi = torch.as_tensor(rng.uniform(0, 2 * np.pi, len(obs_view)))
    dist = torch.as_tensor(rng.uniform(3, 8, len(obs_view)))
    rays = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], -1)
    points = ext[obs_view, :3] + dist[:, None] * rays  # rays in the world frame
    O = len(obs_view)
    uv = torch.as_tensor(rng.uniform(0, 1280, (O, 2)))
    obs = (obs_view, torch.arange(O), uv, torch.ones(O, 2, dtype=torch.float64),
           torch.ones(O, dtype=torch.bool))
    return models, intr, view_group, ext, points, obs


@pytest.mark.parametrize("tp", [tlm.TrackParametrizationType.XYZW,
                                tlm.TrackParametrizationType.XYZW_MANIFOLD])
def test_wide_angle_rig_has_finite_residuals_and_jacobians(rng, tp):
    models, intr, view_group, ext, points, obs = _wide_rig(rng)
    O = len(obs[0])
    if tp == tlm.TrackParametrizationType.XYZW_MANIFOLD:
        points = torch.cat([points, torch.ones(O, 1, dtype=torch.float64)], -1)
        points = points / torch.linalg.norm(points, dim=-1, keepdim=True)

    def problem(present, group_model_idx, rows):
        o = tuple(a[rows] for a in obs)
        return tlm._Problem(o, view_group, torch.zeros(O, dtype=torch.long),
                            torch.zeros(O, 3, dtype=torch.float64), present, group_model_idx,
                            tp, tlm.LossFunctionType.TRIVIAL, 2.0, torch.float64)

    everything = torch.arange(O)
    got = problem(models, torch.arange(3), everything).residuals(ext, intr, points, True)
    r, Jc, _, Ji, Jp, s = got
    for t in (r, Jc, Ji, Jp, s):
        assert torch.all(torch.isfinite(t))
    # Each model's rows as a problem of that model alone.
    row_group = view_group[obs[0]]
    for g, m in enumerate(models):
        rows = torch.nonzero(row_group == g).squeeze(1)
        want = problem((m,), torch.zeros(3, dtype=torch.long), rows).residuals(
            ext, intr, points, True)
        for a, b in zip(got, want):
            if a is not None:
                torch.testing.assert_close(a[rows], b, rtol=0, atol=0)
