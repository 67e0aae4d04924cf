"""The port's reconstruction-estimator helpers and BA track selection
against the JAX package's (`sfm/reconstruction_estimator_utils.py`,
`sfm/select_tracks.py`), on the CPU in f64.

Scene: `utils.synthetic.random_reconstruction` (8 views, 150 tracks at
ground truth, 0.3 px noise, seed 3) from the JAX package, converted into the
port's container, with outliers injected: points moved behind a camera,
observations moved by 30 px, and tracks re-observed from a point 2 km away
(consistent pixels, rays within a fraction of a degree).

Bars: reprojection errors and depths to 1e-10 (relative to 1 + |value|);
the outlier, under-constrained and selected sets equal.
"""

import numpy as np
import pytest

from pytheiasfm_tpu.sfm import reconstruction_estimator_utils as jru
from pytheiasfm_tpu.sfm import select_tracks as jsel
from pytheiasfm_tpu.utils.synthetic import random_reconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np
from pytheiasfm_tpu_torch.sfm import reconstruction_estimator_utils as tru
from pytheiasfm_tpu_torch.sfm import select_tracks as tsel
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-10
BEHIND = [3, 40, 99]
SHIFTED = [5, 41, 100, 120]
FAR = [7, 42, 101]


def _project(recon, v, X):
    R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[v, 3:])
    p = R @ (X - recon.view_extrinsics[v, :3])
    q = recon.intrinsics[recon.view_group[v]]
    return q[0] * p[:2] / p[2] + q[3:5]


def _scene():
    recon = random_reconstruction(num_views=8, num_tracks=150, seed=3, pixel_noise=0.3)
    for t in BEHIND:
        v = recon.obs_view[recon.track_observations(t)[0]]
        c = recon.view_extrinsics[v, :3]
        recon.points[t, :3] = c + 0.5 * c  # behind a camera that looks at the origin
    for t in SHIFTED:
        recon.obs_uv[recon.track_observations(t)[-1]] += 30.0
    for t in FAR:
        X = np.array([2000.0, 10.0 * t, 5.0])
        recon.points[t] = np.append(X, 1.0)
        for r in recon.track_observations(t):
            recon.obs_uv[r] = _project(recon, recon.obs_view[r], X)
    return recon, convert.reconstruction(recon)


@pytest.fixture
def scenes():
    return _scene()


def test_compute_reprojection_errors(scenes):
    jr, tr = scenes
    je, jd = jru.compute_reprojection_errors(jr)
    te, td = tru.compute_reprojection_errors(tr, device="cpu")
    for got, want in ((te, je), (td, jd)):
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    rows = np.arange(0, tr.num_observations(), 3)
    te2, td2 = tru.compute_reprojection_errors(tr, rows, device="cpu")
    np.testing.assert_array_equal(te2, te[rows])
    np.testing.assert_array_equal(td2, td[rows])


@pytest.mark.parametrize("subset", [False, True])
def test_set_outlier_tracks_to_unestimated(scenes, subset):
    jr, tr = scenes
    ids = list(range(0, 150, 2)) + BEHIND + SHIFTED + FAR if subset else None
    jn = jru.set_outlier_tracks_to_unestimated(jr, 5.0, 3.0, track_ids=ids)
    tn = tru.set_outlier_tracks_to_unestimated(tr, 5.0, 3.0, track_ids=ids, device="cpu")
    assert tn == jn
    np.testing.assert_array_equal(tr.track_estimated, jr.track_estimated)
    removed = set(np.nonzero(~tr.track_estimated)[0]) - set(np.nonzero(
        ~_scene()[1].track_estimated)[0])
    assert set(BEHIND + SHIFTED + FAR) <= removed
    assert len(removed) == tn


def test_underconstrained_filters(scenes):
    jr, tr = scenes
    for r in (jr, tr):
        r.view_estimated[[1, 2, 6]] = False
        # A track seen by one estimated view and one unestimated view.
        t = r.add_track(np.array([0.0, 0.0, 0.0, 1.0]))
        r.add_observation(0, t, np.array([10.0, 10.0]))
        r.add_observation(1, t, np.array([20.0, 20.0]))
        r.track_estimated[:148] = False  # 2 tracks left + the new one
    assert tru.set_underconstrained_tracks_to_unestimated(tr) == \
        jru.set_underconstrained_tracks_to_unestimated(jr) > 0
    np.testing.assert_array_equal(tr.track_estimated, jr.track_estimated)
    assert tru.set_underconstrained_views_to_unestimated(tr) == \
        jru.set_underconstrained_views_to_unestimated(jr) > 0
    np.testing.assert_array_equal(tr.view_estimated, jr.view_estimated)
    assert tru.num_estimated_views(tr) == jru.num_estimated_views(jr)
    assert tru.num_estimated_tracks(tr) == jru.num_estimated_tracks(jr)


@pytest.mark.parametrize("cell,per_view,long_len", [(100, 200, 10), (300, 12, 3)])
def test_select_good_tracks_for_bundle_adjustment(scenes, cell, per_view, long_len):
    jr, tr = scenes
    kw = dict(long_track_length_threshold=long_len, image_grid_cell_size_pixels=cell,
              min_num_optimized_tracks_per_view=per_view)
    want = jsel.select_good_tracks_for_bundle_adjustment(jr, **kw)
    got = tsel.select_good_tracks_for_bundle_adjustment(tr, device="cpu", **kw)
    assert got == want
    assert 0 < len(got) <= 150


def test_small_helpers(scenes):
    jr, tr = scenes
    assert tru.compute_resolution_scaled_threshold(2.0, 2048, 1536) == \
        jru.compute_resolution_scaled_threshold(2.0, 2048, 1536) == 4.0
    sub_j = jru.create_estimated_subreconstruction(jr)
    sub_t = tru.create_estimated_subreconstruction(tr)
    assert sub_t.num_views() == sub_j.num_views()
    assert sub_t.num_tracks() == sub_j.num_tracks()
    np.testing.assert_array_equal(sub_t.obs_track, sub_j.obs_track)
