"""The port's synthetic global-SfM scene, `Reconstruction`, estimator
options and scene converters against the JAX package's, on the CPU in f64.

`build_scene` runs at 48 views and 4,000 tracks with a ring neighborhood of
6 (every view gets 17-19 edges, 450 in all). Both packages draw the same
numpy values in the same order, so the edge set and observation counts are
equal and the numbers agree to 1e-9 (observed: 5e-13 on pixels of order
1e3, from sin/cos and the rotation conversions).
"""

import dataclasses

import numpy as np
import pytest

from pytheiasfm_tpu.pipelines import synthetic_global as jsg
from pytheiasfm_tpu.sfm import estimator_options as jopts
from pytheiasfm_tpu.sfm.reconstruction import Reconstruction as JaxReconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.pipelines import synthetic_global as tsg
from pytheiasfm_tpu_torch.sfm import estimator_options as topts
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

SCENE = dict(V=48, T=4000, neighborhood=6)
TOL = 1e-9


@pytest.fixture(scope="module")
def scenes():
    return jsg.build_scene(**SCENE), tsg.build_scene(**SCENE)


def test_build_scene_matches_jax(scenes):
    (jr, jg, jp), (tr, tg, tp) = scenes
    assert set(tg.edges) == set(jg.edges)
    assert tg.num_edges() == 450
    assert tr.num_observations() == jr.num_observations()
    np.testing.assert_array_equal(tr.obs_view, jr.obs_view)
    np.testing.assert_array_equal(tr.obs_track, jr.obs_track)
    np.testing.assert_allclose(tr.obs_uv, jr.obs_uv, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr.intrinsics, jr.intrinsics)
    for key, info in jg.edges.items():
        mine = tg.edges[key]
        np.testing.assert_allclose(mine.rotation_2, info.rotation_2, rtol=0, atol=TOL)
        np.testing.assert_allclose(mine.position_2, info.position_2, rtol=0, atol=TOL)
        assert mine.num_verified_matches == info.num_verified_matches
    degree = np.bincount(np.array(list(tg.edges)).ravel(), minlength=SCENE["V"])
    assert degree.min() > 0


def test_reconstruction_bookkeeping():
    """Groups share intrinsics rows, duplicates are dropped by the bulk adder
    (in the batch and against earlier rows), and the indexes agree with the
    JAX container's on the same calls."""
    prior = CameraIntrinsicsPrior(image_width=640, image_height=480)
    recons = []
    for cls in (Reconstruction, JaxReconstruction):
        r = cls()
        assert r.add_view("a", prior=prior) == 0
        assert r.add_view("b", group_id=0, prior=prior) == 1
        assert r.add_view("c", prior=dataclasses.replace(prior, focal_length=500.0)) == 2
        assert r.add_view("a") == -1
        r.set_camera_intrinsics_from_priors()
        r.add_tracks_bulk(4)
        assert r.add_observation(0, 0, [1.0, 2.0])
        assert not r.add_observation(0, 0, [3.0, 4.0])
        added = r.add_observations_bulk(
            [0, 1, 1, 2, 0, 2], [0, 0, 0, 3, 1, 1], np.arange(12.0).reshape(6, 2)
        )
        assert added == 4
        recons.append(r)
    mine, ref = recons
    assert list(mine.view_group) == [0, 0, 1]
    assert mine.intrinsics[0, 0] == 1.2 * 640 and mine.intrinsics[1, 0] == 500.0
    for name in ("obs_view", "obs_track", "obs_uv", "intrinsics", "track_reference_view"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert mine._track_obs == ref._track_obs
    assert mine._view_track_to_obs == ref._view_track_to_obs
    assert mine.tracks_in_view(2) == [3, 1]
    sub = mine.get_sub_reconstruction([0, 2])
    assert sub.num_views() == 2 and sub.num_tracks() == 1


def test_convert_reconstruction_and_view_graph(scenes):
    (jr, jg, _), _ = scenes
    r = convert.reconstruction(jr)
    assert isinstance(r, Reconstruction)
    assert set(vars(r)) == set(vars(jr))
    for name, value in vars(jr).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(r, name), value)
            assert getattr(r, name) is not value
    assert r._view_track_to_obs == jr._view_track_to_obs
    assert r.group_model == [int(m) for m in jr.group_model]
    assert r.view_priors[0] == convert.camera_intrinsics_prior(jr.view_priors[0])
    g = convert.view_graph(jg)
    assert list(g.edges) == list(jg.edges)
    assert g.view_ids() == jg.view_ids()
    v = g.edge_arrays()
    for mine, ref in zip(v, jg.edge_arrays()):
        np.testing.assert_array_equal(mine, ref)


def test_estimator_options_match_jax():
    mine = dataclasses.asdict(topts.ReconstructionEstimatorOptions())
    ref = dataclasses.asdict(jopts.ReconstructionEstimatorOptions())
    assert mine.keys() == ref.keys()
    for key, value in ref.items():
        assert mine[key] == value, key
    assert dataclasses.asdict(topts.ReconstructionEstimatorSummary()) == dataclasses.asdict(
        jopts.ReconstructionEstimatorSummary()
    )
    for name in ("ReconstructionEstimatorType", "GlobalRotationEstimatorType",
                 "GlobalPositionEstimatorType", "PnPType", "TrackParametrizationType"):
        assert {m.name: int(m) for m in getattr(topts, name)} == {
            m.name: int(m) for m in getattr(jopts, name)
        }
