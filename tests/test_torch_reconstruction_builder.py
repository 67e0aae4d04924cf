"""The port's `ReconstructionBuilder`
(`pytheiasfm_tpu_torch/sfm/reconstruction_builder.py`) against the JAX
package's `sfm/reconstruction_builder.py`, on the CPU, both fed identical
`ImagePairMatch` lists.

Scenes: the one of `tests/test_hybrid_and_builder.py:62-120` (6 views, 250
tracks, 0.2 px noise, seed 13; edges between views sharing 80 tracks), and
that scene beside a second one (seed 21) with no match between them. There
the estimator's initial filter keeps the larger component and drops the
other's edges from the builder's view graph, so the leftover round of
`build_reconstruction` (the sub-reconstruction of the 6 unestimated views)
finds no edge and both packages return one model. Both run the global
estimator with the JAX test's options. Bars: the same number of models,
the same views (by name) and the same estimated tracks (as sets of
(view name, pixel) observations) in each model; positions, Sim(3)-aligned
onto the JAX package's, within 1e-6 of the ring radius with the track
estimator and BA in f64 (their `dtype` defaults set to float64 in both
packages) and 1e-4 at their f32 defaults; orientations within 1e-6 rad
(f64). The builder layer itself (track building, the view graph, the
sub-reconstructions) is exact.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ba import entry as jentry
from pytheiasfm_tpu.sfm import track_estimator as jte
from pytheiasfm_tpu.sfm.estimator_options import (
    ReconstructionEstimatorOptions as JOptions,
    ReconstructionEstimatorType as JType,
)
from pytheiasfm_tpu.sfm.reconstruction_builder import (
    ImagePairMatch as JMatch,
    ReconstructionBuilder as JBuilder,
    ReconstructionBuilderOptions as JBOptions,
)
from pytheiasfm_tpu.utils.synthetic import (
    SyntheticSceneOptions,
    add_view_graph_edges,
    generate_scene,
)
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.ba import entry as tentry
from pytheiasfm_tpu_torch.ops import rotation as rotops
from pytheiasfm_tpu_torch.sfm import track_estimator as tte
from pytheiasfm_tpu_torch.sfm.estimator_options import (
    ReconstructionEstimatorOptions as TOptions,
    ReconstructionEstimatorType as TType,
)
from pytheiasfm_tpu_torch.sfm.reconstruction_builder import (
    ReconstructionBuilder as TBuilder,
    ReconstructionBuilderOptions as TBOptions,
)
from pytheiasfm_tpu_torch.transforms import alignment as talign
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

RADIUS = 10.0  # `SyntheticSceneOptions.camera_radius`
POSITION_TOL = {"f64": 1e-6 * RADIUS, "f32": 1e-4 * RADIUS}
ORIENTATION_TOL_RAD = 1e-6
ESTIMATOR = dict(min_num_two_view_inliers=30, num_retriangulation_iterations=0)


def _scene(seed, prefix):
    """(views [(name, prior)], matches [JAX ImagePairMatch]) of one scene."""
    src, gt_ext, _ = generate_scene(
        SyntheticSceneOptions(num_views=6, num_tracks=250, pixel_noise=0.2, seed=seed))
    vg = add_view_graph_edges(src, gt_ext, min_shared_tracks=80, seed=4)
    names = [f"{prefix}{n}" for n in src.view_names]
    matches = []
    for (i, j), info in vg.edges.items():
        shared = sorted(set(src.tracks_in_view(i)) & set(src.tracks_in_view(j)))
        matches.append(JMatch(
            image1=names[i], image2=names[j], twoview_info=info,
            correspondences1=np.stack([src.obs_uv[src._view_track_to_obs[i][t]]
                                       for t in shared]),
            correspondences2=np.stack([src.obs_uv[src._view_track_to_obs[j][t]]
                                       for t in shared])))
    return list(zip(names, src.view_priors)), matches


def _run(builder, views, matches, to_port):
    for name, prior in views:
        builder.add_image_with_camera_intrinsics_prior(
            name, convert.camera_intrinsics_prior(prior) if to_port else prior)
    for m in matches:
        m = convert.image_pair_match(m) if to_port else m
        assert builder.add_two_view_match(m.image1, m.image2, m)
    return builder.build_reconstruction()


@pytest.fixture(scope="module", params=["f64", "f32"])
def runs(request):
    mp = pytest.MonkeyPatch()
    if request.param == "f64":
        for fn in (jentry.bundle_adjust_reconstruction, jte.estimate_all_tracks,
                   tentry.bundle_adjust_reconstruction, tte.estimate_all_tracks):
            mp.setattr(fn, "__defaults__", tuple(
                np.float64 if d is np.float32 else d for d in fn.__defaults__))
    try:
        out = {}
        for scenes in ("one", "two"):
            parts = [_scene(13, "a_")] + ([_scene(21, "b_")] if scenes == "two" else [])
            views = [v for p in parts for v in p[0]]
            matches = [m for p in parts for m in p[1]]
            want = _run(JBuilder(JBOptions(
                min_num_inlier_matches=30,
                reconstruction_estimator_options=JOptions(
                    reconstruction_estimator_type=JType.GLOBAL, **ESTIMATOR))),
                views, matches, to_port=False)
            got = _run(TBuilder(TBOptions(
                min_num_inlier_matches=30,
                reconstruction_estimator_options=TOptions(
                    reconstruction_estimator_type=TType.GLOBAL, **ESTIMATOR)),
                device="cpu"), views, matches, to_port=True)
            out[scenes] = want, got
    finally:
        mp.undo()
    return request.param, out


def _tracks(model):
    return {
        frozenset((model.view_names[int(model.obs_view[r])], *map(float, model.obs_uv[r]))
                  for r in model.track_observations(t))
        for t in np.flatnonzero(model.track_estimated)
    }


@pytest.mark.parametrize("scenes", ["one", "two"])
def test_builder_matches_jax(runs, scenes):
    dtype, out = runs
    want, got = out[scenes]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g.view_names == w.view_names
        np.testing.assert_array_equal(g.view_estimated, w.view_estimated)
        assert int(g.view_estimated.sum()) >= 5
        assert _tracks(g) == _tracks(w)
        ids = np.flatnonzero(g.view_estimated)
        mine = torch.as_tensor(g.view_extrinsics[ids, :3])
        ref = torch.as_tensor(w.view_extrinsics[ids, :3])
        R, t, s = talign.align_point_clouds_umeyama(mine, ref)
        gap = torch.linalg.norm(talign.sim3_transform_points(mine, R, t, s) - ref, dim=-1)
        assert float(gap.max()) <= POSITION_TOL[dtype], float(gap.max())
        if dtype == "f64":
            Rg = rotops.angle_axis_to_rotation_matrix(torch.as_tensor(g.view_extrinsics[ids, 3:]))
            Rw = rotops.angle_axis_to_rotation_matrix(torch.as_tensor(w.view_extrinsics[ids, 3:]))
            # Both packages fix the gauge the same way, so no alignment.
            rel = rotops.rotation_matrix_to_angle_axis(Rg @ Rw.mT)
            assert float(torch.linalg.norm(rel, dim=-1).max()) <= ORIENTATION_TOL_RAD


def test_add_two_view_match_rejects():
    """Too few inliers, or an unknown image: no edge and no correspondences."""
    views, matches = _scene(13, "a_")
    builder = TBuilder(TBOptions(min_num_inlier_matches=30), device="cpu")
    for name, prior in views:
        builder.add_image_with_camera_intrinsics_prior(name, convert.camera_intrinsics_prior(prior))
    m = convert.image_pair_match(matches[0])
    m.twoview_info.num_verified_matches = 29
    assert not builder.add_two_view_match(m.image1, m.image2, m)
    m.twoview_info.num_verified_matches = 30
    assert not builder.add_two_view_match("nope", m.image2, m)
    assert builder.view_graph.num_edges() == 0 and builder.build_reconstruction() == []


@pytest.mark.parametrize("kind", ["INCREMENTAL", "HYBRID"])
def test_incremental_and_hybrid_raise(kind):
    views, matches = _scene(13, "a_")
    builder = TBuilder(TBOptions(reconstruction_estimator_options=TOptions(
        reconstruction_estimator_type=TType[kind])), device="cpu")
    with pytest.raises(NotImplementedError, match="C1"):
        _run(builder, views, matches, to_port=True)
