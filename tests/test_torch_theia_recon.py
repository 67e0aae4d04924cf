"""The port's Theia `.recon` codec (`pytheiasfm_tpu_torch/io/theia_recon.py`)
against the JAX package's, on the CPU.

The round trips of `tests/test_theia_recon.py` on the port; the port's
writer gives the JAX writer's bytes (reconstructions with shared and
separate intrinsics groups, every prior field, unestimated tracks, and the
view graph); each package reads the files the other writes into the same
container; a legacy-dialect archive built here by hand reads the same in
both, and one with a wrong Eigen header raises a clear error in the port.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest

from pytheiasfm_tpu.io import theia_recon as J
from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as JM
from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JPrior
from pytheiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo as JInfo
from pytheiasfm_tpu.sfm.view_graph import ViewGraph as JGraph
from pytheiasfm_tpu.utils.synthetic import random_reconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.io import theia_recon as P
from pytheiasfm_tpu_torch.models.intrinsics import CameraIntrinsicsModelType
from pytheiasfm_tpu_torch.pipelines import fountain
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from pytheiasfm_tpu_torch.sfm.view_graph import TwoViewInfo

FOUNTAIN, GT_FOUNTAIN = fountain.DEFAULT_FOUNTAIN, fountain.DEFAULT_GT

_ARRAYS = ("view_extrinsics", "view_group", "view_estimated", "intrinsics", "points",
           "track_estimated", "track_colors", "track_inverse_depth", "track_reference_view",
           "obs_view", "obs_track", "obs_uv", "obs_sqrt_inv_cov", "obs_depth_prior",
           "obs_depth_prior_variance")


def assert_same_reconstruction(a, b):
    """Every array, name, timestamp, prior, group model and index equal."""
    assert a.view_names == b.view_names
    assert list(a.view_timestamps) == list(b.view_timestamps)
    assert [int(m) for m in a.group_model] == [int(m) for m in b.group_model]
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a._track_obs == b._track_obs
    assert a._view_track_to_obs == b._view_track_to_obs
    for pa, pb in zip(a.view_priors, b.view_priors):
        for f in dataclasses.fields(pa):
            va, vb = getattr(pa, f.name), getattr(pb, f.name)
            if f.name == "camera_intrinsics_model_type":
                assert int(va) == int(vb)
            elif isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


def _synthetic(cls, prior_cls):
    """`tests/test_theia_recon.py`'s reconstruction, built with either
    package's classes."""
    rec = cls()
    prior = prior_cls(image_width=640, image_height=480, focal_length=525.0,
                      principal_point=(320.0, 240.0))
    for i in range(4):
        v = rec.add_view(f"img{i}.png", group_id=0 if i else None, prior=prior)
        rec.view_extrinsics[v] = np.arange(6) * 0.1 + i
        rec.view_estimated[v] = i % 2 == 0
    rng = np.random.default_rng(3)
    for t in range(9):
        tid = rec.add_track(np.append(rng.normal(size=3), 1.0))
        rec.track_colors[tid] = [t, 2 * t, 3 * t]
        for v in range(4):
            if (t + v) % 3 != 0:
                rec.add_observation(v, tid, rng.uniform(0, 640, 2))
    return rec


def _full_priors():
    """A JAX reconstruction whose views carry every prior field, a second
    camera model, separate groups, unestimated tracks and non-unit
    sqrt-information."""
    rec = random_reconstruction(num_views=6, num_tracks=40, seed=4)
    rng = np.random.default_rng(9)
    for v, p in enumerate(rec.view_priors):
        rec.view_priors[v] = dataclasses.replace(
            p, aspect_ratio=1.01, skew=0.5, radial_distortion=(0.1, -0.02),
            tangential_distortion=(1e-3, -2e-3), position=rng.normal(size=3),
            position_sqrt_information=np.diag(rng.uniform(1, 2, 3)),
            orientation=rng.normal(size=3) * 0.1, gravity=np.array([0.0, 0.0, -1.0]),
            gravity_sqrt_information=np.eye(3) * 3.0, latitude=47.1, longitude=8.5,
            altitude=400.0 + v)
    rec.view_timestamps = [0.5 * v for v in range(rec.num_views())]
    rec.group_model[1] = JM.FISHEYE
    rec.track_estimated[::3] = False
    rec.track_inverse_depth[:] = rng.uniform(0.1, 1.0, rec.num_tracks())
    rec.obs_sqrt_inv_cov[:] = rng.uniform(0.5, 2.0, rec.obs_sqrt_inv_cov.shape)
    return rec


def _jax_graph():
    g = JGraph()
    rng = np.random.default_rng(0)
    for (a, b) in [(0, 1), (1, 2), (0, 2), (2, 3), (5, 3)]:
        g.add_edge(a, b, JInfo(
            focal_length_1=500.0 + a, focal_length_2=500.0 + b, position_2=rng.normal(size=3),
            rotation_2=rng.normal(size=3) * 0.1, num_verified_matches=100 + a + b,
            num_homography_inliers=30, visibility_score=7, scale_estimate=1.5))
    return g


def test_recon_write_read_round_trip(tmp_path):
    """`tests/test_theia_recon.py::test_recon_write_read_round_trip` on the port."""
    rec = _synthetic(Reconstruction, CameraIntrinsicsPrior)
    path = str(tmp_path / "rt.recon")
    P.write_theia_reconstruction(rec, path)
    r2 = P.read_theia_reconstruction(path)
    assert (r2.num_views(), r2.num_tracks(), r2.num_observations()) == (
        rec.num_views(), rec.num_tracks(), rec.num_observations())
    assert r2.view_names == rec.view_names
    assert np.allclose(r2.view_extrinsics, rec.view_extrinsics)
    assert np.array_equal(r2.view_estimated, rec.view_estimated)
    assert np.allclose(r2.points, rec.points)
    assert np.array_equal(r2.track_colors, rec.track_colors)
    assert np.allclose(r2.intrinsics, rec.intrinsics)

    def keyed(r):
        return {(int(v), int(t)): tuple(uv) for v, t, uv in zip(r.obs_view, r.obs_track, r.obs_uv)}

    k1, k2 = keyed(rec), keyed(r2)
    assert k1.keys() == k2.keys()
    assert all(np.allclose(k1[k], k2[k]) for k in k1)
    assert np.array_equal(r2.view_group, rec.view_group)


def test_view_graph_round_trip(tmp_path):
    """`tests/test_theia_recon.py::test_view_graph_round_trip` on the port."""
    g = convert.view_graph(_jax_graph())
    path = str(tmp_path / "graph.vg")
    P.write_theia_view_graph(g, path)
    g2 = P.read_theia_view_graph(path)
    assert set(g2.edges) == set(g.edges)
    for key, i1 in g.edges.items():
        i2 = g2.edges[key]
        assert np.allclose(i1.position_2, i2.position_2)
        assert np.allclose(i1.rotation_2, i2.rotation_2)
        assert (i1.num_verified_matches, i1.visibility_score, i1.scale_estimate) == (
            i2.num_verified_matches, i2.visibility_score, i2.scale_estimate)


@pytest.mark.parametrize("case", ["synthetic", "full_priors", "random"])
def test_writer_bytes_equal_the_jax_writer_s_and_each_reads_the_other(tmp_path, case):
    jrec = {"synthetic": lambda: _synthetic(JRecon, JPrior), "full_priors": _full_priors,
            "random": lambda: random_reconstruction(num_views=5, num_tracks=60, seed=2)}[case]()
    mine = convert.reconstruction(jrec)
    pj, pp = str(tmp_path / "j.recon"), str(tmp_path / "p.recon")
    J.write_theia_reconstruction(jrec, pj)
    P.write_theia_reconstruction(mine, pp)
    with open(pj, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    # Each package reads the other's file into the container the other
    # reads from its own.
    assert_same_reconstruction(P.read_theia_reconstruction(pj),
                               convert.reconstruction(J.read_theia_reconstruction(pp)))
    assert_same_reconstruction(P.read_theia_reconstruction(pp),
                               convert.reconstruction(J.read_theia_reconstruction(pj)))


def test_view_graph_bytes_and_cross_reading(tmp_path):
    jg = _jax_graph()
    pj, pp = str(tmp_path / "j.vg"), str(tmp_path / "p.vg")
    J.write_theia_view_graph(jg, pj)
    P.write_theia_view_graph(convert.view_graph(jg), pp)
    with open(pj, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    for mine, ref in ((P.read_theia_view_graph(pj), J.read_theia_view_graph(pp)),):
        assert list(mine.edges) == list(ref.edges)
        for key, info in ref.edges.items():
            for f in dataclasses.fields(TwoViewInfo):
                np.testing.assert_array_equal(getattr(mine.edges[key], f.name),
                                              getattr(info, f.name))


# --------------------------------------------------------- legacy dialect


def _eigen(a, fmt="<d"):
    a = np.asarray(a)
    a = a[:, None] if a.ndim == 1 else a
    return struct.pack("<ii", *a.shape) + b"".join(
        struct.pack(fmt, x) for x in a.ravel(order="F"))


def _string(s):
    return struct.pack("<Q", len(s)) + s.encode()


def legacy_archive(point_header=(4, 1)):
    """A legacy-dialect archive (the layout of the reference's shipped
    fixtures): 3 views in two intrinsics groups, 4 tracks; Features are bare
    Vector2d, Tracks (is_estimated, view ids, point, color)."""
    rng = np.random.default_rng(1)
    out = [b"\x01", struct.pack("<III", 0, 4, 3)]  # version, next ids
    names = [f"{i:04d}.png" for i in range(3)]
    out.append(struct.pack("<Q", 3) + b"".join(_string(n) + struct.pack("<I", i)
                                                 for i, n in enumerate(names)))
    obs = {v: [(t, rng.uniform(0, 500, 2)) for t in range(4) if (t + v) % 4] for v in range(3)}
    out.append(struct.pack("<Q", 3))
    for v, name in enumerate(names):
        out.append(struct.pack("<I", v))
        if v == 0:
            out.append(struct.pack("<I", 0))  # View version
        out += [_string(name), b"\x01"]
        if v == 0:
            out.append(struct.pack("<I", 1))  # Camera version
        out.append(struct.pack("<6d", *rng.normal(size=6)))
        if v == 2:  # the second view shares view 0's intrinsics (pointer id 1)
            out.append(struct.pack("<II", 1, 1))
        else:
            poly = struct.pack("<I", 1 | 0x80000000) + _string("theia::PinholeCameraModel") \
                if v == 0 else struct.pack("<I", 1)
            out += [poly, struct.pack("<I", (1 if v == 0 else 2) | 0x80000000)]
            if v == 0:
                out.append(struct.pack("<II", 1, 0))  # model, base versions
            out.append(struct.pack("<Q", 7) + struct.pack("<7d", 2759.5 + v, 1.0, 0.0, 1536.0,
                                                         1024.0, 0.0, 0.0))
        out.append(struct.pack("<ii", 3072, 2048))
        if v == 0:
            out.append(struct.pack("<I", 1))  # CameraIntrinsicsPrior v1
        out.append(struct.pack("<ii", 3072, 2048))
        for k in range(7):
            if v == 0 and k == 0:
                out.append(struct.pack("<I", 0))  # Prior<1> version
            out.append(b"\x01" + struct.pack("<d", 2759.5 if k == 0 else 0.125 * k))
        out.append(struct.pack("<Q", len(obs[v])))
        for t, uv in obs[v]:
            out.append(struct.pack("<I", t) + _eigen(uv))
    out.append(struct.pack("<Q", 4))
    for t in range(4):
        out.append(struct.pack("<I", t))
        if t == 0:
            out.append(struct.pack("<I", 0))  # Track version
        views = [v for v in range(3) if (t + v) % 4]
        out.append(b"\x01" + struct.pack("<Q", len(views)) + struct.pack(f"<{len(views)}I", *views))
        point = _eigen(np.append(rng.normal(size=3), 1.0))
        if t == 2:
            point = struct.pack("<ii", *point_header) + point[8:]
        out += [point, _eigen(np.array([t, 2 * t, 3 * t], np.uint8), "<B")]
    out.append(struct.pack("<Q", 3) + struct.pack("<6I", 0, 0, 1, 1, 2, 0))
    out.append(struct.pack("<Q", 2) + struct.pack("<IQ2I", 0, 2, 0, 2)
               + struct.pack("<IQI", 1, 1, 1))
    return b"".join(out)


def test_legacy_dialect_reads_the_same_in_both(tmp_path):
    path = tmp_path / "legacy.bin"
    path.write_bytes(legacy_archive())
    mine = P.read_theia_reconstruction(str(path))
    assert_same_reconstruction(mine, convert.reconstruction(J.read_theia_reconstruction(str(path))))
    assert mine.num_views() == 3 and mine.num_tracks() == 4 and mine.num_observations() == 9
    assert list(mine.view_group) == [0, 1, 0]
    assert mine.view_priors[0].radial_distortion == (0.625, 0.75, 0.0, 0.0)
    # Each legacy track gets a bearing of its own.
    tracks = P._parse_reconstruction(legacy_archive(), legacy=True)[1]
    bearings = [tracks[t][6] for t in range(4)]
    assert len({id(b) for b in bearings}) == 4


def test_bad_legacy_header_raises_a_clear_error(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(legacy_archive(point_header=(3, 1)))
    with pytest.raises(ValueError, match=r"track record 2 has Eigen headers \(3, 1, 3, 1\).*"
                                         r"legacy-dialect"):
        P.read_theia_reconstruction(str(path))


@pytest.mark.skipif(not (os.path.exists(FOUNTAIN) and os.path.exists(GT_FOUNTAIN)),
                    reason="reference fixtures unavailable")
def test_reference_fixtures_read_the_same_in_both():
    for path in (FOUNTAIN, GT_FOUNTAIN):
        mine = P.read_theia_reconstruction(path)
        assert_same_reconstruction(mine, convert.reconstruction(J.read_theia_reconstruction(path)))
        assert mine.num_views() == 11
    g = P.read_theia_reconstruction(FOUNTAIN)
    assert (g.num_tracks(), g.num_observations()) == (16616, 75022)
    assert g.group_model[g.view_group[g.view_id_from_name("0005.png")]] == (
        CameraIntrinsicsModelType.PINHOLE)
