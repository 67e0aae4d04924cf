"""The port's `io/` package against the JAX package's, on the CPU in f64.

Every round trip of `tests/test_io.py` on the port (npz, Bundler, NVM,
JSON / PLY / COLMAP / NeRFStudio / SDFStudio, calibration), and across the
packages: each reads the files the other writes into the same container,
and the text and JSON files of both writers hold the same values (1e-9:
the JAX writers take their quaternions and angle-axis through its jnp
helpers, f64 under the tests' x64, the port through its own in f64).
Strecha and 1DSfM directories written here read the same in both (1e-12).
"""

import json
import os

import numpy as np
import pytest

from pytheiasfm_tpu import io as jio
from pytheiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JPrior
from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch import io as tio
from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

TOL = 1e-9
_ARRAYS = ("view_extrinsics", "view_group", "view_estimated", "intrinsics", "points",
           "track_estimated", "track_colors", "track_inverse_depth", "track_reference_view",
           "obs_view", "obs_track", "obs_uv", "obs_sqrt_inv_cov", "obs_depth_prior",
           "obs_depth_prior_variance")


@pytest.fixture
def scene():
    """`tests/test_io.py`'s scene (JAX package), everything estimated."""
    recon, _, gt_pts = generate_scene(SyntheticSceneOptions(num_views=4, num_tracks=30, seed=3))
    recon.view_estimated[:] = True
    recon.points[:, :3] = gt_pts
    recon.points[:, 3] = 1.0
    recon.track_estimated[:] = True
    recon.track_colors[:] = np.array([10, 20, 30], np.uint8)
    return recon


def assert_same_reconstruction(a, b, tol=0.0):
    assert a.view_names == b.view_names
    assert [int(m) for m in a.group_model] == [int(m) for m in b.group_model]
    for name in _ARRAYS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a._track_obs == b._track_obs
    assert a._view_track_to_obs == b._view_track_to_obs
    for pa, pb in zip(a.view_priors, b.view_priors):
        assert (pa.image_width, pa.image_height, pa.focal_length, pa.principal_point) == (
            pb.image_width, pb.image_height, pb.focal_length, pb.principal_point)


def _tokens_close(a, b, tol=TOL):
    """Two text files hold the same tokens, numbers to `tol` (absolute
    against max(1, |value|))."""
    ta, tb = open(a).read().split(), open(b).read().split()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            assert x == y
            continue
        assert abs(fx - fy) <= tol * max(1.0, abs(fy)), (x, y)


def _json_close(a, b, tol=TOL):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _json_close(a[k], b[k], tol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _json_close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)
    else:
        assert a == b


def _same_rotations(aa1, aa2, atol=1e-5):
    """Angle-axis at angle pi is sign-ambiguous: compare the matrices."""
    np.testing.assert_allclose(angle_axis_to_rotation_matrix_np(aa1),
                               angle_axis_to_rotation_matrix_np(aa2), atol=atol)


def _obs_keyed_centered(scene):
    return {(int(v), int(t)): scene.obs_uv[o] - scene.intrinsics[scene.view_group[v]][3:5]
            for o, (v, t) in enumerate(zip(scene.obs_view, scene.obs_track))}


def test_npz_checkpoint_roundtrip(tmp_path, scene):
    mine = convert.reconstruction(scene)
    path = str(tmp_path / "scene.npz")
    tio.write_reconstruction(mine, path)
    back = tio.read_reconstruction(path)
    assert (back.num_views(), back.num_tracks(), back.num_observations()) == (
        mine.num_views(), mine.num_tracks(), mine.num_observations())
    np.testing.assert_allclose(back.view_extrinsics, mine.view_extrinsics)
    np.testing.assert_allclose(back.points, mine.points)
    np.testing.assert_allclose(back.intrinsics, mine.intrinsics)
    assert back.view_names == mine.view_names
    np.testing.assert_array_equal(back.obs_uv, mine.obs_uv)
    # Each package reads the other's checkpoint into the same container.
    jpath = str(tmp_path / "jax.npz")
    jio.write_reconstruction(scene, jpath)
    assert_same_reconstruction(tio.read_reconstruction(jpath), back)
    assert_same_reconstruction(convert.reconstruction(jio.read_reconstruction(path)), back)


def test_bundler_roundtrip(tmp_path, scene):
    mine = convert.reconstruction(scene)
    bundle, lists = str(tmp_path / "bundle.out"), str(tmp_path / "list.txt")
    tio.write_bundler_files(mine, bundle, lists)
    back = tio.read_bundler_files(lists, bundle)
    assert (back.num_views(), back.num_tracks()) == (mine.num_views(), mine.num_tracks())
    np.testing.assert_allclose(back.view_extrinsics[:, :3], mine.view_extrinsics[:, :3],
                               atol=1e-6)
    _same_rotations(back.view_extrinsics[:, 3:], mine.view_extrinsics[:, 3:])
    np.testing.assert_allclose(back.points[:, :3] / back.points[:, 3:4], mine.points[:, :3],
                               atol=1e-6)
    keyed = _obs_keyed_centered(mine)
    for o, (v, t) in enumerate(zip(back.obs_view, back.obs_track)):
        np.testing.assert_allclose(back.obs_uv[o], keyed[(int(v), int(t))], atol=1e-6)
    # Across the packages: the same files, each read the same by both.
    jb, jl = str(tmp_path / "j.out"), str(tmp_path / "j.txt")
    jio.write_bundler_files(scene, jb, jl)
    _tokens_close(jb, bundle)
    _tokens_close(jl, lists)
    assert_same_reconstruction(back, convert.reconstruction(jio.read_bundler_files(lists, bundle)),
                               TOL)
    assert_same_reconstruction(tio.read_bundler_files(jl, jb), back, TOL)


def test_nvm_roundtrip(tmp_path, scene):
    mine = convert.reconstruction(scene)
    path = str(tmp_path / "model.nvm")
    tio.export_nvm_file(mine, path)
    back = tio.import_nvm_file(path)
    assert (back.num_views(), back.num_tracks()) == (mine.num_views(), mine.num_tracks())
    np.testing.assert_allclose(back.view_extrinsics[:, :3], mine.view_extrinsics[:, :3],
                               atol=1e-6)
    _same_rotations(back.view_extrinsics[:, 3:], mine.view_extrinsics[:, 3:])
    keyed = _obs_keyed_centered(mine)
    for o, (v, t) in enumerate(zip(back.obs_view, back.obs_track)):
        np.testing.assert_allclose(back.obs_uv[o], keyed[(int(v), int(t))], atol=1e-6)
    jpath = str(tmp_path / "jax.nvm")
    jio.export_nvm_file(scene, jpath)
    _tokens_close(jpath, path)
    assert_same_reconstruction(back, convert.reconstruction(jio.import_nvm_file(path)), TOL)
    assert_same_reconstruction(tio.import_nvm_file(jpath), back, TOL)


def test_json_ply_colmap_nerfstudio(tmp_path, scene):
    mine = convert.reconstruction(scene)
    tio.write_reconstruction_json(mine, str(tmp_path / "r.json"))
    doc = json.load(open(tmp_path / "r.json"))
    assert len(doc["views"]) == mine.num_views() and len(doc["tracks"]) == mine.num_tracks()
    assert tio.write_ply_file(str(tmp_path / "r.ply"), mine)
    assert "element vertex" in open(tmp_path / "r.ply").read().split("end_header")[0]
    assert tio.write_colmap_files(mine, str(tmp_path / "colmap"))
    lines = open(tmp_path / "colmap" / "images.txt").read().splitlines()
    assert len(lines[0].split()) == 10
    assert tio.write_nerfstudio_files(mine, str(tmp_path / "ns"))
    doc = json.load(open(tmp_path / "ns" / "transforms.json"))
    assert len(doc["frames"]) == mine.num_views()
    M = np.asarray(doc["frames"][0]["transform_matrix"])
    np.testing.assert_allclose(M[:3, :3] @ M[:3, :3].T, np.eye(3), atol=1e-6)
    assert tio.write_sdfstudio_files(mine, str(tmp_path / "sdf"))

    # The JAX writers' files hold the same values.
    j = tmp_path / "jax"
    j.mkdir()
    jio.write_reconstruction_json(scene, str(j / "r.json"))
    jio.write_ply_file(str(j / "r.ply"), scene)
    jio.write_colmap_files(scene, str(j / "colmap"))
    jio.write_nerfstudio_files(scene, str(j / "ns"))
    jio.write_sdfstudio_files(scene, str(j / "sdf"))
    for name in ("r.json", "ns/transforms.json", "sdf/meta_data.json"):
        _json_close(json.load(open(tmp_path / name)), json.load(open(j / name)))
    _tokens_close(j / "r.ply", tmp_path / "r.ply")
    for fn in ("cameras.txt", "images.txt", "points3D.txt"):
        _tokens_close(j / "colmap" / fn, tmp_path / "colmap" / fn)


def test_calibration_roundtrip(tmp_path):
    priors = {
        "img1.jpg": CameraIntrinsicsPrior(image_width=640, image_height=480, focal_length=525.0,
                                          principal_point=(320.0, 240.0),
                                          radial_distortion=(0.1, -0.05), latitude=47.0),
        "img2.jpg": CameraIntrinsicsPrior(image_width=800, image_height=600),
    }
    path = str(tmp_path / "calib.json")
    tio.write_calibration(path, priors)
    back = tio.read_calibration(path)
    assert set(back) == set(priors)
    assert back["img1.jpg"].focal_length == 525.0
    assert back["img1.jpg"].radial_distortion == (0.1, -0.05)
    assert back["img2.jpg"].focal_length is None
    jpath = str(tmp_path / "jax.json")
    jio.write_calibration(jpath, {k: JPrior(**vars(p)) for k, p in priors.items()})
    assert open(jpath).read() == open(path).read()
    for k, p in jio.read_calibration(path).items():
        assert convert.camera_intrinsics_prior(p) == back[k]


def _strecha_dir(d, n=4, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        K = np.array([[2759.48 + i, 0.3, 1520.69], [0.0, 2764.16, 1006.81], [0, 0, 1]])
        R = angle_axis_to_rotation_matrix_np(rng.normal(size=3))
        c = rng.normal(size=3) * 5
        rows = [K[0], K[1], K[2], np.zeros(3), *R.T, c]
        text = "\n".join(" ".join(repr(float(x)) for x in r) for r in rows) + "\n3072 2048\n"
        (d / f"{i:04d}.png.camera").write_text(text)


def test_strecha_reads_the_same_in_both(tmp_path):
    _strecha_dir(tmp_path)
    mine = tio.read_strecha_dataset(str(tmp_path))
    ref = convert.reconstruction(jio.read_strecha_dataset(str(tmp_path)))
    assert_same_reconstruction(mine, ref, 1e-12)
    assert mine.view_names[0] == "0000.png" and mine.view_estimated.all()
    assert list(mine.view_group) == [0] * 4
    with pytest.raises(FileNotFoundError):
        tio.read_strecha_dataset(str(tmp_path / "empty"))


def _onedsfm_dir(d, seed=1):
    """Six images (one outside cc.txt, one without a focal length), their
    keypoints, tracks (one through an unknown keypoint, one with a repeated
    view) and the two-view geometries of every pair."""
    rng = np.random.default_rng(seed)
    V, K = 6, 12
    (d / "cc.txt").write_text("0 1 2 3 4\n")
    (d / "list.txt").write_text("".join(
        f"images/img{v}.jpg\n" if v == 2 else f"images/img{v}.jpg 0 {900.0 + 10 * v}\n"
        for v in range(V)))
    coords = []
    for v in range(V):
        coords.append(f"#index = {v}, name = img{v}.jpg, keys = {K}, px = 512.0, py = 384.0, "
                      "focal = 900.0\n")
        for k in range(K):
            x, y = rng.uniform(0, 1024), rng.uniform(0, 768)
            c = rng.integers(0, 256, 3)
            coords.append(f"{k} {x!r} {y!r} 0 0 {c[0]} {c[1]} {c[2]}\n")
    (d / "coords.txt").write_text("".join(coords))
    tracks = []
    for t in range(10):
        views = rng.choice(V, size=3, replace=False)
        feats = rng.integers(0, K, size=3)
        if t == 3:
            feats[1] = K + 5  # an unknown keypoint drops the track
        if t == 5:
            views[2] = views[0]  # one view twice: its second feature is dropped
        tracks.append(f"3 " + " ".join(f"{v} {f}" for v, f in zip(views, feats)))
    (d / "tracks.txt").write_text(f"{len(tracks)}\n" + "\n".join(tracks) + "\n")
    egs = []
    for i in range(V):
        for j in range(i + 1, V):
            R = angle_axis_to_rotation_matrix_np(rng.normal(size=3) * 0.3)
            t = rng.normal(size=3)
            egs.append(f"{i} {j} " + " ".join(repr(float(x)) for x in (*R.ravel(), *t)))
    (d / "EGs.txt").write_text("\n".join(egs) + "\n")


def test_1dsfm_reads_the_same_in_both(tmp_path):
    _onedsfm_dir(tmp_path)
    mine, graph = tio.read_1dsfm(str(tmp_path))
    jrecon, jgraph = jio.read_1dsfm(str(tmp_path))
    assert_same_reconstruction(mine, convert.reconstruction(jrecon), 1e-12)
    assert list(graph.edges) == list(jgraph.edges) and graph.num_edges() == 10
    for key, info in jgraph.edges.items():
        got = graph.edges[key]
        np.testing.assert_allclose(got.rotation_2, info.rotation_2, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.position_2, info.position_2, rtol=0, atol=1e-12)
        assert (got.focal_length_1, got.focal_length_2, got.num_verified_matches,
                got.visibility_score) == (info.focal_length_1, info.focal_length_2,
                                          info.num_verified_matches, info.visibility_score)
    assert mine.num_tracks() == 9 and mine.view_priors[2].focal_length is None
    assert os.path.basename(mine.view_names[0]) == "img0.jpg"
