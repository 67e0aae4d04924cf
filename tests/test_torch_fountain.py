"""The port's tracks -> reconstruction -> ATE pipeline
(`pytheiasfm_tpu_torch/pipelines/fountain.py`) against the JAX package's,
on the CPU.

On the 8-view scene of `tests/test_global_estimator.py` (150 tracks, 0.3 px
noise) written as the reference's `.recon` files (its tracks, and its
ground truth): `strip_geometry` (all tracks and the longest 100) and
`_pair_correspondences` give exactly the JAX package's containers and rows,
`sim3_ate_mm` its errors to 1e-9, and `evaluate` meets the ground-truth bar
that the JAX function meets on the same files (all 8 cameras, the same
edges, median ATE under MEDIAN_ATE_BAR_MM). `build_view_graph` with
two fifths of one view's observations moved off their tracks runs its second
rung and keeps the JAX package's edges.

The JAX verification and estimator take minutes to trace here, so their
results on these files are recorded in `tests/data/torch_fountain_jax.npz`
by `JAX_PLATFORMS=cpu python tests/torch_io_reference.py record`; the `slow`
test `test_record_is_the_jax_package_s` computes them again. The reference's
own fixture (`fountain11.bin`) runs when it is present, as in
`tests/test_fountain_e2e.py`.
"""

import copy
import os
from pathlib import Path

import numpy as np
import pytest

from pytheiasfm_tpu.io import theia_recon as jtr
from pytheiasfm_tpu.pipelines import fountain as jf
from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.io import theia_recon as ttr
from pytheiasfm_tpu_torch.pipelines import fountain as tf
from pytheiasfm_tpu_torch.utils import counters
from test_torch_theia_recon import assert_same_reconstruction
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

FOUNTAIN, GT_FOUNTAIN = tf.DEFAULT_FOUNTAIN, tf.DEFAULT_GT
RECORD = Path(__file__).resolve().parent / "data" / "torch_fountain_jax.npz"
SCENE = SyntheticSceneOptions(num_views=8, num_tracks=150, pixel_noise=0.3, seed=7)
MEDIAN_ATE_BAR_MM = 20.0  # the ring's radius is 10 (10,000 "mm")
_KEYS = ("median_mm", "mean_mm", "max_mm", "cameras", "edges", "tracks_used")


def write_scene(directory, contaminated=False):
    """The scene's tracks and its ground truth as `.recon` files (the JAX
    writer's). With `contaminated`, two fifths of view 0's observations swap
    tracks among themselves, so its pairs hold outliers."""
    recon, ext, points = generate_scene(SCENE)
    if contaminated:
        rows = np.flatnonzero(recon.obs_view == 0)
        moved = rows[: 2 * len(rows) // 5]
        recon.obs_uv[moved] = recon.obs_uv[np.roll(moved, 1)]
    gt = copy.deepcopy(recon)
    gt.view_extrinsics[:] = ext
    gt.view_estimated[:] = True
    gt.points[:, :3] = points
    gt.points[:, 3] = 1.0
    gt.track_estimated[:] = True
    paths = (os.path.join(directory, "tracks.recon"), os.path.join(directory, "gt.recon"))
    jtr.write_theia_reconstruction(recon, paths[0])
    jtr.write_theia_reconstruction(gt, paths[1])
    return paths


def jax_outputs(directory):
    """The JAX package's `evaluate` on the clean scene and its
    `build_view_graph` edges on both scenes."""
    rec = {}
    tracks, gt = write_scene(directory)
    res = jf.evaluate(fountain_path=tracks, gt_path=gt)
    rec["evaluate"] = np.array([res[k] for k in _KEYS], np.float64)
    for label, contaminated in (("clean", False), ("contaminated", True)):
        tracks, _ = write_scene(directory, contaminated)
        recon = jf.strip_geometry(jtr.read_theia_reconstruction(tracks))
        rec[f"edges/{label}"] = np.array(sorted(jf.build_view_graph(recon).edges), np.int64)
    return rec


def save_record(path=RECORD, directory=None):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        np.savez_compressed(path, **jax_outputs(directory or tmp))


@pytest.fixture(scope="module")
def record():
    with np.load(RECORD) as z:
        return dict(z)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("fountain")))


@pytest.mark.parametrize("max_tracks", [None, 100])
def test_strip_geometry_matches_jax(files, max_tracks):
    ref = jf.strip_geometry(jtr.read_theia_reconstruction(files[0]), max_tracks=max_tracks)
    got = tf.strip_geometry(ttr.read_theia_reconstruction(files[0]), max_tracks=max_tracks)
    assert_same_reconstruction(got, convert.reconstruction(ref))
    assert got.num_tracks() == (max_tracks or SCENE.num_tracks)


@pytest.mark.parametrize("min_inliers", [5, 30])
def test_pair_correspondences_match_jax(files, min_inliers):
    recon = ttr.read_theia_reconstruction(files[0])
    pairs, rows = tf._pair_correspondences(recon, min_inliers)
    want_pairs, want_rows = jf._pair_correspondences(jtr.read_theia_reconstruction(files[0]),
                                                     min_inliers)
    assert pairs == want_pairs and len(pairs) > 0
    for p in pairs:
        for a, b in zip(rows[p], want_rows[p]):
            np.testing.assert_array_equal(a, b)


def test_sim3_ate_mm_matches_jax(files):
    gt = ttr.read_theia_reconstruction(files[1])
    est = copy.deepcopy(gt)
    rng = np.random.default_rng(0)
    est.view_extrinsics[:, :3] = 0.3 * est.view_extrinsics[:, :3] + rng.normal(size=(8, 3)) * 0.01
    est.view_estimated[5] = False
    err, n = tf.sim3_ate_mm(est, gt)
    jgt = jtr.read_theia_reconstruction(files[1])
    jest = copy.deepcopy(jgt)
    jest.view_extrinsics[:] = est.view_extrinsics
    jest.view_estimated[:] = est.view_estimated
    want, jn = jf.sim3_ate_mm(jest, jgt)
    assert n == jn == 7
    np.testing.assert_allclose(err, want, rtol=0, atol=1e-9 * np.max(want))


def test_evaluate_meets_the_jax_bar(files, record):
    want = dict(zip(_KEYS, record["evaluate"]))
    # The bar holds for the JAX function on these files.
    assert want["cameras"] == SCENE.num_views and want["median_mm"] < MEDIAN_ATE_BAR_MM
    res = tf.evaluate(fountain_path=files[0], gt_path=files[1], device="cpu")
    assert res["success"] and res["cameras"] == want["cameras"]
    assert res["edges"] == want["edges"] and res["tracks_used"] == want["tracks_used"]
    assert res["median_mm"] < MEDIAN_ATE_BAR_MM, res
    assert res["dispatch_counts"]["verify_chunk"] == 1


def test_second_rung_keeps_the_jax_edges(tmp_path, record):
    tracks, _ = write_scene(str(tmp_path), contaminated=True)
    recon = tf.strip_geometry(ttr.read_theia_reconstruction(tracks))
    counters.reset()
    graph = tf.build_view_graph(recon, device="cpu")
    # Rung 1, then the pairs of view 0 again at the full budget.
    assert counters.snapshot()["verify_chunk"] == 2
    assert sorted(graph.edges) == [tuple(e) for e in record["edges/contaminated"]]
    clean = tf.strip_geometry(ttr.read_theia_reconstruction(write_scene(str(tmp_path))[0]))
    assert sorted(tf.build_view_graph(clean, device="cpu").edges) == [
        tuple(e) for e in record["edges/clean"]]


@pytest.mark.skipif(not (os.path.exists(FOUNTAIN) and os.path.exists(GT_FOUNTAIN)),
                    reason="reference fountain fixtures unavailable")
def test_fountain11_fixture():
    """The reference's fountain-11 tracks (700 longest) through the port's
    `evaluate`: `tests/test_fountain_e2e.py`'s global-estimator bars."""
    res = tf.evaluate(max_tracks=700, device="cpu")
    assert res["cameras"] == 11
    assert res["median_mm"] < 6.0 and res["max_mm"] < 15.0, res


@pytest.mark.slow
def test_record_is_the_jax_package_s(tmp_path):
    """The JAX package on the record's files gives the record (1e-9: its
    rounding on another CPU)."""
    rec = jax_outputs(str(tmp_path))
    with np.load(RECORD) as z:
        for key, value in rec.items():
            np.testing.assert_allclose(z[key], value, rtol=1e-9, err_msg=key)
