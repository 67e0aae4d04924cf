"""`run_images_pipeline`, the port (`pytheiasfm_tpu_torch/pipelines/images.py`)
against the JAX package's `pipelines/images.py`, on the CPU.

Scene: views 0-5 of the rendered scene (`tools/image_scene.py`, seed 0;
neighbours on the ring, 11.25 deg apart), written as 1024x768 PGM files and
read at max_dim=400 (PIL's BILINEAR resize in both packages: 400x300),
512 features, the pipeline's other defaults (global estimator, all pairs,
the guided rematch). At 320x240 the scene gives about 120 SIFT features a
view and most pairs fall short of the 30 verified matches the pipeline
asks for. Stage-1 RANSAC draws from `jax.random` in one package and from a
torch generator in the other, so the parity is statistical: the same
number of views estimated, and the port's median rotation error (after
the best global rotation) and median position error (after a Umeyama
Sim(3) alignment) against ground truth at most 1.5x the JAX package's.
Features per image within 1% (SIFT parity, `test_torch_sift.py`).

The `slow` test renders the full-width scene (32 views, 1024x768) and runs
the JAX package's pipeline on it at its defaults, with the matcher's
RANSAC key 0 (the package's own) and key 1 (to see how far the draws alone
move it); it prints the constants that `chip_smoke.py` phase 7 holds the
card to. On the CPU the JAX package's batched descriptor matching and
stage-1 verifier hold every pair in one program (past the 96 GiB of an
H100 machine's host), so the test runs them over chunks of pairs, with the
same per-pair inputs and RANSAC keys: the same results. About 17 minutes a
key on that host's 8 cores; not for a small machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_images_pipeline.py -m slow -s
"""

import sys
import time

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.pipelines import images as jimages
from pytheiasfm_tpu.sfm.exif_reader import ExifReader as JExif
from pytheiasfm_tpu_torch.pipelines import images as timages
from pytheiasfm_tpu_torch.sfm.exif_reader import ExifReader as TExif
from pytheiasfm_tpu_torch.tools import image_scene, images_sfm
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

VIEWS = list(range(6))
RUN = dict(max_dim=400, max_features=512)
ERR_RATIO = 1.5
FEATURE_TOL_REL = 0.01


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    images, extrinsics = image_scene.render(0, views=VIEWS)
    paths = image_scene.write_views(tmp_path_factory.mktemp("scene"), images, VIEWS)
    return paths, extrinsics


@pytest.fixture(scope="module")
def runs(scene):
    paths, extrinsics = scene
    want = jimages.run_images_pipeline(paths, **RUN)
    got = timages.run_images_pipeline(paths, **RUN, device="cpu")
    return [(models, stats, images_sfm.accuracy(models, extrinsics, VIEWS))
            for models, stats in (want, got)]


def test_views_estimated_equal(runs):
    (_, want, acc_w), (_, got, acc_g) = runs
    assert got["models"] >= 1 and want["models"] >= 1
    assert got["views_estimated"] == want["views_estimated"] >= 5
    assert acc_g[0] == got["views_estimated"]
    assert got["tracks_estimated"] >= 100


@pytest.mark.parametrize("metric", [1, 2], ids=["rotation", "position"])
def test_errors_within_jax(runs, metric):
    (_, _, acc_w), (_, _, acc_g) = runs
    assert np.isfinite(acc_g[metric])
    assert acc_g[metric] <= ERR_RATIO * acc_w[metric], (acc_g, acc_w)


def test_stats_match_jax(runs):
    (_, want, _), (_, got, _) = runs
    assert set(got) == set(want)
    fw = np.asarray(want["features_per_image"])
    fg = np.asarray(got["features_per_image"])
    assert np.all(np.abs(fg - fw) <= FEATURE_TOL_REL * fw), (fg, fw)
    assert all(got[k] > 0 for k in ("t_extract_s", "t_match_verify_s", "t_reconstruct_s"))


def test_runs_on_the_card_by_default(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        timages.run_images_pipeline(scene[0])


def _jpeg(path, exif_35mm=None):
    from PIL import Image

    img = Image.fromarray(np.full((60, 80), 128, np.uint8))
    exif = Image.Exif()
    if exif_35mm is not None:
        exif[0x8769] = {0xA405: exif_35mm}  # Exif IFD: FocalLengthIn35mmFilm
    img.save(path, exif=exif)


def test_prior_for_matches_jax(tmp_path, monkeypatch):
    """The EXIF branch (a .jpg with a 35 mm focal length, and one without),
    and the default for other files; without PIL the EXIF branch falls back
    to the default."""
    with_focal = tmp_path / "f.jpg"
    without = tmp_path / "n.jpg"
    _jpeg(with_focal, exif_35mm=50)
    _jpeg(without)
    pgm = tmp_path / "a.pgm"
    image_scene.write_pgm(pgm, np.zeros((60, 80), np.uint8))
    cases = [(with_focal, (30, 40)), (without, (60, 80)), (pgm, (60, 80))]
    for path, shape in cases:
        want = jimages._prior_for(str(path), shape, JExif())
        got = timages._prior_for(str(path), shape, TExif())
        assert (got.focal_length, got.principal_point, got.image_width, got.image_height) == (
            want.focal_length, want.principal_point, want.image_width, want.image_height)
    assert timages._prior_for(str(with_focal), (60, 80), TExif()).focal_length == 80 * 50 / 36
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert timages._prior_for(str(with_focal), (60, 80), TExif()).focal_length == 1.2 * 80


def _chunked(fn, size: int, num_batched: int):
    """`fn` over chunks of `size` along the leading axis of its first
    `num_batched` arguments, the outputs concatenated: the same results for
    a function that treats each leading index on its own."""
    import jax
    import jax.numpy as jnp

    def run(*args, **kwargs):
        P = args[0].shape[0]
        outs = [fn(*(a[i:i + size] for a in args[:num_batched]), *args[num_batched:], **kwargs)
                for i in range(0, P, size)]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)

    return run


def jax_run_chunked(paths, monkeypatch, match_chunk=32, verify_chunk=16, **kwargs):
    """The JAX package's `run_images_pipeline` with its descriptor matching
    and its stage-1 verifier run over chunks of pairs (`_chunked`)."""
    from pytheiasfm_tpu.matching import matcher as jmatcher
    from pytheiasfm_tpu.sfm import two_view as jtwo_view

    monkeypatch.setattr(jmatcher, "match_descriptors_batch_auto",
                        _chunked(jmatcher.match_descriptors_batch_auto, match_chunk, 4))
    make = jtwo_view.make_batched_verifier
    monkeypatch.setattr(jtwo_view, "make_batched_verifier",
                        lambda *a, **k: _chunked(make(*a, **k), verify_chunk, 5))
    return jimages.run_images_pipeline(paths, **kwargs)


def test_chunked_jax_run_is_the_same(scene, runs, monkeypatch):
    """The chunked JAX run (the `slow` test's, here in chunks of 4 and 3
    pairs) gives the unchunked one's results on the test scene."""
    want_models, want, _ = runs[0]
    models, stats = jax_run_chunked(scene[0], monkeypatch, 4, 3, **RUN)
    for key in ("features_per_image", "verified_pairs", "models", "views_estimated",
                "tracks_estimated"):
        assert stats[key] == want[key], key
    np.testing.assert_array_equal(models[0].view_extrinsics, want_models[0].view_extrinsics)


def _full_size_jax_run(tmp_path, monkeypatch, ransac_key, label, **kwargs):
    """The JAX package's pipeline on the full-width scene with the matcher's
    RANSAC key `ransac_key`; prints its constants. Returns its stats."""
    import jax

    key = jax.random.PRNGKey
    monkeypatch.setattr(jax.random, "PRNGKey", lambda seed: key(seed + ransac_key))
    t0 = time.perf_counter()
    images, extrinsics = image_scene.render()
    t_render = time.perf_counter() - t0
    paths = image_scene.write_views(tmp_path, images)
    t0 = time.perf_counter()
    models, stats = jax_run_chunked(paths, monkeypatch, **kwargs)
    t_jax = time.perf_counter() - t0
    views, rot, pos = images_sfm.accuracy(models, extrinsics)
    keypoints = stats["features_per_image"]  # under the 2048 cut: every keypoint
    print(f"\n[{label}] scene sha256 {image_scene.images_sha256(images)} (rendered in "
          f"{t_render:.1f} s); SIFT features a view: min {min(keypoints)}, max "
          f"{max(keypoints)}")
    print(f"[{label}] JAX CPU, RANSAC key {ransac_key} ({t_jax:.1f} s): t_extract_s "
          f"{stats['t_extract_s']:.1f}, t_match_verify_s {stats['t_match_verify_s']:.1f}, "
          f"t_reconstruct_s {stats['t_reconstruct_s']:.1f}; verified pairs "
          f"{stats['verified_pairs']}, models {stats['models']}, views estimated "
          f"{stats['views_estimated']}, tracks estimated {stats['tracks_estimated']}; largest "
          f"model {views} views, median rotation error {rot!r} deg, median position error "
          f"{pos!r} x the ring radius")
    return stats


@pytest.mark.slow
@pytest.mark.parametrize("ransac_key", [0, 1])
def test_full_size_jax_constants(tmp_path, monkeypatch, ransac_key):
    """The JAX package's pipeline on the full-width scene at its defaults;
    prints what `chip_smoke.py` phase 7 holds the card to, and holds the
    scene's tuning: at least 1500 SIFT keypoints a view and at least 30 of
    32 views estimated. With `ransac_key=1` the matcher's RANSAC key is
    `PRNGKey(1)` in place of its `PRNGKey(0)`: the same pipeline on another
    random stream, which measures how far the reference moves with the
    draws alone."""
    stats = _full_size_jax_run(tmp_path, monkeypatch, ransac_key, "images")
    keypoints = stats["features_per_image"]
    assert min(keypoints) >= 1500
    assert stats["views_estimated"] >= 30


# The images command's defaults (`tools/sfm_pipeline_images.py`, and the
# port's `tools/sfm_pipeline_images.py`): Lowe's ratio 0.85 and 15 inliers,
# where `run_images_pipeline` takes 0.8 and 30.
COMMAND_DEFAULTS = dict(lowes_ratio=0.85, min_num_inlier_matches=15)


@pytest.mark.slow
@pytest.mark.parametrize("ransac_key", [0, 1])
def test_full_size_jax_constants_of_the_images_command(tmp_path, monkeypatch, ransac_key):
    """As `test_full_size_jax_constants`, at the images command's defaults:
    prints what `chip_smoke.py` phase 19(a) holds the card to.

        JAX_PLATFORMS=cpu python -m pytest tests/test_torch_images_pipeline.py -m slow -s \\
            -k images_command
    """
    stats = _full_size_jax_run(tmp_path, monkeypatch, ransac_key, "images command",
                               **COMMAND_DEFAULTS)
    assert stats["views_estimated"] >= 1
