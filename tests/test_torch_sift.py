"""The port's SIFT (`pytheiasfm_tpu_torch/features/sift.py`) against the JAX
package's `features/sift.py`, on the CPU.

Images: the blob image of `tests/test_sift.py` (256x256) and the textured
image of `tests/test_sift_quality.py` (320x320) with its perspective warp,
upright and oriented. Bars: in f32 (both packages' default) at least 99.5%
of the keypoints identical (position and level), the descriptors of the
common keypoints within 1e-5 (max abs) and their responses within 1e-6
(abs; responses are |DoG| values of 0.015 and up). In f64 (the JAX
functions driven with a float64 image and float64 blur kernels) every
keypoint identical, in the same order. The PGM reader is held against the
JAX `load_grayscale` (PIL) on the same files.
"""

import sys

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.features import sift as jsift
from pytheiasfm_tpu_torch.features import sift as tsift
from pytheiasfm_tpu_torch.tools import image_scene
from test_sift import _blob_image
from test_sift_quality import HOMOGRAPHIES, _textured, _warp
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

MIN_SHARED_F32 = 0.995
DESC_TOL = 1e-5
RESP_TOL = 1e-6


def _images():
    blob, _ = _blob_image(np.random.default_rng(7))
    tex = _textured(np.random.default_rng(42))
    return {"blob": blob, "textured": tex,
            "warped": _warp(tex, HOMOGRAPHIES["perspective"])}


IMAGES = _images()


def _jax_f64(image, params):
    """The JAX `detect_and_describe` loop in float64: the image and the blur
    kernels (the module's f32-rounded values) as float64."""
    import jax.numpy as jnp

    kernel32 = jsift._gaussian_kernel1d

    def kernel64(sigma):
        return kernel32(sigma).astype(np.float64)

    mp = pytest.MonkeyPatch()
    mp.setattr(jsift, "_gaussian_kernel1d", kernel64)
    try:
        base = float(np.sqrt(max(params.sigma0**2 - 0.5**2, 1e-6)))
        img = jsift._blur(jnp.asarray(image, jnp.float64), kernel64(base))
        k = 2.0 ** (1.0 / params.scales_per_octave)
        kps, scales, descs, resps = [], [], [], []
        for o in range(params.num_octaves):
            if min(img.shape) < 4 * params.descriptor_patch:
                break
            score, yx, lvl, valid, desc, img = jsift._extract_octave(img, params)
            sel = np.asarray(valid)
            yx, lvl = np.asarray(yx)[sel], np.asarray(lvl)[sel]
            kps.append((np.stack([yx[:, 1], yx[:, 0]], -1) + 0.5) * 2.0**o - 0.5)
            scales.append(params.sigma0 * k ** (lvl + 1) * 2.0**o)
            descs.append(np.asarray(desc)[sel])
            resps.append(np.asarray(score)[sel])
    finally:
        mp.undo()
    rs = np.concatenate(resps)
    order = np.argsort(-rs, kind="stable")
    return (np.concatenate(kps)[order], np.concatenate(scales)[order],
            np.concatenate(descs)[order], rs[order])


def _keyed(out):
    kp, sc = out[0], out[1]
    return {(float(x), float(y), float(s)): i for i, ((x, y), s) in enumerate(zip(kp, sc))}


@pytest.mark.parametrize("upright", [True, False], ids=["upright", "oriented"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_and_describe_matches_jax_f32(name, upright):
    image = IMAGES[name]
    want = jsift.detect_and_describe(image, jsift.SiftParams(num_octaves=3, upright=upright))
    got = tsift.detect_and_describe(image, tsift.SiftParams(num_octaves=3, upright=upright),
                                    device="cpu")
    assert got[2].dtype == np.float32 and got[3].dtype == np.float32
    kw, kg = _keyed(want), _keyed(got)
    common = sorted(set(kw) & set(kg))
    assert len(kw) >= 30
    assert len(common) >= MIN_SHARED_F32 * max(len(kw), len(kg)), (len(kw), len(kg), len(common))
    iw = [kw[c] for c in common]
    ig = [kg[c] for c in common]
    assert np.abs(got[2][ig] - want[2][iw]).max() <= DESC_TOL
    assert np.abs(got[3][ig] - want[3][iw]).max() <= RESP_TOL


@pytest.mark.parametrize("upright", [True, False], ids=["upright", "oriented"])
@pytest.mark.parametrize("name", ["blob", "textured"])
def test_detect_and_describe_matches_jax_f64(name, upright):
    image = IMAGES[name]
    params = dict(num_octaves=3, upright=upright)
    want = _jax_f64(image, jsift.SiftParams(**params))
    got = tsift.detect_and_describe(image, tsift.SiftParams(**params), device="cpu",
                                    dtype=torch.float64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-12)


def test_top_k_keeps_the_lowest_index_of_equal_scores():
    """A per-octave cap below the number of candidates: equal responses (a
    blob image copied side by side gives each twice) are kept lowest flat
    index first, as `lax.top_k` keeps them."""
    blob, _ = _blob_image(np.random.default_rng(3), H=128, W=128, n=10)
    image = np.concatenate([blob, blob], axis=1)
    for cap in (3, 5, 8):
        want = jsift.detect_and_describe(image, jsift.SiftParams(num_octaves=1,
                                                                 max_features_per_octave=cap))
        got = tsift.detect_and_describe(image, tsift.SiftParams(num_octaves=1,
                                                                max_features_per_octave=cap),
                                        device="cpu")
        assert len(np.unique(want[3])) < len(want[3])  # ties present
        np.testing.assert_array_equal(got[0], want[0])


def test_pgm_reader_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    plain = tmp_path / "plain.pgm"
    image_scene.write_pgm(plain, image)
    commented = tmp_path / "commented.pgm"
    commented.write_bytes(b"P5\n# a comment\n53 37\n# another\n255\n" + image.tobytes())
    for path in (plain, commented):
        got = tsift.load_grayscale(str(path))
        want = jsift.load_grayscale(str(path))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        # A resize goes through PIL in both packages.
        np.testing.assert_array_equal(tsift.load_grayscale(str(path), max_dim=40),
                                      jsift.load_grayscale(str(path), max_dim=40))


def test_loader_without_pil(tmp_path, monkeypatch):
    """Without PIL a PGM that needs no resize still loads; a resize, or any
    other format, raises an ImportError that names PIL."""
    from PIL import Image

    image = np.random.default_rng(1).integers(0, 256, (20, 30), dtype=np.uint8)
    pgm = tmp_path / "a.pgm"
    image_scene.write_pgm(pgm, image)
    png = tmp_path / "a.png"
    Image.fromarray(image).save(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tsift.load_grayscale(str(pgm)), image / np.float32(255.0))
    for path, max_dim in ((pgm, 16), (png, None)):
        with pytest.raises(ImportError, match="PIL"):
            tsift.load_grayscale(str(path), max_dim=max_dim)


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tsift.detect_and_describe(IMAGES["blob"])
