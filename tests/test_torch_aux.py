"""The port's MVS view selection, colouring and fisher-vector stub against
the JAX package's, on the CPU.

`view_selection_mvsnet` gives the JAX function's neighbour lists on
`random_reconstruction` (scores to 1e-5 relative: both sum f32 Gaussians
of f32 angles) and meets `tests/test_aux_parity.py`'s bars;
`sample_bilinear` and `colorize_reconstruction` give the JAX functions'
colours (f64, exact); `FisherVectorExtractor` constructs and refuses to
train or extract, as the reference's stub does.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching.fisher_vector import FisherVectorExtractor as JFisher
from pytheiasfm_tpu.mvs import view_selection_mvsnet as jax_view_selection
from pytheiasfm_tpu.sfm.colorize_reconstruction import colorize_reconstruction as jax_colorize
from pytheiasfm_tpu.sfm.colorize_reconstruction import sample_bilinear as jax_sample
from pytheiasfm_tpu.utils.synthetic import random_reconstruction
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.matching import FisherVectorExtractor
from pytheiasfm_tpu_torch.mvs import pairwise_view_scores, view_selection_mvsnet
from pytheiasfm_tpu_torch.sfm.colorize_reconstruction import (
    colorize_reconstruction,
    sample_bilinear,
)
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

CPU = "cpu"
SCORE_TOL = 1e-5


def _same_selection(got, want):
    assert got.keys() == want.keys()
    for v in want:
        assert [n for _, n in got[v]] == [n for _, n in want[v]], v
        for (a, _), (b, _) in zip(got[v], want[v]):
            assert abs(a - b) <= SCORE_TOL * abs(b)


@pytest.mark.parametrize("views,tracks,neighbors,min_common", [(8, 150, 3, 5), (12, 700, 4, 10)])
def test_view_selection_matches_jax(views, tracks, neighbors, min_common):
    recon = random_reconstruction(num_views=views, num_tracks=tracks)
    want = jax_view_selection(recon, neighbors, min_common_tracks=min_common)
    got = view_selection_mvsnet(convert.reconstruction(recon), neighbors,
                                min_common_tracks=min_common, device=CPU)
    _same_selection(got, want)


def test_view_selection_mvsnet():
    """`tests/test_aux_parity.py::test_view_selection_mvsnet` on the port."""
    recon = convert.reconstruction(random_reconstruction(num_views=8, num_tracks=150))
    sel = view_selection_mvsnet(recon, num_neighbors=3, min_common_tracks=5, device=CPU)
    assert set(sel) == set(range(8))
    for v, neighbors in sel.items():
        assert 1 <= len(neighbors) <= 3
        scores = [s for s, _ in neighbors]
        assert scores == sorted(scores, reverse=True)
        assert all(n != v for _, n in neighbors)
        top = neighbors[0][1]
        assert min((top - v) % 8, (v - top) % 8) <= 2


def test_view_selection_respects_estimated_masks():
    """`tests/test_aux_parity.py::test_view_selection_respects_estimated_masks`
    on the port, and against the JAX function."""
    jrecon = random_reconstruction(num_views=6, num_tracks=100)
    jrecon.view_estimated[4:] = False
    jrecon.track_estimated[::7] = False
    sel = view_selection_mvsnet(convert.reconstruction(jrecon), num_neighbors=2,
                                min_common_tracks=5, device=CPU)
    assert set(sel) == {0, 1, 2, 3}
    assert all(n in {0, 1, 2, 3} for nbrs in sel.values() for _, n in nbrs)
    _same_selection(sel, jax_view_selection(jrecon, 2, min_common_tracks=5))
    jrecon.view_estimated[1:] = False
    assert view_selection_mvsnet(convert.reconstruction(jrecon), 2, device=CPU) == {0: []}


def test_pairwise_view_scores_chunks_sum_to_the_whole():
    rng = np.random.default_rng(0)
    centers, points = rng.normal(size=(5, 3)) * 10, rng.normal(size=(300, 3))
    incidence = rng.random((5, 300)) < 0.6
    whole = pairwise_view_scores(centers, points, incidence, chunk=300, device=CPU)
    parts = pairwise_view_scores(centers, points, incidence, chunk=64, device=CPU)
    np.testing.assert_array_equal(whole[1], parts[1])
    np.testing.assert_allclose(whole[0], parts[0], rtol=1e-6)
    np.testing.assert_array_equal(whole[1], incidence.astype(float) @ incidence.T)


def test_sample_bilinear_matches_jax():
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    uv = np.concatenate([rng.uniform(-2, 32, (50, 2)), [[29.0, 19.0], [0.0, 0.0]]])
    want = jax_sample(image, uv)
    np.testing.assert_array_equal(sample_bilinear(image, uv), want)
    got = sample_bilinear(torch.as_tensor(image), torch.as_tensor(uv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sample_bilinear(image[..., 0], uv), jax_sample(image[..., 0], uv))


def test_colorize_reconstruction_matches_jax(tmp_path):
    """`tests/test_aux_parity.py::test_colorize_reconstruction`'s gradient
    images; the port's colours equal the JAX function's, and meet its bars."""
    from PIL import Image

    jrecon = random_reconstruction(num_views=4, num_tracks=30)
    w, h = jrecon.view_priors[0].image_width, jrecon.view_priors[0].image_height
    for name in jrecon.view_names[:3]:  # the fourth view's image is missing
        img = np.zeros((h, w, 3), np.uint8)
        img[:, :, 0] = np.minimum(np.arange(w)[None, :] * 255 // max(w - 1, 1), 255)
        img[:, :, 1] = 80
        img[:, :, 2] = np.arange(h)[:, None] * 255 // max(h - 1, 1)
        Image.fromarray(img).save(tmp_path / f"{name}.png")
    recon = convert.reconstruction(jrecon)
    n = colorize_reconstruction(recon, str(tmp_path), device=CPU)
    assert n == jax_colorize(jrecon, str(tmp_path)) and n > 0
    np.testing.assert_array_equal(recon.track_colors, jrecon.track_colors)
    for t in range(recon.num_tracks()):
        rows = [r for r in recon.track_observations(t) if recon.obs_view[r] < 3]
        if rows:
            expect = np.mean(recon.obs_uv[rows, 0] * 255.0 / (w - 1))
            assert abs(float(recon.track_colors[t, 0]) - expect) < 3.0
            assert abs(int(recon.track_colors[t, 1]) - 80) <= 1


def test_colorize_with_a_loader_and_missing_images(tmp_path):
    recon = convert.reconstruction(random_reconstruction(num_views=3, num_tracks=10))
    assert colorize_reconstruction(recon, "/nonexistent_dir", device=CPU) == 0
    for name in recon.view_names:
        (tmp_path / name).write_bytes(b"")
    gray = colorize_reconstruction(recon, str(tmp_path), device=CPU,
                                   image_loader=lambda path: np.full((600, 800), 37, np.uint8))
    assert gray > 0
    seen = [t for t in range(recon.num_tracks()) if recon.track_observations(t)]
    assert (recon.track_colors[seen] == 37).all()


def test_fisher_vector_is_stubbed_as_in_the_reference():
    fv = FisherVectorExtractor()
    assert fv.options.num_gmm_clusters == JFisher().options.num_gmm_clusters == 16
    for call in (fv.train, fv.extract_global_descriptor):
        with pytest.raises(NotImplementedError, match="stubbed"):
            call(np.zeros((4, 128)))

    def message(extractor):
        with pytest.raises(NotImplementedError) as info:
            extractor.train()
        return str(info.value)

    assert message(fv) == message(JFisher())
