"""The port's `TrackBuilder` (`pytheiasfm_tpu_torch/sfm/track_builder.py`)
and the union-find it runs (`native.uf_components`) against the JAX
package's, on the CPU.

Correspondences: 6 views, chains of features matched across random view
pairs (tracks of 2 to 7 views), some components that hold two features of
one view (inconsistent, dropped), components shorter than
`min_track_length` and longer than `max_track_length`, and features
repeated across matches (keyed by pixel). Bars: the same tracks, as sets
of (view, pixel) observations, and the same container arrays row for row
(the host work is deterministic).
"""

import numpy as np
import pytest

from pytheiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from pytheiasfm_tpu.sfm.track_builder import TrackBuilder as JBuilder
from pytheiasfm_tpu_torch import native
from pytheiasfm_tpu_torch.sfm.reconstruction import Reconstruction as TRecon
from pytheiasfm_tpu_torch.sfm.track_builder import TrackBuilder as TBuilder
from pytheiasfm_tpu_torch.sfm.view_graph import UnionFind

NUM_VIEWS = 6


def _matches(seed, num_chains=120):
    """[(view1, view2, points1 [k, 2], points2 [k, 2])]: each chain is one
    3-D point seen by a random set of views, matched along consecutive
    views; a few chains also match a second feature of one of its views."""
    rng = np.random.default_rng(seed)
    pairs = {}
    for _ in range(num_chains):
        views = rng.permutation(NUM_VIEWS)[: rng.integers(2, NUM_VIEWS + 1)]
        px = {int(v): np.round(rng.uniform(0, 640, 2), 3) for v in views}
        links = list(zip(views[:-1], views[1:]))
        if rng.uniform() < 0.1:  # a second feature of views[0]: inconsistent
            other = int(views[-1])
            pairs.setdefault((int(views[0]), other), []).append(
                (np.round(rng.uniform(0, 640, 2), 3), px[other]))
        for a, b in links:
            pairs.setdefault((int(a), int(b)), []).append((px[int(a)], px[int(b)]))
    return [(a, b, np.stack([p for p, _ in c]), np.stack([q for _, q in c]))
            for (a, b), c in sorted(pairs.items())]


def _build(builder_cls, recon_cls, matches, **kw):
    recon = recon_cls()
    for v in range(NUM_VIEWS):
        recon.add_view(f"v{v}")
    builder = builder_cls(**kw)
    for a, b, p1, p2 in matches:
        builder.add_match(a, b, p1, p2)
    return builder.build_tracks(recon), recon


def _track_sets(recon):
    return {
        frozenset((int(recon.obs_view[r]), *map(float, recon.obs_uv[r]))
                  for r in recon.track_observations(t))
        for t in range(recon.num_tracks())
    }


@pytest.mark.parametrize("lengths", [(2, 50), (3, 50), (2, 4)], ids=["default", "min3", "max4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_track_builder_matches_jax(seed, lengths):
    kw = dict(min_track_length=lengths[0], max_track_length=lengths[1])
    matches = _matches(seed)
    n_want, want = _build(JBuilder, JRecon, matches, **kw)
    n_got, got = _build(TBuilder, TRecon, matches, **kw)
    assert n_got == n_want >= 20
    assert _track_sets(got) == _track_sets(want)
    np.testing.assert_array_equal(got.obs_view, want.obs_view)
    np.testing.assert_array_equal(got.obs_track, want.obs_track)
    np.testing.assert_array_equal(got.obs_uv, want.obs_uv)
    np.testing.assert_array_equal(got.track_reference_view, want.track_reference_view)
    assert [got.tracks_in_view(v) for v in range(NUM_VIEWS)] == [
        want.tracks_in_view(v) for v in range(NUM_VIEWS)]
    lens = [len(got.track_observations(t)) for t in range(got.num_tracks())]
    assert min(lens) >= lengths[0] and max(lens) <= lengths[1]


def test_no_correspondences_build_no_tracks():
    assert _build(TBuilder, TRecon, [])[0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uf_components_against_union_find(seed):
    """The native components against the plain `UnionFind`: the same
    partition of the nodes."""
    rng = np.random.default_rng(seed)
    n = 500
    a, b = rng.integers(0, n, 300), rng.integers(0, n, 300)
    roots = native.uf_components(n, a, b)
    uf = UnionFind(n)
    for x, y in zip(a, b):
        uf.union(int(x), int(y))
    plain = np.array([uf.find(i) for i in range(n)])
    # Same partition: node i and j share a root in one iff in the other.
    _, got = np.unique(roots, return_inverse=True)
    _, want = np.unique(plain, return_inverse=True)
    first_got = {c: i for i, c in reversed(list(enumerate(got)))}
    first_want = {c: i for i, c in reversed(list(enumerate(want)))}
    np.testing.assert_array_equal([first_got[c] for c in got], [first_want[c] for c in want])
    with pytest.raises(ValueError):
        native.uf_components(n, [0, n], [1, 2])
