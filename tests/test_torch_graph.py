"""The port's graph algorithms and native graph core against the JAX
package's `math/graph.py`, and the native MFAS against its numpy version.

Exact: MST edge sets, triplets and MFAS orderings (index for index, native
and numpy) are integer results.
"""

import numpy as np
import pytest

from pytheiasfm_tpu.math import graph as jgraph
from pytheiasfm_tpu_torch import native
from pytheiasfm_tpu_torch.math import graph as tgraph
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


def _random_graph(rng, n=40, p=0.2):
    edges = np.array([(a, b) for a in range(n) for b in range(a + 1, n) if rng.random() < p])
    return edges, rng.integers(1, 200, len(edges)).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_spanning_trees_and_triplets_match_jax(seed):
    edges, weights = _random_graph(np.random.default_rng(seed))
    for fn in ("minimum_spanning_tree", "maximum_spanning_tree"):
        assert sorted(getattr(tgraph, fn)(edges, weights)) == sorted(
            getattr(jgraph, fn)(edges, weights)
        )
    np.testing.assert_array_equal(tgraph.extract_triplets(edges), jgraph.extract_triplets(edges))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mfas_ordering_native_and_numpy_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 60
    edges, _ = _random_graph(rng, n, 0.15)
    w = rng.normal(size=len(edges))
    src = np.where(w >= 0, edges[:, 0], edges[:, 1])
    dst = np.where(w >= 0, edges[:, 1], edges[:, 0])
    directed = np.stack([src, dst], -1)
    want = jgraph.mfas_ordering(directed, np.abs(w), n)
    np.testing.assert_array_equal(tgraph.mfas_ordering(directed, np.abs(w), n), want)
    np.testing.assert_array_equal(tgraph.mfas_ordering_reference(directed, np.abs(w), n), want)
    assert sorted(want) == list(range(n))


def test_native_build_lands_in_build_dir_and_checks_its_inputs():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libgraphcore-")
    with pytest.raises(ValueError):
        native.mfas_ordering(3, [0, 3], [1, 2], [1.0, 1.0])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    broken = tmp_path / "graphcore.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="graphcore build failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_normalized_cut_and_reservoir_match_jax():
    rng = np.random.default_rng(4)
    # Two dense blocks joined by one weak edge.
    edges = [(a, b) for a in range(6) for b in range(a + 1, 6)]
    edges += [(a + 6, b + 6) for a, b in edges] + [(0, 6)]
    edges = np.array(edges)
    weights = np.where(np.arange(len(edges)) == len(edges) - 1, 0.1, 1.0)
    labels, value = tgraph.normalized_graph_cut(edges, weights, 12)
    jlabels, jvalue = jgraph.normalized_graph_cut(edges, weights, 12)
    np.testing.assert_array_equal(labels, jlabels)
    assert value == pytest.approx(jvalue, rel=1e-12)
    assert len(set(labels[:6])) == 1 and labels[0] != labels[6]
    mine, ref = tgraph.ReservoirSampler(5, seed=2), jgraph.ReservoirSampler(5, seed=2)
    for item in rng.integers(0, 1000, 100):
        mine.add(item)
        ref.add(item)
    assert mine.samples == ref.samples
