"""The port's `graph_match` (`pytheiasfm_tpu_torch/matching/graph_match.py`)
against the JAX package's `matching/graph_match.py`, on the CPU.

Bars: the same sorted pair set, exactly. Descriptors: three clusters (the
JAX test's), unit descriptors, and small integer-valued descriptors with
exact duplicates, whose distances are exact in f32 and tie: there the pair
set depends on the tie rule (the lower index first, as `lax.top_k`).
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching.graph_match import graph_match as jgraph_match
from pytheiasfm_tpu_torch.matching import graph_match as tgraph_match


def _clusters(rng):
    centers = rng.normal(size=(3, 16)) * 10
    return np.concatenate([c + rng.normal(size=(4, 16)) * 0.1 for c in centers])


def _unit(rng):
    x = rng.normal(size=(40, 128))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tied(rng):
    """Integer descriptors in {0, 1, 2}: many exactly equal distances, and
    duplicate rows."""
    x = rng.integers(0, 3, size=(24, 8)).astype(np.float32)
    x[12:18] = x[0:6]
    return x


@pytest.mark.parametrize("k", [1, 3, 8, 40])
@pytest.mark.parametrize("kind", ["clusters", "unit", "tied"])
def test_graph_match_matches_jax(kind, k):
    rng = np.random.default_rng(5)
    desc = {"clusters": _clusters, "unit": _unit, "tied": _tied}[kind](rng)
    want = jgraph_match(desc, num_nearest_neighbors=k)
    got = tgraph_match(desc, num_nearest_neighbors=k, device="cpu")
    assert got == want
    assert all(a < b for a, b in got)


def test_ties_take_the_lower_index():
    # Views 1..4 are all at distance 1 from view 0; with k = 2, view 0's
    # neighbours are 1 and 2.
    desc = np.zeros((5, 4), np.float32)
    desc[1, 0], desc[2, 0], desc[3, 1], desc[4, 1] = 1, -1, 1, -1
    got = tgraph_match(desc, num_nearest_neighbors=2, device="cpu")
    assert got == jgraph_match(desc, num_nearest_neighbors=2)
    assert (0, 1) in got and (0, 2) in got


def test_one_view_has_no_pairs():
    assert tgraph_match(np.ones((1, 4)), device="cpu") == []


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tgraph_match(np.ones((3, 4)))
