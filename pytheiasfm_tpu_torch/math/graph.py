"""Graph algorithms on view graphs: MST, triplets, MFAS ordering, cuts.

Counterpart of the JAX package's `math/graph.py` (`theia/math/graph/`:
union-find `connected_components.h:60` lives in `sfm.view_graph`; Prim MST
`minimum_spanning_tree.h:58`; `triplet_extractor.h:58`). These run on the
host: view graphs are small (thousands of nodes at most) and the
algorithms are sequential; the per-edge math they feed is batched on the
device.
"""

from __future__ import annotations

import heapq

import numpy as np

from .. import native

__all__ = [
    "minimum_spanning_tree",
    "maximum_spanning_tree",
    "extract_triplets",
    "mfas_ordering",
    "mfas_ordering_reference",
    "normalized_graph_cut",
    "ReservoirSampler",
]


def minimum_spanning_tree(edges, weights, num_nodes=None):
    """Prim MST over an undirected graph given as parallel arrays.

    Parity: `theia::MinimumSpanningTree` (`minimum_spanning_tree.h:58`).
    `edges`: [E, 2] int array; `weights`: [E]. Returns list of edge indices
    forming the MST of the connected component containing the smallest node
    id (the reference also assumes a connected input).
    """
    edges = np.asarray(edges)
    weights = np.asarray(weights)
    if len(edges) == 0:
        return []
    nodes = np.unique(edges)
    adj: dict[int, list[tuple[float, int, int]]] = {int(n): [] for n in nodes}
    for e, (a, b) in enumerate(edges):
        adj[int(a)].append((float(weights[e]), e, int(b)))
        adj[int(b)].append((float(weights[e]), e, int(a)))
    start = int(nodes[0])
    visited = {start}
    heap = list(adj[start])
    heapq.heapify(heap)
    out = []
    while heap and len(visited) < len(nodes):
        w, e, v = heapq.heappop(heap)
        if v in visited:
            continue
        visited.add(v)
        out.append(e)
        for item in adj[v]:
            if item[2] not in visited:
                heapq.heappush(heap, item)
    return out


def maximum_spanning_tree(edges, weights, num_nodes=None):
    """MST with negated weights — used to pick the best-supported spanning
    tree of a view graph (`orientations_from_maximum_spanning_tree.h:50`)."""
    return minimum_spanning_tree(edges, -np.asarray(weights), num_nodes)


def extract_triplets(edges):
    """All triangles in an undirected graph.

    Parity: `theia::TripletExtractor` (`triplet_extractor.h:58`). Returns
    [N, 3] array of edge-index triples (ij, jk, ik) with node triple
    i < j < k.
    """
    edges = np.asarray(edges)
    index = {}
    adj: dict[int, set[int]] = {}
    for e, (a, b) in enumerate(edges):
        a, b = int(min(a, b)), int(max(a, b))
        index[(a, b)] = e
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    triplets = []
    for (i, j), e_ij in index.items():
        # common neighbors k > j keep each triangle counted once
        for k in adj[i] & adj[j]:
            if k > j:
                triplets.append((e_ij, index[(j, k)], index[(i, k)]))
    return np.asarray(triplets, np.int64).reshape(-1, 3)


def mfas_ordering(edges, weights, num_nodes):
    """Greedy minimum-feedback-arc-set ordering of a weighted digraph.

    The 1DSfM ordering heuristic (Wilson & Snavely ECCV'14) used by
    `FilterViewPairsFromRelativeTranslation`
    (`filter_view_pairs_from_relative_translation.cc:165`): repeatedly emit
    the node maximizing (1 + out_weight) / (1 + in_weight).

    `edges`: [E, 2] (src, dst) int array; `weights`: [E] nonneg floats.
    Returns `order`: position of each node in the linear ordering.

    Runs the C++ kernel (`native/graphcore.cpp`): this greedy loop runs
    once per random 1DSfM axis and is the sequential host hot spot, which is
    why the reference keeps it in C++. A failed build raises.
    `mfas_ordering_reference` is the numpy version; it scans nodes in the
    same ascending order, so both give identical orderings.
    """
    edges = np.asarray(edges)
    return native.mfas_ordering(num_nodes, edges[:, 0], edges[:, 1], weights)


def mfas_ordering_reference(edges, weights, num_nodes):
    """The numpy version of :func:`mfas_ordering`: the plain version the
    tests hold the native kernel against."""
    src = np.asarray(edges)[:, 0]
    dst = np.asarray(edges)[:, 1]
    pos_w = np.maximum(np.asarray(weights, np.float64), 0.0)
    win = np.zeros(num_nodes)
    wout = np.zeros(num_nodes)
    np.add.at(wout, src, pos_w)
    np.add.at(win, dst, pos_w)
    out_adj: dict[int, list[tuple[int, float]]] = {}
    in_adj: dict[int, list[tuple[int, float]]] = {}
    for e in range(len(src)):
        out_adj.setdefault(int(src[e]), []).append((int(dst[e]), pos_w[e]))
        in_adj.setdefault(int(dst[e]), []).append((int(src[e]), pos_w[e]))
    remaining = np.ones(num_nodes, bool)
    order = np.zeros(num_nodes, np.int64)
    for rank in range(num_nodes):
        # Prefer sources (no remaining incoming weight); ascending node scan
        # (ties -> smallest id, matching the native kernel).
        best, best_score = -1, -np.inf
        for n in range(num_nodes):
            if not remaining[n]:
                continue
            if win[n] <= 1e-12:
                best = n
                break
            score = (1.0 + wout[n]) / (1.0 + win[n])
            if score > best_score:
                best, best_score = n, score
        remaining[best] = False
        order[best] = rank
        for (m, w) in out_adj.get(best, []):
            if remaining[m]:
                win[m] -= w
        for (m, w) in in_adj.get(best, []):
            if remaining[m]:
                wout[m] -= w
    return order


def normalized_graph_cut(edges, weights, num_nodes: int, cut_iterations: int = 100):
    """Two-way spectral normalized cut (Shi & Malik).

    Parity: `theia::NormalizedGraphCut` (`math/graph/normalized_graph_cut.h:72`)
    used for view clustering. The Fiedler vector of the normalized Laplacian
    is taken by a dense symmetric eigensolve on the host: the reference's
    use case is hundreds of views, where that is both fast and exact.

    Args:
      edges: [E, 2] int array; weights: [E] nonneg; num_nodes.

    Returns:
      (labels [num_nodes] in {0,1}, ncut_value).
    """
    edges = np.asarray(edges)
    w = np.asarray(weights, np.float64)
    W = np.zeros((num_nodes, num_nodes))
    W[edges[:, 0], edges[:, 1]] += w
    W[edges[:, 1], edges[:, 0]] += w
    d = W.sum(1)
    d_safe = np.where(d > 0, d, 1.0)
    Dinv_sqrt = 1.0 / np.sqrt(d_safe)
    L_sym = np.eye(num_nodes) - (Dinv_sqrt[:, None] * W) * Dinv_sqrt[None, :]
    evals, evecs = np.linalg.eigh(L_sym)
    fiedler = Dinv_sqrt * evecs[:, 1]  # generalized eigenvector
    # Sweep thresholds for the best normalized-cut value.
    order = np.argsort(fiedler)
    best_labels = (fiedler > np.median(fiedler)).astype(np.int32)
    best_val = np.inf
    total_assoc = d.sum()
    for k in range(1, num_nodes):
        labels = np.zeros(num_nodes, np.int32)
        labels[order[k:]] = 1
        in_a = labels == 0
        assoc_a = d[in_a].sum()
        assoc_b = total_assoc - assoc_a
        if assoc_a <= 0 or assoc_b <= 0:
            continue
        cut = w[(labels[edges[:, 0]] != labels[edges[:, 1]])].sum()
        val = cut / assoc_a + cut / assoc_b
        if val < best_val:
            best_val = val
            best_labels = labels
    return best_labels, best_val


class ReservoirSampler:
    """Streaming uniform k-sampler (parity: `theia::ReservoirSampler`,
    `math/reservoir_sampler.h`)."""

    def __init__(self, k: int, seed: int = 0):
        self._k = int(k)
        self._rng = np.random.default_rng(seed)
        self._n_seen = 0
        self._samples: list = []

    def add(self, item) -> None:
        self._n_seen += 1
        if len(self._samples) < self._k:
            self._samples.append(item)
        else:
            j = int(self._rng.integers(0, self._n_seen))
            if j < self._k:
                self._samples[j] = item

    @property
    def samples(self) -> list:
        return list(self._samples)
