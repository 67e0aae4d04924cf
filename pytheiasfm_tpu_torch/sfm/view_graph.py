"""View graph: undirected graph of two-view geometries.

Re-design of `theia/sfm/view_graph/view_graph.h:59` and
`twoview_info.h:54`. Host-side container (the graph is built once per dataset
and is tiny next to the pixel data); exports flat edge arrays for the batched
rotation/position solvers. Union-find connected components replaces the
reference's BFS (`GetLargestConnectedComponentIds`, `view_graph.h:121`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TwoViewInfo", "ViewGraph", "UnionFind"]


@dataclasses.dataclass
class TwoViewInfo:
    """Parity: `theia::TwoViewInfo` (`twoview_info.h:54-86`)."""

    focal_length_1: float = 0.0
    focal_length_2: float = 0.0
    position_2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    rotation_2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    num_verified_matches: int = 0
    num_homography_inliers: int = 0
    visibility_score: int = 0
    scale_estimate: float = 1.0

    def swap_cameras(self):
        """Parity: `theia::SwapCameras` (`twoview_info.h:109`): invert the
        relative transform so the edge reads (2 -> 1). Host numpy — this
        runs per edge inside graph-construction loops."""
        from ..ops.rotation_np import angle_axis_to_rotation_matrix_np

        R = angle_axis_to_rotation_matrix_np(self.rotation_2)
        self.rotation_2 = -np.asarray(self.rotation_2)
        self.position_2 = -(R @ np.asarray(self.position_2))
        self.focal_length_1, self.focal_length_2 = (
            self.focal_length_2,
            self.focal_length_1,
        )


class UnionFind:
    """Parity: `theia::ConnectedComponents`
    (`math/graph/connected_components.h:60`) — array-based union-find with
    path compression."""

    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.rank = np.zeros(n, np.int32)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


class ViewGraph:
    """Parity: `theia::ViewGraph` (`view_graph/view_graph.h:59`)."""

    def __init__(self):
        self.edges: dict[tuple[int, int], TwoViewInfo] = {}
        self._adjacency: dict[int, set[int]] = {}

    def num_views(self) -> int:
        return len(self._adjacency)

    def num_edges(self) -> int:
        return len(self.edges)

    def has_view(self, view_id: int) -> bool:
        return view_id in self._adjacency

    def has_edge(self, v1: int, v2: int) -> bool:
        return (min(v1, v2), max(v1, v2)) in self.edges

    def add_edge(self, v1: int, v2: int, info: TwoViewInfo):
        """Parity: `ViewGraph::AddEdge`. Edges keyed (min, max); the stored
        transform maps the lower id to the higher id (reference invariant)."""
        if v1 > v2:
            info = dataclasses.replace(
                info,
                position_2=np.array(info.position_2),
                rotation_2=np.array(info.rotation_2),
            )
            info.swap_cameras()
            v1, v2 = v2, v1
        self.edges[(v1, v2)] = info
        self._adjacency.setdefault(v1, set()).add(v2)
        self._adjacency.setdefault(v2, set()).add(v1)

    def remove_edge(self, v1: int, v2: int) -> bool:
        key = (min(v1, v2), max(v1, v2))
        if key not in self.edges:
            return False
        del self.edges[key]
        self._adjacency[key[0]].discard(key[1])
        self._adjacency[key[1]].discard(key[0])
        for v in key:
            if not self._adjacency[v]:
                del self._adjacency[v]
        return True

    def remove_view(self, view_id: int):
        """Parity: `ViewGraph::RemoveView`."""
        if view_id not in self._adjacency:
            return
        for nb in list(self._adjacency[view_id]):
            self.remove_edge(view_id, nb)
        self._adjacency.pop(view_id, None)

    def get_edge(self, v1: int, v2: int) -> TwoViewInfo | None:
        return self.edges.get((min(v1, v2), max(v1, v2)))

    def neighbors(self, view_id: int) -> set[int]:
        return self._adjacency.get(view_id, set())

    def view_ids(self) -> list[int]:
        return sorted(self._adjacency.keys())

    def largest_connected_component_ids(self) -> list[int]:
        """Parity: `ViewGraph::GetLargestConnectedComponentIds`
        (`view_graph.h:121`)."""
        if not self.edges:
            return []
        ids = self.view_ids()
        index = {v: i for i, v in enumerate(ids)}
        uf = UnionFind(len(ids))
        for (a, b) in self.edges:
            uf.union(index[a], index[b])
        roots = [uf.find(i) for i in range(len(ids))]
        counts = np.bincount(roots)
        biggest = np.argmax(counts)
        return [ids[i] for i in range(len(ids)) if roots[i] == biggest]

    def extract_subgraph(self, view_ids) -> "ViewGraph":
        """Parity: `ViewGraph::ExtractSubgraph` (`view_graph.h:116`)."""
        keep = set(view_ids)
        sub = ViewGraph()
        for (a, b), info in self.edges.items():
            if a in keep and b in keep:
                sub.add_edge(a, b, info)
        return sub

    def remove_disconnected_view_pairs(self) -> list[int]:
        """Parity: `theia::RemoveDisconnectedViewPairs`
        (`view_graph/remove_disconnected_view_pairs.h`): keep only the
        largest connected component; returns removed view ids."""
        keep = set(self.largest_connected_component_ids())
        removed = [v for v in self.view_ids() if v not in keep]
        for v in removed:
            self.remove_view(v)
        return removed

    def edge_arrays(self, dtype=np.float64):
        """Flat arrays for batched solvers: (view1 [E], view2 [E],
        rotation2 [E,3], position2 [E,3], weights [E])."""
        E = len(self.edges)
        v1 = np.zeros(E, np.int32)
        v2 = np.zeros(E, np.int32)
        rot = np.zeros((E, 3), dtype)
        pos = np.zeros((E, 3), dtype)
        weights = np.zeros(E, dtype)
        for i, ((a, b), info) in enumerate(sorted(self.edges.items())):
            v1[i], v2[i] = a, b
            rot[i] = info.rotation_2
            pos[i] = info.position_2
            weights[i] = max(info.num_verified_matches, 1)
        return v1, v2, rot, pos, weights
