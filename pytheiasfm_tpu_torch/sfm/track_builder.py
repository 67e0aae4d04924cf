"""Track builder: feature-correspondence union-find -> tracks.

Counterpart of the JAX package's `sfm/track_builder.py`
(`theia/sfm/track_builder.{h,cc}`, `track_builder.h:59-84`). Host work, run
once per dataset: the union-find over the flat correspondence table is the
native graph core's (`native.uf_components`), and the tracks go into the
container in one bulk append.

Contract (the reference's):
  - features are keyed (view_id, x, y);
  - connected components of the match graph become tracks;
  - a component holding two different features of the SAME view is
    inconsistent and dropped (track_builder.cc singleton guard);
  - components shorter than `min_track_length` are dropped; longer than
    `max_track_length` are cut to their first `max_track_length` features.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .reconstruction import Reconstruction

__all__ = ["TrackBuilder"]


class TrackBuilder:
    def __init__(self, min_track_length: int = 2, max_track_length: int = 50):
        self.min_track_length = min_track_length
        self.max_track_length = max_track_length
        self._feature_key_to_node: dict[tuple, int] = {}
        self._node_feature: list[tuple] = []  # (view_id, x, y)
        self._edges: list[tuple[int, int]] = []

    def _node(self, view_id: int, feature) -> int:
        key = (view_id, round(float(feature[0]), 4), round(float(feature[1]), 4))
        node = self._feature_key_to_node.get(key)
        if node is None:
            node = len(self._node_feature)
            self._feature_key_to_node[key] = node
            self._node_feature.append((view_id, float(feature[0]), float(feature[1])))
        return node

    def add_feature_correspondence(self, view1, feature1, view2, feature2):
        """Parity: `TrackBuilder::AddFeatureCorrespondence`
        (`track_builder.h:66`)."""
        self._edges.append((self._node(view1, feature1), self._node(view2, feature2)))

    def add_match(self, view1, view2, points1: np.ndarray, points2: np.ndarray):
        """Bulk version: add all verified correspondences of a pair."""
        for p1, p2 in zip(np.asarray(points1), np.asarray(points2)):
            self.add_feature_correspondence(view1, p1, view2, p2)

    def build_tracks(self, reconstruction: Reconstruction) -> int:
        """Parity: `TrackBuilder::BuildTracks` (`track_builder.h:72`).
        Returns the number of tracks added."""
        n = len(self._node_feature)
        if n == 0:
            return 0
        edges = np.asarray(self._edges, np.int64).reshape(-1, 2)
        roots = native.uf_components(n, edges[:, 0], edges[:, 1])

        # Group nodes by component.
        order = np.argsort(roots, kind="stable")
        sorted_roots = roots[order]
        boundaries = np.flatnonzero(
            np.r_[True, sorted_roots[1:] != sorted_roots[:-1], True]
        )
        kept = []
        for s, e in zip(boundaries[:-1], boundaries[1:]):
            nodes = order[s:e]
            if len(nodes) < self.min_track_length:
                continue
            if len(nodes) > self.max_track_length:
                nodes = nodes[: self.max_track_length]
            views = [self._node_feature[i][0] for i in nodes]
            # Inconsistent track: same view twice (track_builder.cc guard).
            if len(set(views)) != len(views):
                continue
            kept.append(nodes)
        if not kept:
            return 0
        # One bulk append: the rows `add_track` + `add_observation` would
        # give, track by track, without their per-row copies.
        track_ids = reconstruction.add_tracks_bulk(len(kept))
        nodes = np.concatenate(kept)
        feature = np.asarray(self._node_feature)[nodes]
        reconstruction.add_observations_bulk(
            feature[:, 0].astype(np.int32),
            np.repeat(track_ids, [len(k) for k in kept]),
            feature[:, 1:],
        )
        return len(kept)
