"""View-graph filtering between global-SfM stages.

Counterpart of the JAX package's `global_pose/filters.py`
(`theia/sfm/filter_view_pairs_from_orientation.h:59` and
`filter_view_pairs_from_relative_translation.cc:165-278`, 1DSfM, Wilson &
Snavely ECCV'14). The per-edge math runs batched on the device, one copy
back a filter; graph surgery and the MFAS orderings stay on the host.

The cycle filter (`filter_view_graph_cycles_by_rotation`) and
`extract_maximally_parallel_rigid_subgraph` are not ported yet (ROADMAP
item D1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..math import graph as graphops
from ..ops import rotation as rotops
from .position_estimator import relative_translations_to_world

__all__ = [
    "filter_view_pairs_from_orientation",
    "filter_view_pairs_from_relative_translation",
]


def _orientation_edge_angles(orient_i, orient_j, rel_aa):
    """Angle of R_ij · (R_j R_iᵀ)ᵀ per edge, degrees."""
    Ri = rotops.angle_axis_to_rotation_matrix(orient_i)
    Rj = rotops.angle_axis_to_rotation_matrix(orient_j)
    Rrel = rotops.angle_axis_to_rotation_matrix(rel_aa)
    aa = rotops.rotation_matrix_to_angle_axis(Rrel @ Ri @ Rj.mT)
    return torch.rad2deg(torch.linalg.norm(aa, dim=-1))


def filter_view_pairs_from_orientation(
    view_graph,
    orientations: dict,
    max_relative_rotation_difference_degrees: float = 5.0,
    device=None,
):
    """Remove edges whose relative rotation disagrees with the global
    orientations. Parity: `theia::FilterViewPairsFromOrientation`
    (`filter_view_pairs_from_orientation.h:59`). Returns #removed."""
    if not view_graph.edges:
        return 0
    device = default_device(device)
    v1, v2, rel_rot, _, _ = view_graph.edge_arrays()
    oi = np.stack([orientations[v] for v in v1])
    oj = np.stack([orientations[v] for v in v2])
    angles = _orientation_edge_angles(
        *(torch.as_tensor(a, device=device) for a in (oi, oj, rel_rot))
    ).cpu().numpy()
    bad = angles > max_relative_rotation_difference_degrees
    for k in np.flatnonzero(bad):
        view_graph.remove_edge(int(v1[k]), int(v2[k]))
    return int(bad.sum())


def filter_view_pairs_from_relative_translation(
    view_graph,
    orientations: dict,
    num_iterations: int = 48,
    translation_projection_tolerance: float = 0.08,
    rng: np.random.Generator | None = None,
    device=None,
):
    """1DSfM outlier filtering of relative translations.

    Parity: `theia::FilterViewPairsFromRelativeTranslation`
    (`filter_view_pairs_from_relative_translation.cc:165-278`): project the
    world-frame pairwise directions onto `num_iterations` random unit axes
    (drawn from `rng` as the JAX package draws them), order the views per
    axis with the greedy MFAS heuristic, and accumulate how badly each edge
    violates each ordering. Edges with mean violation above tolerance are
    removed. Returns #removed.
    """
    if not view_graph.edges:
        return 0
    device = default_device(device)
    rng = rng or np.random.default_rng(0)
    view_ids = view_graph.view_ids()
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, _, rel_pos, _ = view_graph.edge_arrays()
    E = len(v1)
    ei = np.asarray([index[v] for v in v1], np.int32)
    ej = np.asarray([index[v] for v in v2], np.int32)
    orient = np.stack([orientations[v] for v in v1])

    # Edge-aligned orientations with an identity gather.
    t_world = relative_translations_to_world(
        torch.as_tensor(orient, device=device),
        torch.arange(E, device=device),
        torch.as_tensor(rel_pos, device=device),
    ).cpu().numpy()

    axes = rng.normal(size=(num_iterations, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    proj = t_world @ axes.T  # [E, A] signed projections

    bad_weight = np.zeros(E)
    for a in range(num_iterations):
        w = proj[:, a]
        # Orient each edge along its positive projection for the ordering.
        src = np.where(w >= 0, ei, ej)
        dst = np.where(w >= 0, ej, ei)
        order = graphops.mfas_ordering(np.stack([src, dst], -1), np.abs(w), V)
        # Violation: the edge says src before dst; the penalty, weighted by
        # the projection's magnitude, counts where the ordering disagrees.
        disagree = order[src] > order[dst]
        bad_weight += np.abs(w) * disagree
    bad = bad_weight / num_iterations > translation_projection_tolerance
    for k in np.flatnonzero(bad):
        view_graph.remove_edge(int(v1[k]), int(v2[k]))
    return int(bad.sum())
