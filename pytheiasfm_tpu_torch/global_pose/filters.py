"""View-graph filtering between global-SfM stages.

Counterpart of the JAX package's `global_pose/filters.py`
(`theia/sfm/filter_view_pairs_from_orientation.h:59`,
`filter_view_graph_cycles_by_rotation.h:47` (triplet loop consistency),
`filter_view_pairs_from_relative_translation.cc:165-278` (1DSfM, Wilson &
Snavely ECCV'14) and `extract_maximally_parallel_rigid_subgraph.h:63`). The
per-edge, per-triplet and per-view math runs batched on the device, one copy
back a filter; graph surgery, the triplet enumeration and the MFAS orderings
stay on the host.
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
    "filter_view_graph_cycles_by_rotation",
    "filter_view_pairs_from_relative_translation",
    "extract_maximally_parallel_rigid_subgraph",
]

# `_parallel_components` works on this many [fixed view, view, view, dim]
# entries at once (its JAX form holds all N^3 * 3 of them).
_PARALLEL_CHUNK_ENTRIES = 1 << 25


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


def _triplet_loop_angles(rot_ij, rot_jk, rot_ik):
    """Angle of R_ikᵀ · R_jk · R_ij per triplet, degrees."""
    Rij = rotops.angle_axis_to_rotation_matrix(rot_ij)
    Rjk = rotops.angle_axis_to_rotation_matrix(rot_jk)
    Rik = rotops.angle_axis_to_rotation_matrix(rot_ik)
    aa = rotops.rotation_matrix_to_angle_axis(Rik.mT @ Rjk @ Rij)
    return torch.rad2deg(torch.linalg.norm(aa, dim=-1))


def filter_view_graph_cycles_by_rotation(
    view_graph, max_loop_error_degrees: float = 3.0, device=None
):
    """Keep only edges in at least one rotation-consistent triplet.

    Parity: `theia::FilterViewGraphCyclesByRotation`
    (`filter_view_graph_cycles_by_rotation.h:47`): every triangle of the
    graph (`math.graph.extract_triplets`, on the host), its loop rotation's
    angle on the device. Returns #removed."""
    v1, v2, rel_rot, _, _ = view_graph.edge_arrays()
    E = len(v1)
    if E == 0:
        return 0
    device = default_device(device)
    triplets = graphops.extract_triplets(np.stack([v1, v2], -1))
    keep = np.zeros(E, bool)
    if len(triplets):
        rot = torch.as_tensor(rel_rot, device=device)
        tri = torch.as_tensor(triplets, device=device)
        angles = _triplet_loop_angles(rot[tri[:, 0]], rot[tri[:, 1]], rot[tri[:, 2]])
        keep[np.unique(triplets[(angles < max_loop_error_degrees).cpu().numpy()])] = True
    removed = np.flatnonzero(~keep)
    for k in removed:
        view_graph.remove_edge(int(v1[k]), int(v2[k]))
    return int(len(removed))


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


def _parallel_components(null_space):
    """Membership scan for the maximally parallel rigid component.

    null_space [N, 3, K] (f64): per-view 3-row blocks of the translation-
    constraint null space. For each candidate fixed view f, subtract its
    block from all blocks (fixing f at the origin); views whose residual
    block is ~zero, or whose normalized block is parallel (per dimension) to
    another candidate's, belong to the same rigid component (the test of
    `extract_maximally_parallel_rigid_subgraph.cc:100-165`, with the JAX
    package's thresholds). The fixed views go in chunks of
    `_PARALLEL_CHUNK_ENTRIES` [f, i, j, dim] entries. Returns membership
    [N, N] (bool): member[f] is the component when fixing view f.
    """
    kMaxCos = 1e-5
    kMaxNorm = 1e-8
    N = null_space.shape[0]
    device = null_space.device
    ar = torch.arange(N, device=device)
    chunk = max(1, _PARALLEL_CHUNK_ENTRIES // (3 * N * N))
    rows = []
    for f0 in range(0, N, chunk):
        f = ar[f0:f0 + chunk]
        M = null_space[None] - null_space[f][:, None]  # [F, N, 3, K]
        norms = torch.linalg.norm(M, dim=-1)  # [F, N, 3]
        row_ok = norms > kMaxNorm
        zero = torch.all(~row_ok, dim=-1)  # [F, N]
        Mn = M / torch.clamp(norms, min=1e-300)[..., None]
        dots = torch.abs(torch.einsum("fidk,fjdk->fijd", Mn, Mn))
        # Per dimension, two blocks are compatible when both rows are
        # near-zero or both carry signal and are parallel; zero against
        # signal means different rigidity.
        both_ok = row_ok[:, :, None, :] & row_ok[:, None, :, :]
        both_zero = (~row_ok)[:, :, None, :] & (~row_ok)[:, None, :, :]
        dim_parallel = (both_ok & (1.0 - dots < kMaxCos)) | both_zero
        eligible = (~zero) & (ar[None, :] != f[:, None])
        pair = (
            torch.all(dim_parallel, dim=-1)
            & eligible[:, :, None]
            & eligible[:, None, :]
            & (ar[:, None] != ar[None, :])
        )
        member = zero | torch.any(pair, dim=2)
        member[torch.arange(len(f), device=device), f] = True
        rows.append(member)
    return torch.cat(rows)


def _null_space(A):
    """An orthonormal basis [n, K] of the null space of A [m, n] (f64), with
    the JAX package's rank rule (singular values above max(m, n) · eps ·
    s_max and above 1e-10). The JAX package takes Vᵀ from a full SVD of A;
    here R of a QR of A (padded with zero rows to at least n) gives the
    same singular values and right singular vectors from an n × n SVD.
    Membership depends on the basis only through row norms and dot
    products, which any orthonormal basis of the same space preserves."""
    m, n = A.shape
    if m < n:
        A = torch.cat([A, A.new_zeros((n - m, n))])
    _, R = torch.linalg.qr(A)
    _, s, vt = torch.linalg.svd(R)
    s = s.cpu().numpy()
    tol = max(m, n) * np.finfo(float).eps * (s[0] if len(s) else 1.0)
    rank = int((s[: min(m, n)] > max(tol, 1e-10)).sum())
    return vt[rank:].T


def extract_maximally_parallel_rigid_subgraph(orientations: dict, view_graph, device=None):
    """Keep only the views in the maximal parallel-rigid component.

    Parity: `theia::ExtractMaximallyParallelRigidSubgraph`
    (`extract_maximally_parallel_rigid_subgraph.h:63`, algorithm
    `.cc:167-225`), as the JAX package's: build the constraint matrix
    t_ij × (c_j − c_i) = 0 over all edges (t_ij rotated into the world
    frame) on the device, take its null space, and find the largest set of
    views whose null-space blocks are parallel after fixing one view: the
    positions determined up to one global scale. Views outside it are
    removed from the graph. Returns the number of removed views.
    """
    view_ids = [v for v in view_graph.view_ids() if v in orientations]
    N = len(view_ids)
    if N < 2 or not view_graph.edges:
        return 0
    index = {v: i for i, v in enumerate(view_ids)}
    v1, v2, _, rel_pos, _ = view_graph.edge_arrays()
    keep_edges = [k for k in range(len(v1)) if v1[k] in index and v2[k] in index]
    E = len(keep_edges)
    if E == 0:
        return 0
    device = default_device(device)
    f64 = torch.float64
    ii = torch.as_tensor([index[v1[k]] for k in keep_edges], device=device)
    jj = torch.as_tensor([index[v2[k]] for k in keep_edges], device=device)
    aa = torch.as_tensor(np.stack([orientations[v1[k]] for k in keep_edges]), dtype=f64,
                         device=device)
    pos = torch.as_tensor(rel_pos[keep_edges], dtype=f64, device=device)
    t = (rotops.angle_axis_to_rotation_matrix(aa).mT @ pos[..., None])[..., 0]
    cx = rotops.hat(t)  # [E, 3, 3]
    A = torch.zeros((E, 3, N, 3), dtype=f64, device=device)
    rows = torch.arange(E, device=device)
    A[rows, :, ii, :] = -cx
    A[rows, :, jj, :] = cx
    ns = _null_space(A.reshape(3 * E, 3 * N))  # [3N, K]
    if ns.shape[1] == 0:
        return 0
    member = _parallel_components(ns.reshape(N, 3, -1)).cpu().numpy()
    best = member[np.argmax(member.sum(axis=1))]
    removed = 0
    for i, v in enumerate(view_ids):
        if not best[i]:
            if view_graph.has_view(v):
                # Dropping a view's last edge may remove its neighbours too;
                # count every view outside the component.
                view_graph.remove_view(v)
            removed += 1
    return removed
