"""The distributed Schur reduction with explicit collectives.

Counterpart of the JAX package's `parallel/distributed.py`, whose
`shard_map` + `psum` pins the collective placement of the bundle
adjuster's reduction. Here every rank holds the same inputs, sums its
block of the observation axis (`ops.segment.segment_sum`, `index_add_`)
into the whole [num_segments, ...] accumulator, and one `all_reduce`
combines the ranks' partial sums; every rank ends with the total.
"""

from __future__ import annotations

import torch

from ..ops.segment import segment_sum
from .sharding import local_shard, mesh_axis

__all__ = [
    "sharded_segment_sum",
    "distributed_normal_equation_blocks",
]


def sharded_segment_sum(values, segment_ids, num_segments: int, mesh):
    """`segment_sum(values, segment_ids, num_segments)` with the leading
    axis sharded over the mesh: each rank reduces its block (the axis padded
    with zero values on segment 0), then one `all_reduce`."""
    values, segment_ids = local_shard(values, mesh), local_shard(segment_ids, mesh)
    return mesh_axis(mesh).sum(segment_sum(values, segment_ids.long(), num_segments))


def distributed_normal_equation_blocks(
    Jc,  # [O, 2, 6] camera Jacobian blocks
    Jp,  # [O, 2, K] point Jacobian blocks
    r,  # [O, 2] residuals
    obs_view,  # [O]
    obs_track,  # [O]
    num_views: int,
    num_tracks: int,
    mesh,
):
    """The Gauss-Newton blocks of the Schur system, observation-sharded:

      U   [V, 6, 6] = all_reduce of the ranks' sum_o Jc^T Jc
      Vt  [T, K, K] = all_reduce of sum_o Jp^T Jp
      bc  [V, 6]    = -all_reduce of sum_o Jc^T r
      bp  [T, K]    = -all_reduce of sum_o Jp^T r

    Four local segment sums packed into one `all_reduce`."""
    Jc, Jp, r, ov, ot = (local_shard(a, mesh) for a in (Jc, Jp, r, obs_view, obs_track))
    ov, ot = ov.long(), ot.long()
    V, T, K = num_views, num_tracks, Jp.shape[-1]
    parts = (
        segment_sum(Jc.mT @ Jc, ov, V).reshape(V * 36),
        segment_sum(Jp.mT @ Jp, ot, T).reshape(T * K * K),
        -segment_sum(torch.sum(Jc * r[..., None], dim=1), ov, V).reshape(V * 6),
        -segment_sum(torch.sum(Jp * r[..., None], dim=1), ot, T).reshape(T * K),
    )
    total = mesh_axis(mesh).sum(torch.cat(parts))
    U, Vt, bc, bp = torch.split(total, [V * 36, T * K * K, V * 6, T * K])
    return U.reshape(V, 6, 6), Vt.reshape(T, K, K), bc.reshape(V, 6), bp.reshape(T, K)
