"""Candidate-pair selection from global image descriptors.

Counterpart of the JAX package's `matching/graph_match.py`
(`theia/matching/graph_match.{h,cc}`, `graph_match.h:63-66`): a k-NN graph
over global descriptors, emitted as the union of (i, neighbour) pairs. The
all-pairs distances are one matmul; the k nearest are a stable sort, so
that equal distances go to the lower index first, as `lax.top_k` orders
them (a bare `torch.topk` does not promise that order).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device

__all__ = ["graph_match"]


def graph_match(
    global_descriptors: np.ndarray,  # [V, D]
    num_nearest_neighbors: int = 10,
    device=None,
) -> list[tuple[int, int]]:
    """Parity: `theia::GraphMatch` (`graph_match.h:63`). Returns the sorted
    unique candidate pairs (i < j); the distances are computed on `device`
    (None: the CUDA card)."""
    x = torch.as_tensor(np.asarray(global_descriptors, np.float32),
                        device=default_device(device))
    V = x.shape[0]
    k = min(num_nearest_neighbors, V - 1)
    if k <= 0:
        return []
    sq = torch.sum(x * x, dim=-1)
    dist = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    dist.diagonal().fill_(float("inf"))
    idx = torch.sort(dist, dim=1, stable=True).indices[:, :k].cpu().numpy()
    pairs = set()
    for i in range(V):
        for j in idx[i]:
            a, b = (i, int(j)) if i < j else (int(j), i)
            if a != b:
                pairs.add((a, b))
    return sorted(pairs)
