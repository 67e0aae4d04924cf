"""Segment sums: the counterpart of `jax.ops.segment_sum`.

`out[s] = Σ_{k : ids[k] = s} data[k]`, as `index_add_` along the first
axis. On the CPU the rows add in index order, as XLA's CPU scatter adds
them; on a CUDA card they add by atomics, in no fixed order, so two card
runs may differ in the last bits of a sum of several rows.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum"]


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)
