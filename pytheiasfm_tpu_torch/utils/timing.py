"""Device time of a callable on the CUDA card."""

from __future__ import annotations

import torch

__all__ = ["cuda_time_ms"]


def cuda_time_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Mean device time of `fn` over `iters` runs after `warmup` runs, by
    CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
