"""Device time of a callable on the CUDA card, and stage timing."""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["cuda_time_ms", "StageTimer"]


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


class StageTimer:
    """Times named stages by host clock, synchronizing the CUDA device
    before and after each; with `profile`, also counts each stage's kernel
    launches and sums their device time by `torch.profiler` (whose own cost
    is then in the stage seconds). Use as ``with timer("name"): ...``."""

    def __init__(self, device, profile: bool = False):
        self.device = torch.device(device)
        self.profile = profile
        self.seconds: dict[str, float] = {}
        self.launches: dict[str, int] = {}
        self.device_seconds: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name):
        self._sync()
        prof = None
        if self.profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
            ])
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            self.seconds[name] = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                kernels = [
                    e for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                ]
                self.launches[name] = len(kernels)
                self.device_seconds[name] = sum(e.duration_ns() for e in kernels) * 1e-9
