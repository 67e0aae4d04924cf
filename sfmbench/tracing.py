"""Ranges that the benchmark opens in the trace, and the reduction of a
`torch.profiler` trace to device busy time, kernel counts and idle gaps.

The benchmark's own files open every range: `step` around one step of the
window, `stage:<name>` around each stage the program's stage timer reports,
`harness:<what>` around the harness's own work inside the window (array
copies). A gap between device operations is labelled by the innermost of
these ranges that holds its start, or `outside_stages`.
"""

from __future__ import annotations

import contextlib
import dataclasses

WINDOW = "sfmbench.window"
STEP = "step"


@contextlib.contextmanager
def labelled(name):
    """A `torch.profiler.record_function` range (a no-op when nothing
    profiles but the range object itself)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@dataclasses.dataclass
class Trace:
    """What a traced window's device did: `busy_s` (union of device
    operations inside the window), `window_s` (the window range's length),
    `launches` (kernels) and `device_s` (summed device-operation time),
    `device_ops` (name, seconds: the ten that took most time) and
    `idle_gaps` (label, seconds: the ten longest gaps)."""

    window_s: float
    busy_s: float
    launches: int
    device_s: float
    device_ops: list
    idle_gaps: list


def reduce(prof) -> Trace | None:
    """The `Trace` of the `WINDOW` range of a finished profiler, or None
    when the trace holds no window or no device operation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # The trace mirrors each of the benchmark's ranges on the
            # device's timeline (a user annotation there): not an operation.
            if not _is_range(name):
                ops.append((e.start_ns(), e.duration_ns(), name))
            continue
        if name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(("stage:", "harness:")):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if window is None or not ops:
        return None
    w0, w1 = window
    ops = [o for o in ops if w0 <= o[0] < w1]
    if not ops:
        return None
    by_name: dict[str, int] = {}
    launches = 0
    device_ns = 0
    for _, dur, name in ops:
        by_name[name] = by_name.get(name, 0) + dur
        device_ns += dur
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    ops.sort()
    busy_ns, gaps = 0, []
    cur0, cur1 = w0, w0
    for start, dur, _ in ops:
        end = min(start + dur, w1)
        if start > cur1:
            busy_ns += cur1 - cur0
            gaps.append((start - cur1, cur1))
            cur0, cur1 = start, end
        else:
            cur1 = max(cur1, end)
    busy_ns += cur1 - cur0
    if w1 > cur1:
        gaps.append((w1 - cur1, cur1))
    gaps.sort(reverse=True)
    idle = [[_label(ranges, at), length * 1e-9] for length, at in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, launches=launches,
                 device_s=device_ns * 1e-9,
                 device_ops=[[name[:120], ns * 1e-9] for name, ns in top], idle_gaps=idle)


def _is_range(name):
    return name in (WINDOW, STEP) or name.startswith(("stage:", "harness:"))


def _label(ranges, at):
    """The innermost range holding time `at` (the latest to start)."""
    best = None
    for start, end, name in ranges:
        if start <= at < end and (best is None or start > best[0]):
            best = (start, name)
    return best[1] if best else "outside_stages"
