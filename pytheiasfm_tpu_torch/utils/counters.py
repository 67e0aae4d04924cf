"""Named launch counters.

Counterpart of the JAX package's `utils/counters.py`: the hot paths bump a
named counter once for each solve they start (`triangulate_launch`,
`reproject_launch`, `ba_launch`), and a pipeline reads them per phase, so
that a change in how often a stage runs shows without a profiler.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["bump", "reset", "snapshot", "total"]

_counts: Counter = Counter()


def bump(name: str, n: int = 1) -> None:
    _counts[name] += n


def reset() -> None:
    _counts.clear()


def snapshot() -> dict:
    return dict(_counts)


def total() -> int:
    return sum(_counts.values())
