"""ProgressTracker + PendingBuffer — clock bookkeeping for consistency.

Rebuild of the reference's ``ProgressTracker`` (per-worker clock vector,
``AdvanceAndGetChangedMinClock``) and ``PendingBuffer`` (parked request
queues keyed by clock) — SURVEY.md §2 "ProgressTracker / PendingBuffer".
Pure host-side logic with no JAX dependency, so it is unit-testable exactly
the way the reference tests it: scripted Add/Get/Clock sequences
(SURVEY.md §4).

A copy of ``minips_tpu/consistency/tracker.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional


class ProgressTracker:
    """Per-worker clock vector."""

    def __init__(self, num_workers: int):
        if num_workers <= 0:
            raise ValueError("num_workers must be positive")
        self._clocks = [0] * num_workers

    @property
    def num_workers(self) -> int:
        return len(self._clocks)

    def clock_of(self, worker: int) -> int:
        return self._clocks[worker]

    @property
    def min_clock(self) -> int:
        return min(self._clocks)

    @property
    def max_clock(self) -> int:
        return max(self._clocks)

    @property
    def skew(self) -> int:
        """max - min clock: SSP's key observable (SURVEY.md §5.5)."""
        return self.max_clock - self.min_clock

    def advance(self, worker: int) -> Optional[int]:
        """Advance ``worker``'s clock by one. Returns the new min clock if
        the minimum changed, else None — the reference's
        ``AdvanceAndGetChangedMinClock`` (SURVEY.md §2)."""
        old_min = self.min_clock
        self._clocks[worker] += 1
        new_min = self.min_clock
        return new_min if new_min != old_min else None

    def snapshot(self) -> list[int]:
        return list(self._clocks)

    def restore(self, clocks: list[int]) -> None:
        if len(clocks) != len(self._clocks):
            raise ValueError("clock vector size mismatch")
        self._clocks = list(clocks)


class PendingBuffer:
    """Requests parked until the min clock reaches their admission clock."""

    def __init__(self) -> None:
        self._parked: dict[int, list[Any]] = defaultdict(list)

    def park(self, ready_at_clock: int, item: Any) -> None:
        self._parked[ready_at_clock].append(item)

    def pop_ready(self, min_clock: int) -> list[Any]:
        """Pop every item whose admission clock <= min_clock, FIFO within
        each clock, ascending clock order."""
        ready: list[Any] = []
        for c in sorted(k for k in self._parked if k <= min_clock):
            ready.extend(self._parked.pop(c))
        return ready

    @property
    def num_parked(self) -> int:
        return sum(len(v) for v in self._parked.values())
