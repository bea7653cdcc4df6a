"""BSP / SSP / ASP consistency controllers — the reference's model layer.

Rebuild of ``BSPModel`` / ``SSPModel`` / ``ASPModel`` (SURVEY.md §2): the
server-side policy deciding when a worker's Get (pull) is admitted versus
parked. Unified rule — a pull by a worker at clock ``c`` is admitted iff

    min_clock >= c - staleness

with ``staleness = 0`` ⇒ BSP (everyone must have reached my clock),
``staleness = s`` ⇒ SSP bounded staleness (north-star s ≤ 4,
BASELINE.json:4), ``staleness = ∞`` ⇒ ASP (never blocks).

Two consumption modes, one policy object:

1. **Threaded PS emulation** (reference semantics; used by the Engine's
   threaded path and the test suite): ``wait_until_admitted`` blocks the
   calling worker thread on a condition variable until admitted — the
   rebuild of AppBlocker/CallbackRunner rendezvous (SURVEY.md §2) without
   the message plumbing, which SPMD makes unnecessary.

2. **SPMD gate** (TPU path; SURVEY.md §7.4): each host drives shard-local
   jitted steps and asks ``should_sync``/``admit`` before launching a
   *collective* sync step. The same bounded-staleness rule gates XLA
   collective barriers instead of parking RPCs. Multi-host clock exchange
   rides the control bus (minips_tpu/comm/bus.py), not XLA collectives,
   because it must stay nonblocking while a step runs.

A copy of ``minips_tpu/consistency/controllers.py``: the port's
threaded Engine path parks worker threads here exactly as the JAX
package's does.
"""

from __future__ import annotations

import threading
from typing import Optional

from minips_tpu_torch.consistency.tracker import ProgressTracker

_INF = float("inf")


class ConsistencyController:
    """Bounded-staleness admission over a shared clock vector (thread-safe)."""

    #: subclass name tag, mirrors reference ModelType (SURVEY.md §1 L4)
    kind = "ssp"

    def __init__(self, num_workers: int, staleness: float = 0):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.staleness = staleness
        self.tracker = ProgressTracker(num_workers)
        self._cond = threading.Condition()
        self._stopped = False

    # ----------------------------------------------------------- admission
    def admit(self, worker: int) -> bool:
        """May ``worker`` (at its current clock) pull now?"""
        with self._cond:
            return self._admit_locked(worker)

    def _admit_locked(self, worker: int) -> bool:
        return (self.tracker.min_clock
                >= self.tracker.clock_of(worker) - self.staleness)

    def wait_until_admitted(self, worker: int,
                            timeout: Optional[float] = None) -> bool:
        """Block the worker thread until its pull is admitted (AppBlocker
        analog). Returns False on timeout/stop."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._stopped or self._admit_locked(worker), timeout
            ) and not self._stopped

    # ----------------------------------------------------------- clocking
    def clock(self, worker: int) -> Optional[int]:
        """Advance worker's clock (reference ``Clock()``); wakes any parked
        waiters if the min clock moved. Returns changed min clock or None."""
        with self._cond:
            changed = self.tracker.advance(worker)
            if changed is not None:
                self._cond.notify_all()
            return changed

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def reset_stop(self) -> None:
        """Re-arm after a stop() so the controller can gate another run."""
        with self._cond:
            self._stopped = False

    # ----------------------------------------------------------- SPMD gate
    def should_sync(self, worker: int) -> bool:
        """SPMD-path hint: must this worker join a collective sync step
        before advancing further? (SURVEY.md §7.4)."""
        return not self.admit(worker)

    # ----------------------------------------------------------- introspection
    @property
    def min_clock(self) -> int:
        return self.tracker.min_clock

    @property
    def skew(self) -> int:
        return self.tracker.skew

    def state_dict(self) -> dict:
        return {"clocks": self.tracker.snapshot(),
                "staleness": self.staleness, "kind": self.kind}

    def load_state_dict(self, state: dict) -> None:
        self.tracker.restore(state["clocks"])


class BSP(ConsistencyController):
    """Bulk-synchronous: staleness 0. Under SPMD this is the default
    behavior — every collective is a barrier (SURVEY.md §2 "BSPModel")."""

    kind = "bsp"

    def __init__(self, num_workers: int):
        super().__init__(num_workers, staleness=0)


class SSP(ConsistencyController):
    """Stale-synchronous: admit iff min_clock >= my_clock - s
    (SURVEY.md §2 "SSPModel")."""

    kind = "ssp"

    def __init__(self, num_workers: int, staleness: int = 4):
        super().__init__(num_workers, staleness=staleness)


class ASP(ConsistencyController):
    """Fully asynchronous: never blocks (SURVEY.md §2 "ASPModel"). On the
    SPMD path this degrades to local-SGD-style infrequent sync; the drift
    from true per-key async is documented in docs/consistency.md
    (SURVEY.md §7.4 'ASP semantics honesty')."""

    kind = "asp"

    def __init__(self, num_workers: int, sync_every: int = 8):
        super().__init__(num_workers, staleness=_INF)
        self.sync_every = sync_every

    def should_sync(self, worker: int) -> bool:
        """ASP never blocks pulls, but the SPMD emulation syncs parameters
        every ``sync_every`` local steps (bounded-async local SGD)."""
        if self.sync_every <= 0:
            return False
        return self.tracker.clock_of(worker) % self.sync_every == 0 and \
            self.tracker.clock_of(worker) > 0


def make_controller(kind: str, num_workers: int, *, staleness: int = 4,
                    sync_every: int = 8) -> ConsistencyController:
    kind = kind.lower()
    if kind == "bsp":
        return BSP(num_workers)
    if kind == "ssp":
        return SSP(num_workers, staleness=staleness)
    if kind == "asp":
        return ASP(num_workers, sync_every=sync_every)
    raise ValueError(f"unknown consistency kind {kind!r}")
