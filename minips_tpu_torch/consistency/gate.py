"""StalenessGate — the multi-process BSP/SSP/ASP admission rule.

One gate object per process wraps ClockGossip with the unified admission
rule the reference's consistency models implement server-side (SURVEY.md §2
BSP/SSP/ASPModel): before running step ``c+1`` a process blocks until
``global_min_clock >= c + 1 - staleness`` (0 = BSP lockstep, s = SSP
bounded staleness, inf = ASP never waits). Shared by SSPTrainer (replicated
delta relay) and ShardedPSTrainer (key-range-sharded PS) so the distinctive
consistency axis has exactly one implementation.

A timed-out wait consults the heartbeat monitor: dead peers raise
PeerFailureError (recovery cue, SURVEY.md §5.3) instead of hanging the gate
forever on a corpse.

A copy of ``minips_tpu/consistency/gate.py``, which imports no JAX.
"""

from __future__ import annotations

import time

from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc


# A retired (out-of-data) worker's published clock: far above any real
# clock so it never gates peers. Sticky — finalize-time clock publishes
# must go through publish_clock() so they cannot clobber the sentinel
# (a clobber re-gates still-running peers on the finished worker:
# straggler+SSP deadlock).
RETIRED_CLOCK = 1 << 30


def admits(global_min: float, clk: int, staleness: float) -> bool:
    """THE BSP/SSP/ASP admission predicate, in one place: a read stamped
    with requester clock ``clk`` may be served from state whose freshness
    certificate is ``global_min`` iff ``global_min >= clk − staleness``
    (BSP: s=0, SSP: bounded s, ASP: ∞ ⇒ always).

    Three call sites share it deliberately: the owner-side pull
    admission (``ShardedPSTrainer.admit_pull`` — serve or park), the
    client row cache's validity rule (``train/sharded_ps.RowCache`` — a
    cached row whose pull reply was stamped ``global_min = g`` by its
    owner may satisfy a later pull at clock ``c`` iff
    ``admits(g, c, s)``), and the serving plane's replica admission
    (``serve/plane.TableServeState._on_replica_pull`` — a replica
    serves from a snapshot stamped ``g`` iff the same predicate holds,
    else it refuses and the client falls back to the owner). One
    predicate means a cache hit or a replica hit is admissible exactly
    when a synchronous pull served under min-view ``g`` would have been
    — the staleness proof lives in the stamp, not in a second, weaker
    rule."""
    if staleness == float("inf"):
        return True
    return global_min >= clk - int(staleness)


def publish_clock(gossip, clock: int, retired: bool) -> None:
    """The one place trainer clocks reach the gossip layer — retirement
    stickiness lives here so every trainer gets it."""
    gossip.publish_local([RETIRED_CLOCK if retired else clock])


class PeerFailureError(RuntimeError):
    """Raised when the staleness gate times out and heartbeats show dead
    peers — the caller's cue to run recovery (SURVEY.md §5.3)."""

    def __init__(self, dead: set[int]):
        super().__init__(f"peer process(es) {sorted(dead)} failed")
        self.dead = dead


class FencedOutError(PeerFailureError):
    """Raised on a rank that learns the fleet CONVICTED IT dead and
    moved on (a partition outlasted the quorum verdict; the death plan
    re-homed this rank's ranges from a checkpoint). The convicted-but-
    alive rank must stop participating — its term is fenced at every
    receiver, but its pushes would still land as zombie writes — so it
    lingers briefly for journal drain (peers recover its cut frames)
    and exits via this distinct poison. Subclasses PeerFailureError on
    purpose: to every generic handler this IS a peer failure — the
    failed peer is us."""

    def __init__(self, rank: int, term: int):
        super().__init__({int(rank)})
        self.args = (f"rank {rank} was convicted dead by the fleet "
                     f"(lease term {term}) — fenced out",)
        self.rank = int(rank)
        self.term = int(term)


class StalenessGate:
    def __init__(self, gossip, staleness: float, *,
                 timeout: float = 60.0, monitor=None):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.gossip = gossip
        self.staleness = staleness
        self.timeout = timeout
        self.monitor = monitor
        # elastic membership plane (balance/membership.py), when armed:
        # a death the plane owns excludes the corpse from gossip (the
        # gate recomputes over the shrunken membership) and is NOT
        # fatal here — only unrecoverable deaths still raise
        self.membership = None
        # optional per-iteration hook run while BLOCKED (the sharded
        # trainer wires plan adoption + coordinator death-transition
        # polling here): the gate runs on the push-driving thread, and
        # a plan that lands while this rank is gate-blocked must still
        # be adopted — a peer whose pull is epoch-parked against our
        # un-adopted table may be the very rank whose clock this gate
        # is waiting on (the gate-block/epoch-park deadlock the
        # control-plane failover drill exposed: the successor's death
        # plan arrived at a rank already inside its gate wait, two
        # clocks ahead of the paced successor)
        self.poll_hook = None
        # fail-slow corroboration feed (obs/slowness.py, wired by the
        # trainer when MINIPS_SLOW is armed): fired with the behind
        # list whenever the gate actually blocks — gate-behind COUNTS,
        # an observable the SlownessMonitor surfaces next to its
        # latency evidence (it does not vote: gate lag is often the
        # victim of slowness elsewhere)
        self.on_behind = None
        self.gate_waits = 0      # times the gate actually blocked
        self.max_skew_seen = 0   # max (my_clock - global_min) observed

    def wait(self, clock: int) -> None:
        """Block until global_min >= clock - staleness (the SSP rule)."""
        if self.staleness == float("inf"):
            return
        threshold = clock - int(self.staleness)
        if threshold <= 0:
            return
        gmin = self.gossip.global_min()
        self.max_skew_seen = max(self.max_skew_seen, clock - gmin)
        if gmin >= threshold:
            return
        self.gate_waits += 1
        t_wait0 = time.monotonic()
        tr = _trc.TRACER
        behind: list[int] = []
        if tr is not None or self.on_behind is not None:
            # WHO the gate is missing — the blocked-time attribution
            # the straggler report is built from (obs/report.py), and
            # the fail-slow monitor's gate-behind observable
            snap = self.gossip.snapshot()
            excluded = self.gossip.excluded
            behind = sorted(p for p, v in snap.items()
                            if v and p not in excluded
                            and min(v) < threshold)
            if self.on_behind is not None and behind:
                self.on_behind(behind)
        deadline = time.monotonic() + self.timeout
        try:
            while not self.gossip.wait_global_min(
                    threshold, timeout=min(1.0, self.timeout)):
                if self.poll_hook is not None:
                    self.poll_hook()
                dead = set(self.monitor.check()
                           if self.monitor is not None else ())
                if dead and self.membership is not None:
                    dead = self.membership.fatal_dead(dead)
                if dead:
                    for p in dead:
                        self.gossip.exclude(p)
                    _fl.poison("gate_peer_failure",
                               {"clock": clock, "dead": sorted(dead)})
                    raise PeerFailureError(dead)
                if time.monotonic() > deadline:
                    _fl.poison("gate_deadline",
                               {"clock": clock,
                                "global_min": self.gossip.global_min(),
                                "staleness": self.staleness})
                    raise TimeoutError(
                        f"SSP gate timed out at clock {clock} "
                        f"(global_min={self.gossip.global_min()}, "
                        f"staleness={self.staleness})")
        finally:
            if tr is not None:
                tr.complete("clock", "gate_wait", t_wait0,
                            {"clock": clock, "behind": behind})
