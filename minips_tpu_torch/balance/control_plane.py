"""Coordinator lease + deterministic succession — half one of the
production control plane (ROADMAP item 3).

Before the lease, the coordinator was a RANK: ``Membership`` and
``Rebalancer`` both hardcoded rank 0 as the planner, and a heartbeat-dead
verdict against it was the documented unrecoverable case — exit 42, gang
restart — even though every survivor already held the state a successor
needs (the membership table from the broadcast protocol, heat reports
re-gossiped every rbH tick, the newest complete checkpoint step via
``ckpt/elastic.find_live_step``). This module makes the coordinator a
LEASE over that rank space instead.

**The succession rule — no election wire protocol.** The lease is a
``(term, holder)`` pair every rank tracks. On a heartbeat-dead verdict
against the holder, every rank advances the lease LOCALLY and
identically: term += 1, holder = the lowest-ranked live rank
(:func:`successor_of`). The heartbeat verdict plus the membership table
already give every rank the same inputs, so no ballots ride the wire —
the "election" is a pure function, exactly like ``KillSpec.resolve``.
The successor then reconstructs coordinator state from what survivors
re-advertise: heat reports re-arrive on the next ``rbH`` tick (the
rebalancer re-gossips every clock), the membership table was never
centralized to begin with, and the newest complete step is re-derived
from the shared checkpoint dir when the death plan needs it. In-flight
``mbJ``/``mbQ`` conversations re-target automatically because their
retry loops address ``membership.coord``, which succession updates.

**Fencing — why the term exists.** A partitioned ex-coordinator that
comes back must not be able to broadcast a conflicting plan. Two
complementary fences:

- RECEIVE fence (:meth:`CoordinatorLease.admit`): every coordinator
  broadcast (``rbP`` plans, ``mbA`` admits, ``mbD`` verdicts) is stamped
  with the issuer's ``lt``/``lh``; receivers DROP frames whose term is
  below their own (counted in ``fenced``). A stale ex-coordinator's
  post-partition plan dies at every receiver.
- SELF fence (:meth:`CoordinatorLease.observe`): lease stamps also ride
  every heartbeat (``HeartbeatMonitor.payload_extra``), max-merged on
  receive — the returning ex-coordinator learns the newer term from the
  first beat it hears and stops planning on its own (``_coord_step``
  checks ``rank != coord``), before it can even try.

The lease holder at term 0 is rank 0 (the launch-time default), so an
armed-but-idle fleet behaves exactly as before — the lockstep harness
pins armed-idle bitwise-equal to off. The successor's ENDPOINT needs no
renegotiation either: the control bus is a full mesh wired at spawn
(``launch.bus_endpoint_of`` maps the membership-table rank back to the
address the launcher advertised), so succession is a rank-id change, not
a respawn.

What still gang-restarts, honestly: a holder death with NO live rank
left to succeed, and a successor that finds no complete checkpoint for
the corpse's owned blocks (``rstep=-1`` — the simultaneous
coordinator+owner death with no checkpoint case docs/fault_tolerance.md
names). The lease narrows the unrecoverable set; it does not pretend to
empty it.

A copy of ``minips_tpu/balance/control_plane.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

from minips_tpu_torch.obs import flight as _fl

__all__ = ["CoordinatorLease", "SuspicionQuorum", "successor_of",
           "quorum_needed", "expand_to_domains"]


def successor_of(live: Iterable[int]) -> Optional[int]:
    """THE succession rule: the lowest-ranked live rank, or None when
    nobody is left to hold the lease. A pure function of the membership
    table so every rank computes the same successor without a ballot."""
    live = set(live)
    return min(live) if live else None


def expand_to_domains(ranks: Iterable[int], group: int,
                      nprocs: int) -> set[int]:
    """Expand a conviction set to WHOLE failure domains: under the
    hybrid data plane (``MINIPS_HIER agg=mesh``) a host's ranks share
    one device mesh, so any member's verdict implicates every rank of
    its contiguous host group (the same ``rank // group`` topology as
    ``balance/hier.host_of``). A pure function of the same inputs at
    every rank — domain verdicts need no extra protocol round, exactly
    like succession. ``group<=1`` is the identity (no domains)."""
    g = max(1, int(group))
    out: set[int] = set()
    for r in ranks:
        h = int(r) // g
        out.update(range(h * g, min((h + 1) * g, int(nprocs))))
    return out


def quorum_needed(live: set[int], suspect: int) -> int:
    """Votes required to convict ``suspect`` out of ``live``: a strict
    majority of the live view, capped at the number of ranks that can
    physically vote (everyone live except the suspect — it cannot vote
    for its own death), floored at 1.

    Why this shape, case by case (``n = |live|``):

    - n = 3, suspect inside: majority 2, voters 2 → BOTH survivors must
      agree — a minority island of one (the asymmetric-partition
      ex-coordinator) can never convict the majority, so it cannot mint
      a term or issue plans. THE split-brain case the quorum hardens.
    - n = 4 split 2/2: majority 3, each island has 2 votes → NEITHER
      side convicts. An even split is detected (gates stall, deadlines
      poison loudly), never resolved by a coin-flip conviction.
    - n = 2: majority would be 2 but only 1 rank can vote → cap at 1,
      the solo conviction of the pre-quorum fleet. Two ranks genuinely
      cannot distinguish a partition from a death — an honest,
      documented limit (docs/fault_tolerance.md), not a regression.
    """
    n = len(live)
    voters = n - (1 if suspect in live else 0)
    return max(1, min(n // 2 + 1, voters))


class SuspicionQuorum:
    """Corroborated death verdicts — the split-brain hardening half of
    the control plane. Each rank's ``HeartbeatMonitor`` turns
    timeout silence into a SUSPICION instead of a verdict; suspicions
    gossip piggybacked on the heartbeats themselves (``sus`` next to
    the lease stamp — the one channel still flowing around a
    partition's edge), and a rank CONVICTS only when the suspect's
    silence is corroborated by :func:`quorum_needed` live ranks. One
    instance per rank, fed by the monitor's sweep thread (my own
    ballot) and the bus receive thread (peers' ballots)."""

    def __init__(self, rank: int):
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._ballots: dict[int, set[int]] = {}  # voter -> suspects
        self.verdicts = 0   # quorum convictions this rank reached
        #                     (incremented by the membership plane at
        #                     the moment it convicts)

    def set_local(self, suspects: Iterable[int]) -> None:
        """Replace MY ballot (monitor sweep: suspicion set changed)."""
        self.vote(self.rank, suspects)

    def mark_local(self, suspect: int, suspected: bool) -> list[int]:
        """Atomically add/remove ONE rank from my ballot and return
        the new ballot — the monitor's suspect hook and the beat
        thread's retraction both mutate it, and a read-modify-write
        outside the lock could lose a retraction to an interleave."""
        with self._lock:
            mine = set(self._ballots.get(self.rank, ()))
            if suspected:
                mine.add(int(suspect))
            else:
                mine.discard(int(suspect))
            if mine:
                self._ballots[self.rank] = mine
            else:
                self._ballots.pop(self.rank, None)
            return sorted(mine)

    def vote(self, voter: int, suspects: Iterable[int]) -> None:
        """Replace ``voter``'s ballot with its latest gossiped
        suspicion set — a beat with an empty ``sus`` retracts."""
        s = {int(x) for x in suspects}
        with self._lock:
            if s:
                self._ballots[int(voter)] = s
            else:
                self._ballots.pop(int(voter), None)

    def drop_voter(self, voter: int) -> None:
        """A convicted/left rank's standing ballot is void."""
        with self._lock:
            self._ballots.pop(int(voter), None)

    def my_suspects(self) -> list[int]:
        """My current ballot, for the heartbeat payload."""
        with self._lock:
            return sorted(self._ballots.get(self.rank, ()))

    def convictable(self, live: set[int]) -> list[int]:
        """Suspects whose silence a majority of ``live`` corroborates
        right now (votes counted from live ranks only — a dead voter's
        stale ballot must not convict anybody)."""
        live = set(live)
        with self._lock:
            tally: dict[int, int] = {}
            for voter, suspects in self._ballots.items():
                if voter not in live and voter != self.rank:
                    continue
                for s in suspects:
                    if s != voter:
                        tally[s] = tally.get(s, 0) + 1
        return sorted(s for s, n in tally.items()
                      if n >= quorum_needed(live, s))

    def voters_for(self, suspect: int, live: set[int]) -> list[int]:
        """Who corroborates ``suspect`` right now — the verdict's WHY,
        recorded into the flight box next to the conviction."""
        live = set(live)
        with self._lock:
            return sorted(v for v, s in self._ballots.items()
                          if suspect in s and v != suspect
                          and (v in live or v == self.rank))

    def stats(self) -> dict:
        with self._lock:
            return {"verdicts": self.verdicts,
                    "ballots": {str(v): sorted(s)
                                for v, s in sorted(self._ballots.items())}}


class CoordinatorLease:
    """``(term, holder)`` with max-merge observation and stale-term
    fencing — one instance per rank, shared by the membership plane and
    the rebalancer's plan wire. Thread-safe: the monitor's sweep thread
    advances it while bus receive threads admit/observe."""

    def __init__(self, initial_holder: int = 0):
        self._lock = threading.Lock()
        self.term = 0
        self.holder = int(initial_holder)
        self.successions = 0   # times THIS rank advanced the lease
        self.handovers = 0     # voluntary transfers THIS rank initiated
        self.fenced = 0        # stale-term frames dropped at this rank

    # ------------------------------------------------------------- stamps
    def stamp(self) -> dict:
        """The wire stamp coordinator broadcasts (and every heartbeat)
        carry: current term + holder. Receivers :meth:`admit` against
        the term and :meth:`observe` the pair."""
        with self._lock:
            return {"lt": self.term, "lh": self.holder}

    def current(self) -> tuple[int, int]:
        with self._lock:
            return self.term, self.holder

    # ------------------------------------------------------------- fences
    def admit(self, payload: dict) -> bool:
        """The receive fence: False (and counted) for a frame stamped
        with a STALE term — a partitioned ex-coordinator's plan must die
        at every receiver. Unstamped frames pass: they predate the lease
        (mixed fleet) or come from unit rigs that never armed it."""
        lt = payload.get("lt")
        if lt is None:
            return True
        with self._lock:
            if int(lt) < self.term:
                self.fenced += 1
                term = self.term
            else:
                return True
        # the fence DECISION and its why (stale term vs held term) into
        # the black box — rare by construction (a partitioned
        # ex-coordinator's tail), so the record is off the hot path
        _fl.record("lease_fenced",
                   {"lt": int(lt), "lh": payload.get("lh"),
                    "term": term})
        return False

    def observe(self, payload: dict) -> bool:
        """Max-merge a term seen on the wire (heartbeat stamps, plan
        stamps). Returns True when the payload taught us a NEWER term —
        the caller re-targets its coordinator view; an ex-holder that
        gets True here has just been fenced out of the role it thinks it
        still holds (the partition-return self fence)."""
        lt, lh = payload.get("lt"), payload.get("lh")
        if lt is None or lh is None:
            return False
        with self._lock:
            if int(lt) > self.term:
                self.term, self.holder = int(lt), int(lh)
                return True
        return False

    # --------------------------------------------------------- succession
    def succeed(self, dead_holder: int, live: Iterable[int]) -> Optional[int]:
        """Advance the lease past a dead holder: term += 1, holder = the
        lowest-ranked live rank. Returns the new holder, the current
        holder unchanged when ``dead_holder`` no longer holds the lease
        (a second verdict racing the first rank's advance), or None when
        no live rank remains (genuinely unrecoverable)."""
        with self._lock:
            if int(dead_holder) != self.holder:
                return self.holder
            succ = successor_of(set(live) - {int(dead_holder)})
            if succ is None:
                return None
            self.term += 1
            self.holder = int(succ)
            self.successions += 1
            return self.holder

    def transfer(self, new_holder: int) -> tuple[int, int]:
        """VOLUNTARY handover by the current holder (graceful drain of
        the coordinator, balance/membership.Membership.handover): term
        += 1, holder = the chosen successor — the same term advance a
        death verdict would cause, minus the death. Advancing the term
        here is what makes the handover partition-proof: any frame the
        old holder has still in flight (or journaled behind a cut link)
        is stamped with the OLD term and dies at every receiver's
        :meth:`admit` fence, exactly like an ex-coordinator returning
        from a partition. Only the holder may call this — the
        membership plane's ``handover()`` enforces it (this object does
        not know the caller's rank)."""
        with self._lock:
            self.term += 1
            self.holder = int(new_holder)
            self.handovers += 1
            return self.term, self.holder

    def stats(self) -> dict:
        with self._lock:
            return {"term": self.term, "holder": self.holder,
                    "successions": self.successions,
                    "handovers": self.handovers,
                    "fenced": self.fenced}
