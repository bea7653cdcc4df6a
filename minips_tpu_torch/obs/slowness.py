"""Fail-slow detection — per-peer windowed service-latency suspicion.

The fault model so far is binary: a rank is alive (heartbeats land) or
dead (timeout → suspicion → quorum verdict, balance/control_plane.py).
A rank that is SLOW-but-alive — throttled CPU, a sick NIC, one bad
link — never trips any of that: its beats land, so it is never a
death suspect, while it stalls every SSP gate and rides every pull to
the deadline. At fleet scale that gray failure is the dominant
production failure mode, and the reference's only answer is to wait.

This module is the DETECTION rung of the fail-slow ladder
(docs/fault_tolerance.md): per-peer service-latency signals the stack
already measures per leg — pull-leg round trips (``_on_pull_reply``
pops the leg's issue stamp), push-ack lag (``_settle_acks`` knows each
frame's send time and owner), gate-behind counts (which ranks the SSP
gate waited on) — feed one :class:`SlownessMonitor` per rank. At every
clock boundary the monitor rolls per-peer histogram deltas into a
bounded ring (the obs/window.py trick pointed at peers instead of
signals) and judges:

    a peer is a SLOW-SUSPECT when its windowed p99 sits ``factor``×
    above the fleet's (lower-)median peer p99 — AND above an absolute
    ``min_ms`` floor, with at least ``min_samples`` in the window —
    for ``windows`` consecutive rolls.

Why relative-to-median: an oversubscribed OBSERVER sees every peer
slow at once, which raises the median with the suspect and convicts
nobody — the self-protection a fixed threshold cannot give. Why the
LOWER median: with two peers (a 3-rank fleet) the median must be the
healthy one, or the sick peer could never clear ``factor×`` its own
contribution. Honest limit, documented: a 2-rank fleet has ONE peer,
whose p99 IS the median — no relative signal exists, so this monitor
never suspects there (exactly the 2-fleet quorum limit of the death
path, and for the same reason: one observation cannot corroborate
itself).

Suspicion is LOCAL and retractable: the monitor fires
``on_slow(peer, True/False)`` transitions; the membership plane
gossips the ballot piggybacked on heartbeats (``slw`` next to the
``sus`` death ballot) and a SLOW VERDICT needs the same
strict-majority :class:`~minips_tpu_torch.balance.control_plane.SuspicionQuorum`
corroboration — a rank with one bad inbound link has one complainer
and is never convicted; a minority island cannot demote the majority.
A verdict is NOT sticky: it stands only while the quorum stands, so a
recovered rank's demotion bias lifts by itself.

Stall forgiveness, mirrored from the heartbeat monitor: an observer
whose own roll cadence gapped past ``stall`` seconds was in a coma —
its latency samples are as undateable as a coma observer's death
suspicions — so it re-baselines every peer, retracts its standing
ballots, and counts the forgiveness (a GC pause or a busy-but-healthy
host must never demote anyone; the false-positive drill pins it).

Armed by ``MINIPS_SLOW`` (off by default)::

    MINIPS_SLOW="1"                                  # every default
    MINIPS_SLOW="factor=3,windows=3,min_ms=20,demote=4,drain_after=0"

Knob table: docs/api.md "Fail-slow plane".

A copy of ``minips_tpu/obs/slowness.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs.hist import (Log2Histogram, N_BUCKETS, quantile_us,
                                 summarize_counts)

__all__ = ["SlownessConfig", "SlownessMonitor", "maybe_build"]


class SlownessConfig:
    """Parsed ``MINIPS_SLOW`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default)."""

    def __init__(self, *, factor: float = 3.0, windows: int = 3,
                 window: int = 4, min_ms: float = 20.0,
                 min_samples: int = 8, demote: float = 4.0,
                 drain_after: int = 0, stall: float = 0.0):
        if factor <= 1.0:
            raise ValueError("MINIPS_SLOW: factor must be > 1 (a "
                             "hysteresis multiple at or below 1 would "
                             "suspect the median itself)")
        if windows < 1:
            raise ValueError("MINIPS_SLOW: windows must be >= 1 roll")
        if window < 1:
            raise ValueError("MINIPS_SLOW: window must be >= 1 roll")
        if min_ms < 0:
            raise ValueError("MINIPS_SLOW: min_ms must be >= 0")
        if min_samples < 1:
            raise ValueError("MINIPS_SLOW: min_samples must be >= 1 "
                             "(a judgment needs evidence)")
        if demote < 0:
            raise ValueError("MINIPS_SLOW: demote must be >= 0 "
                             "(0 = no heat bias; it is a load "
                             "multiplier, not a rate)")
        if demote and demote <= 1.0:
            raise ValueError("MINIPS_SLOW: demote is a load multiplier "
                             "> 1 (or 0 for off) — a bias at or below "
                             "1 demotes nothing")
        if drain_after < 0:
            raise ValueError("MINIPS_SLOW: drain_after must be >= 0 "
                             "holder ticks (0 = drain escalation off)")
        if stall < 0:
            raise ValueError("MINIPS_SLOW: stall must be >= 0 seconds")
        self.factor = float(factor)        # p99-over-median multiple
        self.windows = int(windows)        # consecutive slow rolls
        self.window = int(window)          # rolls per judged window
        self.min_ms = float(min_ms)        # absolute p99 floor
        self.min_samples = int(min_samples)
        self.demote = float(demote)        # planner load bias (0=off)
        self.drain_after = int(drain_after)  # holder ticks -> drain
        self.stall = float(stall)          # observer-coma forgiveness

    @classmethod
    def parse(cls, spec: str) -> "Optional[SlownessConfig]":
        """None = the plane is OFF (empty/``"0"``); a config
        otherwise. Unknown knobs and bad values refuse loudly — the
        fuzzer contract shared with every MINIPS_* spec."""
        spec = (spec or "").strip()
        if not spec or spec == "0":
            return None
        if spec in ("1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"factor": float, "min_ms": float, "demote": float,
                 "stall": float, "windows": int, "window": int,
                 "min_samples": int, "drain_after": int}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_SLOW: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_SLOW: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_SLOW: bad value for {k}: {v!r}") from e
        return cls(**kw)


def maybe_build(rank: int, nprocs: int,
                spec: Optional[str] = None) -> "Optional[SlownessMonitor]":
    """Build from an explicit spec or ``$MINIPS_SLOW`` (explicit wins,
    the shared knob convention); None when the plane is off."""
    if spec is None:
        spec = os.environ.get("MINIPS_SLOW", "")
    cfg = SlownessConfig.parse(spec)
    if cfg is None:
        return None
    return SlownessMonitor(rank, nprocs, cfg)


def lower_median(vals: list[float]) -> Optional[float]:
    """The LOWER median (element ``(n-1)//2`` of the sorted list) —
    see the module docstring for why the lower one: the healthy half
    must anchor the baseline even at n=2."""
    if not vals:
        return None
    vals = sorted(vals)
    return vals[(len(vals) - 1) // 2]


class SlownessMonitor:
    """Per-rank fail-slow detector. ``note()`` runs on bus receive
    threads (pull replies, ack settles) — one histogram bucket
    increment; ``roll()`` runs on the push-driving thread at each
    clock boundary — the only place judgments and hook firings happen,
    so ``on_slow`` transitions are single-threaded by construction
    (unlike the heartbeat monitor's sweep-vs-beat races, there is no
    second transition thread to serialize against)."""

    def __init__(self, rank: int, nprocs: int, cfg: SlownessConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.rank = int(rank)
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        peers = [p for p in range(int(nprocs)) if p != self.rank]
        self._hist: dict[int, Log2Histogram] = {
            p: Log2Histogram() for p in peers}
        self._last: dict[int, list[int]] = {
            p: [0] * N_BUCKETS for p in peers}
        self._ring: dict[int, deque] = {
            p: deque(maxlen=cfg.window) for p in peers}
        self._behind: dict[int, int] = {p: 0 for p in peers}
        self._streak: dict[int, int] = {p: 0 for p in peers}
        self._suspect: set[int] = set()
        self._last_roll: Optional[float] = None
        self._last_p99: dict[int, Optional[float]] = {}
        # transitions the membership plane gossips (and the flight
        # recorder books): fired from roll()/retract_all() only
        self.on_slow: Optional[Callable[[int, bool], None]] = None
        self.counters = {"rolls": 0, "suspects_raised": 0,
                         "suspects_retracted": 0, "stall_forgiven": 0}

    # ------------------------------------------------------------- signals
    def note(self, peer: int, seconds: float) -> None:
        """One service-latency sample against ``peer`` — a pull leg's
        issue→reply round trip or a push frame's send→ack lag, both
        measured at call sites that already hold the timestamps. One
        ``bit_length`` + increment; dead-cheap by design (this runs
        per reply on the receive thread)."""
        h = self._hist.get(int(peer))
        if h is not None:
            h.record_s(seconds)

    def note_behind(self, peers) -> None:
        """Gate-behind counts (consistency/gate.py knows WHICH ranks a
        blocked gate waited on): a corroborating observable surfaced
        in stats(), not a conviction input — gate lag is often the
        VICTIM of slowness elsewhere, so it must not vote."""
        with self._lock:
            for p in peers:
                if int(p) in self._behind:
                    self._behind[int(p)] += 1

    def exclude(self, peer: int) -> None:
        """A dead/left rank leaves the judged set (its tail latency is
        the death path's business, and a corpse must not drag the
        fleet median)."""
        with self._lock:
            p = int(peer)
            self._hist.pop(p, None)
            self._last.pop(p, None)
            self._ring.pop(p, None)
            self._streak.pop(p, None)
            was = p in self._suspect
            self._suspect.discard(p)
        if was and self.on_slow is not None:
            self.on_slow(p, False)

    # ---------------------------------------------------------------- roll
    def roll(self) -> None:
        """Close the interval at the clock boundary: per-peer hist
        deltas into the ring, then judge. Stall forgiveness first: a
        roll gap past ``stall`` means THIS observer was descheduled
        and every sample in the gap is tainted by our own coma — re-
        baseline, retract, and judge nothing this boundary."""
        now = self._clock()
        retract: list[int] = []
        raise_s: list[int] = []
        with self._lock:
            last, self._last_roll = self._last_roll, now
            self.counters["rolls"] += 1
            if (self.cfg.stall > 0 and last is not None
                    and now - last > self.cfg.stall):
                for p, h in self._hist.items():
                    self._last[p] = h.snapshot()
                    self._ring[p].clear()
                    self._streak[p] = 0
                retract = sorted(self._suspect)
                self._suspect.clear()
                self.counters["stall_forgiven"] += 1
                fl = _fl.FLIGHT
                if fl is not None:
                    fl.ev("slow_stall_forgiven",
                          {"gap_s": round(now - last, 3),
                           "retracted": retract})
            else:
                p99s: dict[int, Optional[float]] = {}
                for p, h in self._hist.items():
                    cur = h.snapshot()
                    prev = self._last[p]
                    self._ring[p].append(
                        [max(c - q, 0) for c, q in zip(cur, prev)])
                    self._last[p] = cur
                    win = [0] * N_BUCKETS
                    for delta in self._ring[p]:
                        for i, c in enumerate(delta):
                            win[i] += c
                    n = sum(win)
                    if n >= self.cfg.min_samples:
                        v = quantile_us(win, 0.99)
                        p99s[p] = (round(v / 1e3, 4)
                                   if v is not None else None)
                    else:
                        p99s[p] = None
                self._last_p99 = p99s
                med = lower_median(
                    [v for v in p99s.values() if v is not None])
                for p, v in p99s.items():
                    slow = (v is not None and med is not None
                            and len(p99s) >= 2
                            and v >= self.cfg.min_ms
                            and v >= self.cfg.factor * med)
                    if slow:
                        self._streak[p] += 1
                        if (self._streak[p] >= self.cfg.windows
                                and p not in self._suspect):
                            self._suspect.add(p)
                            self.counters["suspects_raised"] += 1
                            raise_s.append(p)
                    else:
                        self._streak[p] = 0
                        if p in self._suspect:
                            self._suspect.discard(p)
                            self.counters["suspects_retracted"] += 1
                            retract.append(p)
        hook = self.on_slow
        if hook is not None:
            # transitions OUTSIDE the lock (the hook gossips/records):
            # roll() is single-threaded, so order is preserved
            for p in retract:
                hook(p, False)
            for p in raise_s:
                hook(p, True)

    def retract_all(self) -> None:
        """Heartbeat stall-forgiveness hook (comm/heartbeat.py
        ``on_stall_forgiven``): a coma observer's slow ballots are as
        undateable as its death ballots — retract them all and reset
        streaks, exactly like the death suspicion's retraction."""
        with self._lock:
            retract = sorted(self._suspect)
            self._suspect.clear()
            for p in self._streak:
                self._streak[p] = 0
            if retract:
                self.counters["suspects_retracted"] += len(retract)
                self.counters["stall_forgiven"] += 1
        hook = self.on_slow
        if hook is not None:
            for p in retract:
                hook(p, False)

    # -------------------------------------------------------------- reads
    @property
    def suspects(self) -> set[int]:
        with self._lock:
            return set(self._suspect)

    def peer_p99_ms(self, peer: int) -> Optional[float]:
        """The last roll's windowed p99 against ``peer`` (None = no
        evidence) — the hedge plane's per-owner delay hint and the
        drill's observable."""
        with self._lock:
            return self._last_p99.get(int(peer))

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["suspects"] = sorted(self._suspect)
            out["streaks"] = {str(p): s for p, s in
                              sorted(self._streak.items()) if s}
            out["p99_ms"] = {str(p): v for p, v in
                             sorted(self._last_p99.items())}
            out["gate_behind"] = {str(p): n for p, n in
                                  sorted(self._behind.items()) if n}
            out["factor"] = self.cfg.factor
            out["windows"] = self.cfg.windows
        return out

    def peer_summary(self, peer: int) -> dict:
        """Cumulative per-peer latency summary (tests/debugging)."""
        h = self._hist.get(int(peer))
        return summarize_counts(h.snapshot()) if h is not None \
            else {"count": 0}
