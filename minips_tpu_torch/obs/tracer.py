"""Per-rank wire-event tracer — ``MINIPS_TRACE=<dir>[:opts]``, off by
default.

Four PRs of overlap, caching, retransmission, and online rebalancing
left the sharded PS with aggregate counters and mean timers but no way
to SEE one request's life across ranks — which rank a gate wait was
stuck on, whether a slow pull was parked at admission, queued behind a
retransmit, or fenced behind a migration. This module is the missing
timeline: every interesting edge of the PS stack records a typed event
into a bounded per-rank ring buffer, and each rank dumps Chrome-trace
JSON at finalize (plus an ``atexit`` hook, so a poisoned/dying run
still leaves a trace). ``minips_tpu_torch.obs.merge`` then aligns the ranks'
clocks and links the flows into ONE timeline.

Design constraints, in order:

- **One branch when off.** The tracer is consulted from the hottest
  paths in the repo (per pull leg, per push frame, per served request).
  Call sites do ``tr = tracer.TRACER`` / ``if tr is not None:`` — a
  module-attribute load and a branch; nothing else exists on the off
  path. No event formatting, no time call, no allocation.
- **Lock-cheap when on.** Events are small tuples appended to a
  ``collections.deque(maxlen=cap)`` — the append is atomic under the
  GIL, so recording takes no lock at all; the ring bound makes a
  runaway run cost bounded memory and drop OLDEST events (the tail of
  a dying run is the part worth keeping).
- **Cross-thread spans.** A pull leg is issued on the training thread
  and completes on the bus receive thread, so spans are recorded as
  single complete ("X") events at their END, carrying the start
  timestamp the caller kept — no begin/end pairing state in the
  tracer.
- **Cross-rank flows.** A client's pull leg and the owner's serve are
  linked by a flow id that both sides can derive independently:
  ``flow_id(f"pull:{table}", client_rank, rid)`` — the client knows
  (me, rid), the owner knows (sender, req). Same trick for push frames
  via the ack seq. The table name is part of the kind because rids and
  push seqs are PER-TABLE counters: without it, two tables' rid 5
  would collide into one arrow.

Event taxonomy (cat/name — the contract ``obs/report.py`` and the
acceptance drills read; keep docs/observability.md in sync):

========== ================ ====================================
cat        name             meaning (key args)
========== ================ ====================================
pull       pull_leg         client: leg issue -> reply processed
                            (owner, rid, bytes)
pull       pull_wait        client: wait() blocked span (owners)
pull       fence_wait       client: local read fenced (blocks)
pull       cache_insert     client: rows cached (n, stamp)
serve      serve_pull       owner: request read+encode+send
                            (from, rid, rows)
serve      serve_pull_all   owner: shard assembly serve (from)
serve      pull_park        owner: request parked (from, rid, why)
serve      parked           owner: park -> serve/refuse span
                            (from, why)
serve      pull_refused     owner: psE epoch refusal (from, rid)
serve      pull_releg       client: refused leg re-split/re-sent
                            (rid, ep, relegs)
push       push_apply       owner: push frame decode+apply (from, n)
push       push_ack         client: frame send -> ack (owner, seq)
push       push_forward     owner: stale push forwarded (to, n)
clock      gate_wait        trainer: SSP gate blocked
                            (clock, behind=[ranks])
clock      tick             trainer: clock advanced (clock)
reliable   retransmit       gap open -> recovered (sender, stream,
                            seq)
reliable   nack             NACK sent (to, stream, n)
reliable   gave_up          seq abandoned (sender, stream, seq)
chaos      drop/dup/        injected fault (kind, sender, seq)
           delay/reorder
rebalance  rb_plan          coordinator: plan published
                            (table, ep, moves)
rebalance  rb_adopt         adoption span (ep, out, moved)
rebalance  rb_fence         block fenced -> released (b, ep)
rebalance  rb_ship          block state shipped (b, dst, rows)
rebalance  rb_install       block state installed (b)
hb         hb               heartbeat received (from, t_sent) —
                            the merge tool's clock-alignment data
========== ================ ====================================

Spec grammar: ``MINIPS_TRACE=/path/to/dir`` or
``MINIPS_TRACE=/path:cap=200000`` (``cap`` = ring depth in events).
Each rank writes ``<dir>/trace-rank<r>.json``.

A copy of ``minips_tpu/obs/tracer.py``, which imports no JAX.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import struct
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Tracer", "TRACER", "maybe_init", "init", "flow_id",
           "dump_now", "reset_for_tests"]

# THE global handle every instrumented module consults:
# ``tracer.TRACER is None`` is the whole off-path cost.
TRACER: "Optional[Tracer]" = None

_init_lock = threading.Lock()
_DEFAULT_CAP = 200_000


def flow_id(kind: str, rank: int, seq: int) -> int:
    """A flow id both ends of a wire edge can derive independently —
    pure function of (kind, originating rank, wire id). Chrome wants a
    uint; 8 hash bytes keep collisions out of any real trace."""
    h = hashlib.blake2b(f"{kind}|{rank}|{seq}".encode(),
                        digest_size=8).digest()
    return struct.unpack("<Q", h)[0] & 0x7FFF_FFFF_FFFF_FFFF


class Tracer:
    """One per process. Events are tuples
    ``(ph, ts_us, dur_us, cat, name, tid, fid, args)`` — ``ph`` is the
    Chrome phase ('X' complete, 'i' instant, 's'/'f' flow), ``fid`` the
    flow id or 0, ``args`` a small dict or None (never mutated after
    recording)."""

    def __init__(self, rank: int, out_dir: str,
                 cap: int = _DEFAULT_CAP):
        self.rank = int(rank)
        self.out_dir = out_dir
        self.out_path = os.path.join(
            out_dir, f"trace-rank{self.rank}.json")
        self.cap = int(cap)
        self._ring: deque = deque(maxlen=self.cap)
        self._tids: dict = {}  # thread ident -> (small tid, name)
        self._tid_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------- record
    def _tid(self) -> int:
        ident = threading.get_ident()
        t = self._tids.get(ident)
        if t is None:
            with self._tid_lock:
                t = self._tids.setdefault(
                    ident, (len(self._tids) + 1,
                            threading.current_thread().name))
        return t[0]

    def instant(self, cat: str, name: str, args: dict | None = None
                ) -> None:
        self._ring.append(("i", time.monotonic() * 1e6, 0.0, cat, name,
                           self._tid(), 0, args))

    def complete(self, cat: str, name: str, t0: float,
                 args: dict | None = None, *,
                 t1: float | None = None) -> None:
        """A span recorded at its END: ``t0`` (and optionally ``t1``)
        are ``time.monotonic()`` seconds the caller kept."""
        end = time.monotonic() if t1 is None else t1
        self._ring.append(("X", t0 * 1e6, max(end - t0, 0.0) * 1e6, cat,
                           name, self._tid(), 0, args))

    def flow(self, phase: str, fid: int, name: str,
             args: dict | None = None) -> None:
        """``phase`` 's' (start, at the emitting edge) or 'f' (finish,
        at the receiving edge). cat/name must match across the pair for
        Chrome to draw the arrow — everything here uses cat='flow'."""
        self._ring.append((phase, time.monotonic() * 1e6, 0.0, "flow",
                           name, self._tid(), fid, args))

    # --------------------------------------------------------------- dump
    def events_snapshot(self) -> list:
        # on CPython list(deque) copies atomically under the GIL
        # (measured: 0 failures in 3000 copies of a full 200k ring
        # under concurrent append), so the retry below is pure
        # defense against an implementation where a mutation can land
        # mid-iteration — and if even the retries lose, say so on
        # stderr rather than silently dumping a metadata-only trace
        for _ in range(16):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        import sys

        print("tracer: ring snapshot kept failing under concurrent "
              "appends; dumping without events", file=sys.stderr)
        return []

    def dump(self, path: str | None = None) -> str:
        """Write the Chrome-trace JSON (idempotent — re-dumping emits
        the current, larger ring; finalize and atexit may both run)."""
        path = path or self.out_path
        events = self.events_snapshot()
        with self._tid_lock:
            tids = dict(self._tids)
        out: list[dict] = [
            {"ph": "M", "pid": self.rank, "tid": 0,
             "name": "process_name",
             "args": {"name": f"rank {self.rank}"}},
            {"ph": "M", "pid": self.rank, "tid": 0,
             "name": "process_sort_index",
             "args": {"sort_index": self.rank}},
        ]
        for _ident, (tid, tname) in sorted(tids.items(),
                                           key=lambda kv: kv[1][0]):
            out.append({"ph": "M", "pid": self.rank, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})
        for ph, ts, dur, cat, name, tid, fid, args in events:
            e = {"ph": ph, "ts": round(ts, 3), "cat": cat, "name": name,
                 "pid": self.rank, "tid": tid}
            if ph == "X":
                e["dur"] = round(dur, 3)
            if ph in ("s", "f"):
                e["id"] = fid
                if ph == "f":
                    e["bp"] = "e"  # bind to enclosing slice end
            if ph == "i":
                e["s"] = "t"  # thread-scoped instant
            if args:
                e["args"] = args
            out.append(e)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"rank": self.rank,
                             "clock": "monotonic_us",
                             "events": len(events),
                             "cap": self.cap}}
        with self._dump_lock:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)  # a reader never sees a torn file
        return path


def _parse_spec(spec: str, env: str = "MINIPS_TRACE"
                ) -> tuple[str, dict]:
    """``<dir>[:k=v,...]`` — the dir may itself contain ':' only on
    platforms where that's pathological anyway; the FIRST ':' followed
    by a ``k=`` form splits. Shared with the flight recorder
    (obs/flight.py), whose ``MINIPS_FLIGHT`` speaks the same grammar —
    ``env`` only names the knob in the error."""
    out_dir, kw = spec, {}
    if ":" in spec:
        head, _, tail = spec.rpartition(":")
        if "=" in tail and head:
            out_dir = head
            for entry in filter(None, (e.strip()
                                       for e in tail.split(","))):
                k, _, v = entry.partition("=")
                if k != "cap":
                    raise ValueError(
                        f"{env}: unknown option {k!r} "
                        "(expected cap=<events>)")
                kw["cap"] = int(v)
    return out_dir, kw


def init(out_dir: str, rank: int, cap: int = _DEFAULT_CAP) -> Tracer:
    """Arm the tracer explicitly (the bench's ``--trace`` flag).
    Idempotent per process: a second init with the same rank returns
    the live tracer; a divergent one raises (two subsystems disagreeing
    about the trace target is a bug, not a preference)."""
    global TRACER
    with _init_lock:
        if TRACER is not None:
            if TRACER.rank != int(rank) or TRACER.out_dir != out_dir \
                    or TRACER.cap != int(cap):
                raise RuntimeError(
                    f"tracer already armed (rank {TRACER.rank}, dir "
                    f"{TRACER.out_dir!r}, cap {TRACER.cap}); re-init "
                    f"asked for rank {rank}, dir {out_dir!r}, cap "
                    f"{cap} — traces would silently land in the first "
                    "target")
            return TRACER
        TRACER = Tracer(rank, out_dir, cap=cap)
        atexit.register(_dump_at_exit)
        return TRACER


def maybe_init(rank: int) -> Optional[Tracer]:
    """Arm from ``$MINIPS_TRACE`` if set (the one env gate); returns the
    tracer or None. Called from every subsystem that knows the rank
    early (trainer/table construction, app bootstrap) — first caller
    wins, the rest get the same object."""
    if TRACER is not None:
        return TRACER
    spec = os.environ.get("MINIPS_TRACE", "")
    if not spec:
        return None
    out_dir, kw = _parse_spec(spec)
    return init(out_dir, rank, **kw)


def dump_now() -> Optional[str]:
    """Dump the armed tracer's ring (finalize / poison paths); no-op
    when the layer is off. NEVER raises: it runs inside finalize's
    ``finally`` and right before the bench's done line — observability
    must not kill (or mask the real exception of) the run it
    observes."""
    if TRACER is None:
        return None
    try:
        return TRACER.dump()
    except Exception as e:  # noqa: BLE001 - report, don't propagate
        import sys

        print(f"tracer: dump failed: {e!r}", file=sys.stderr)
        return None


def _dump_at_exit() -> None:
    try:
        dump_now()
    except Exception:  # noqa: BLE001 - never fail interpreter teardown
        pass


def reset_for_tests() -> None:
    """Drop the global tracer (tests arm/disarm repeatedly; production
    never calls this)."""
    global TRACER
    with _init_lock:
        TRACER = None
