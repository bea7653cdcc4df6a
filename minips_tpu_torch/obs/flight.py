"""Black-box flight recorder — always on, dumped on every poison path.

The tracer (obs/tracer.py) answers "show me everything" but is OFF by
default: a post-mortem after a seeded SIGKILL (or a real OOM kill) has
nothing unless ``MINIPS_TRACE`` was armed BEFORE the failure. This
module is the aviation answer: a bounded typed event ring every rank
keeps ALWAYS (same off-path discipline as the tracer — one module-attr
load + one branch at quiet call sites; the on-path record is a
``monotonic()`` + tuple + GIL-atomic deque append), recording only the
DECISIONS and DEATHS of the stack:

========== ===================== =================================
cat        kind                  meaning (key args)
========== ===================== =================================
hb         hb_death              heartbeat verdict against a peer
                                 (rank, owns)
hb         hb_stall_forgiven     observer-stall sweep re-baselined
                                 peers (gap_s)
lease      term_advance          lease succession (term, holder,
                                 dead, live)
lease      lease_fenced          stale-term frame dropped (lt, term)
membership death_plan            coordinator issued a death
                                 transition (rank, rstep)
autoscale  as_admit / as_drain   autoscaler action + the signal
                                 values that forced it (shed_rate,
                                 p99_ms, streak)
serve      sv_shed / sv_bp       admission decision + WHY (tokens
                                 denied count at decision time)
reliable   reliable_give_up      retransmission budget exhausted /
                                 journal-evicted seq (unrecovered)
poison     pull_deadline / ...   the poison that killed a wait
========== ===================== =================================

Every POISON path additionally calls :meth:`FlightRecorder.poison`,
which records the reason and atomically dumps the ring (tmp +
``os.replace`` — the tracer's rule; a reader never sees a torn file)
next to a final windowed-metrics snapshot (``snapshot_hook``). The dump
is re-entrant-safe: two poison paths firing concurrently (a gate
timeout racing the heartbeat verdict) serialize on the dump lock and
BOTH reasons land in the file. ``atexit`` dumps too, so a run that dies
by exception — or a launcher-killed straggler that still unwinds —
leaves its box. A SIGKILLed rank leaves nothing (nothing can); its
SURVIVORS' boxes carry the verdict, the term advance, and the death
plan, which is what the post-mortem needs.

Clock alignment rides for free: every heartbeat receipt min-merges
``(t_recv − t_sent)`` per sender into a tiny side table (one dict op
per beat — beats are per-second, not per-frame), and the merge CLI
derives per-rank offsets exactly like ``obs/merge.py`` does from the
tracer's hb instants (NTP two-sample, min-filtered).

CLI::

    python -m minips_tpu_torch.obs.flight <dir-or-files...> [-o merged.json]

prints the per-rank dumps as ONE offset-aligned human-readable
timeline plus a final JSON summary line; exit 0 iff >= 1 dump loaded.

Knob (``MINIPS_FLIGHT``): unset/empty = ON at the default directory
(``<tmp>/minips-flight-<MINIPS_RUN_ID or pid>`` — zero pre-arming, the
point); ``0`` = off (the OBS-TAX honesty arm); ``<dir>[:cap=<events>]``
= explicit directory/ring depth.

A copy of ``minips_tpu/obs/flight.py``, which imports no JAX.
"""

from __future__ import annotations

import atexit
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["FlightRecorder", "FLIGHT", "maybe_init", "init", "record",
           "poison", "checkpoint", "dump_now", "default_dir",
           "reset_for_tests", "sweep_stale_dirs", "load_dumps",
           "merge_dumps", "main"]

# THE global handle (the tracer pattern): ``flight.FLIGHT is None`` is
# the whole cost at a quiet call site when the layer is disabled.
FLIGHT: "Optional[FlightRecorder]" = None

_init_lock = threading.Lock()
_DEFAULT_CAP = 4096


def default_dir() -> str:
    """Where dumps land with NOTHING armed: keyed by the launcher's
    ``MINIPS_RUN_ID`` (every rank of one job shares it; a post-mortem
    knows where to look without any pre-run setup) or this pid for
    launcher-less runs."""
    run = os.environ.get("MINIPS_RUN_ID", "").strip() or str(os.getpid())
    return os.path.join(tempfile.gettempdir(), f"minips-flight-{run}")


class FlightRecorder:
    """One per process. Events are ``(t_mono_s, kind, args)`` tuples —
    args a small dict or None, never mutated after recording. The ring
    drops OLDEST events (the tail of a dying run is the part worth
    keeping)."""

    def __init__(self, rank: int, out_dir: str,
                 cap: int = _DEFAULT_CAP):
        self.rank = int(rank)
        self.out_dir = out_dir
        self.out_path = os.path.join(out_dir,
                                     f"flight-rank{self.rank}.json")
        self.cap = int(cap)
        self._ring: deque = deque(maxlen=self.cap)
        # poison causes: never rotated with the ring, but BOUNDED — a
        # run that keeps poisoning past the cap is in a poison LOOP,
        # and the dropped counter says so louder than 10k repeats would
        self._reasons: list = []
        self.reasons_dropped = 0
        self._hb: dict = {}           # sender -> min (t_recv-t_sent) us
        self._dump_lock = threading.Lock()
        # anchors: wall time lets a human date the box; monotonic is
        # what every event carries (the merge aligns monotonic clocks)
        self._t0_mono = time.monotonic()
        self._t0_wall = time.time()
        self.dumps = 0
        os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------- record
    def ev(self, kind: str, args: dict | None = None) -> None:
        """The hot-path record: monotonic() + tuple + GIL-atomic
        append. No lock, no allocation beyond the tuple."""
        self._ring.append((time.monotonic(), kind, args))

    def hb_sample(self, sender: int, t_sent: float,
                  t_recv: float) -> None:
        """Min-merge one heartbeat's one-way delay (us) per sender —
        the merge CLI's clock-offset input. A dict get + maybe a set
        per beat; beats are ~1/s/peer, nowhere near the frame path."""
        d = (t_recv - t_sent) * 1e6
        cur = self._hb.get(sender)
        if cur is None or d < cur:
            self._hb[sender] = d

    _MAX_REASONS = 1024  # beyond this a run is poison-looping

    # -------------------------------------------------------------- poison
    def poison(self, reason: str, args: dict | None = None) -> None:
        """A poison path fired: record the reason (ring AND the
        reasons list — the ring may rotate it out, the list only stops
        growing at the poison-loop bound, counted) and dump NOW.
        Never raises."""
        t = time.monotonic()
        if len(self._reasons) < self._MAX_REASONS:
            self._reasons.append((t, reason, args))  # GIL-atomic
        else:
            self.reasons_dropped += 1
        self._ring.append((t, reason, args))
        self.dump()

    # --------------------------------------------------------------- dump
    # installed by the trainer: () -> dict, the final windowed-metrics
    # snapshot that rides every dump (None when the window layer is off)
    snapshot_hook: Optional[Callable[[], dict]] = None

    def _events_snapshot(self, ring) -> list:
        # list(deque) copies atomically under the GIL (the tracer's
        # measured result); retry guards exotic implementations
        for _ in range(16):
            try:
                return list(ring)
            except RuntimeError:
                continue
        return []

    def dump(self, path: str | None = None) -> Optional[str]:
        """Atomic, idempotent, re-entrant-safe, never-raising dump of
        the current ring + reasons + hb table + windowed snapshot.
        Concurrent poison paths serialize on the lock; each dump
        rewrites the file whole, so the LAST writer's view (which
        includes every earlier reason — the list is append-only) wins
        and the file is always complete JSON."""
        try:
            path = path or self.out_path
            with self._dump_lock:
                # snapshot UNDER the dump lock, not before it: a dump
                # that snapshots early, then loses the lock race and
                # writes LAST would overwrite the file with a view
                # missing reasons appended in between — the exact
                # torn-concurrent-poisons hole the regression test
                # hammers (caught there: 24 of 30 reasons survived)
                events = self._events_snapshot(self._ring)
                reasons = self._events_snapshot(self._reasons)
                # the hb table mutates on the heartbeat receive thread
                # — same copy-under-retry treatment as the ring, or a
                # resize mid-copy would RuntimeError the dump away
                hb = {}
                for _ in range(16):
                    try:
                        hb = dict(self._hb)
                        break
                    except RuntimeError:
                        continue
                window = None
                hook = self.snapshot_hook
                if hook is not None:
                    try:
                        window = hook()
                    except Exception:  # noqa: BLE001 - box must close
                        window = {"error": "snapshot_hook failed"}

                def row(t, kind, args):
                    e = {"t_us": round(t * 1e6, 1), "kind": kind}
                    if args:
                        e["args"] = args
                    return e

                doc = {
                    "rank": self.rank,
                    "pid": os.getpid(),
                    "run_id": os.environ.get("MINIPS_RUN_ID") or None,
                    "cap": self.cap,
                    "t0_mono_us": round(self._t0_mono * 1e6, 1),
                    "t0_wall": self._t0_wall,
                    "events": [row(*e) for e in events],
                    "reasons": [row(*r) for r in reasons],
                    "reasons_dropped": self.reasons_dropped,
                    "hb_delays_us": {str(s): round(d, 1)
                                     for s, d in sorted(hb.items())},
                    "window": window,
                }
                tmp = f"{path}.tmp{threading.get_ident()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, default=repr)
                os.replace(tmp, path)  # readers never see a torn file
                self.dumps += 1
            return path
        except Exception as e:  # noqa: BLE001 - report, don't propagate
            import sys

            print(f"flight: dump failed: {e!r}", file=sys.stderr)
            return None


# ----------------------------------------------------------- module api
def init(rank: int, out_dir: str | None = None,
         cap: int = _DEFAULT_CAP) -> FlightRecorder:
    """Arm explicitly. Idempotent per process — the first caller wins
    and later callers get the same recorder (in-process multi-rank test
    rigs share one box, exactly like the tracer)."""
    global FLIGHT
    with _init_lock:
        if FLIGHT is not None:
            return FLIGHT
        FLIGHT = FlightRecorder(rank, out_dir or default_dir(), cap=cap)
        atexit.register(_dump_at_exit)
        return FLIGHT


def _parse_spec(spec: str) -> tuple[Optional[str], dict]:
    """``<dir>[:cap=<n>]`` — THE tracer's spec grammar (one parser,
    two knobs); empty dir means the default directory."""
    from minips_tpu_torch.obs.tracer import _parse_spec as _parse

    if not spec:
        return None, {}
    out_dir, kw = _parse(spec, env="MINIPS_FLIGHT")
    return out_dir or None, kw


def maybe_init(rank: int) -> Optional[FlightRecorder]:
    """Arm from ``$MINIPS_FLIGHT`` — which, unlike every other obs
    knob, defaults to ON (empty/unset = default directory): the whole
    point is a post-mortem artifact with zero pre-arming. ``"0"``
    disables (the OBS-TAX off arm)."""
    if FLIGHT is not None:
        return FLIGHT
    spec = os.environ.get("MINIPS_FLIGHT", "").strip()
    if spec == "0":
        return None
    out_dir, kw = _parse_spec(spec)
    return init(rank, out_dir, **kw)


def record(kind: str, args: dict | None = None) -> None:
    """Module-level convenience for call sites that fire rarely (lease
    fences, death plans): one global load + branch when disabled."""
    fl = FLIGHT
    if fl is not None:
        fl.ev(kind, args)


def poison(reason: str, args: dict | None = None) -> None:
    """Record a poison + dump; no-op when disabled, never raises."""
    fl = FLIGHT
    if fl is not None:
        fl.poison(reason, args)


def checkpoint(kind: str, args: dict | None = None) -> None:
    """Record a NON-poison decision and dump the box (autoscaler
    actions: worth a fresh dump so the artifact always carries the
    latest decision, but NOT a failure — it stays out of the reasons
    list and is never flagged on the merged timeline)."""
    fl = FLIGHT
    if fl is not None:
        fl.ev(kind, args)
        fl.dump()


def dump_now() -> Optional[str]:
    fl = FLIGHT
    return fl.dump() if fl is not None else None


def _dump_at_exit() -> None:
    try:
        dump_now()
    except Exception:  # noqa: BLE001 - never fail interpreter teardown
        pass


def reset_for_tests() -> None:
    global FLIGHT
    with _init_lock:
        FLIGHT = None


def sweep_stale_dirs() -> int:
    """Reclaim DEAD runs' default flight directories (tmp hygiene —
    the shm sweepers' contract): a dir whose run-id pid no longer
    exists is unlinked. Numeric run ids only; explicit MINIPS_FLIGHT
    directories are the operator's. Returns dirs removed."""
    import glob
    import shutil

    from minips_tpu_torch.comm.shm_bus import _pid_alive

    removed = 0
    for d in glob.glob(os.path.join(tempfile.gettempdir(),
                                    "minips-flight-*")):
        pid_s = d.rsplit("-", 1)[-1]
        if not pid_s.isdigit():
            continue
        try:
            # the ONE portable liveness contract (shm_bus/_pid_alive,
            # shared with the shm sweepers); a number too big to be a
            # pid at all (a drill's synthetic run id) is dead
            if _pid_alive(int(pid_s)):
                continue
        except OverflowError:
            pass
        try:
            shutil.rmtree(d)
            removed += 1
        except OSError:
            pass
    return removed


# ------------------------------------------------------------ merge CLI
def load_dumps(paths: list[str],
               skipped: Optional[list] = None) -> dict[int, dict]:
    """``{rank: dump doc}`` from files and/or directories (directories
    glob ``flight-rank*.json``).

    A truncated or corrupt dump — a SIGKILL mid-write leaves a partial
    tmp file; disks fill; bit-rot happens — is SKIPPED and reported
    (appended to ``skipped`` as ``(path, reason)``), never raised: the
    merge CLI is the post-mortem tool, and a post-mortem that crashes
    on the one rank that died hardest loses every OTHER rank's box
    with it. The atomic-rename dump discipline makes corruption rare;
    the skip makes it survivable."""
    import glob

    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(
                os.path.join(p, "flight-rank*.json"))))
        else:
            files.append(p)
    out: dict[int, dict] = {}
    for f in files:
        try:
            with open(f) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict):
                raise ValueError("dump is not a JSON object")
            rank = int(doc.get("rank", len(out)))
        except (OSError, json.JSONDecodeError, ValueError,
                TypeError) as e:
            if skipped is not None:
                skipped.append((f, f"{type(e).__name__}: {e}"))
            continue
        out[rank] = doc
    return out


def _estimate_offsets_us(dumps: dict[int, dict]
                         ) -> tuple[dict[int, float], list[int]]:
    """Per-rank monotonic-clock offset vs the lowest loaded rank, from
    the dumps' min-filtered heartbeat delay tables — the same NTP
    two-sample estimate as ``obs/merge.estimate_offsets_us``, read from
    the flight boxes instead of trace events."""
    ranks = sorted(dumps)
    if not ranks:
        return {}, []
    ref = ranks[0]
    offsets = {ref: 0.0}
    unaligned: list[int] = []

    def hb(r):
        # a structurally-broken box (hb table not a dict, delays not
        # numeric) merges unaligned at offset 0 — never crashes the
        # merge (the load_dumps skip contract, one layer down)
        t = dumps[r].get("hb_delays_us")
        return t if isinstance(t, dict) else {}

    for r in ranks[1:]:
        try:
            d_r_ref = hb(r).get(str(ref))
            d_ref_r = hb(ref).get(str(r))
            if d_r_ref is None or d_ref_r is None:
                raise ValueError("no bidirectional sample")
            offsets[r] = (float(d_r_ref) - float(d_ref_r)) / 2.0
        except (ValueError, TypeError):
            offsets[r] = 0.0
            unaligned.append(r)
    return offsets, unaligned


def merge_dumps(dumps: dict[int, dict]) -> tuple[dict, dict]:
    """(merged doc, summary): every rank's events + reasons on one
    offset-aligned timeline, sorted by aligned time."""
    offsets, unaligned = _estimate_offsets_us(dumps)
    rows: list[dict] = []
    malformed: list[int] = []
    for rank, doc in sorted(dumps.items()):
        off = offsets.get(rank, 0.0)
        try:
            # a poison lands in the ring AND the append-only reasons
            # list (the ring may rotate it out, the list never drops)
            # — on the merged timeline each appears once, flagged
            seen_reasons = {(e["t_us"], e["kind"])
                            for e in doc.get("reasons", ())}
            rank_rows = []
            for src, mark in (("events", False), ("reasons", True)):
                for e in doc.get(src, ()):
                    if not mark \
                            and (e["t_us"], e["kind"]) in seen_reasons:
                        continue
                    rank_rows.append(
                        {"t_us": round(float(e["t_us"]) - off, 1),
                         "rank": rank, "kind": e["kind"],
                         "args": e.get("args"), "poison": mark})
        except (KeyError, TypeError, ValueError):
            # a structurally-broken (but valid-JSON) box: report the
            # rank, keep every other rank's timeline — the load_dumps
            # skip contract, one layer up
            malformed.append(rank)
            continue
        rows.extend(rank_rows)
    rows.sort(key=lambda e: e["t_us"])

    def reason_kinds(doc):
        # same tolerance as the row loop: a torn-but-parsing box must
        # not crash the SUMMARY either (reproduced in review: a reason
        # entry missing "kind" survived the row loop's catch only to
        # KeyError here, losing every other rank's timeline)
        try:
            return [e["kind"] for e in doc.get("reasons", ())]
        except (KeyError, TypeError):
            return ["<malformed>"]

    def n_events(doc):
        try:
            return len(doc.get("events", ()))
        except TypeError:
            return 0

    # per-tenant SLO burn rollup (obs/slo.py edges): the burn edge is
    # WHY most of these boxes exist, so the summary names the burning
    # tenants instead of leaving the operator to grep the timeline
    slo_burns: dict = {}
    for e in rows:
        if e["kind"] != "slo_burn":
            continue
        a = e.get("args")
        tenant = a.get("tenant") if isinstance(a, dict) else None
        slo_burns[tenant or "?"] = slo_burns.get(tenant or "?", 0) + 1

    summary = {
        "ranks": sorted(dumps),
        "events": sum(n_events(d) for d in dumps.values()),
        "reasons": {r: reason_kinds(d)
                    for r, d in sorted(dumps.items())},
        "clock_offsets_us": {str(r): round(o, 1)
                             for r, o in sorted(offsets.items())},
        "unaligned_ranks": unaligned,
        "malformed_ranks": malformed,
        "slo_burns": slo_burns,
    }
    doc = {"flight": rows, "windows": {str(r): d.get("window")
                                       for r, d in sorted(dumps.items())},
           "summary": summary}
    return doc, summary


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Merge per-rank flight-recorder dumps into one "
                    "offset-aligned post-mortem timeline")
    ap.add_argument("paths", nargs="+",
                    help="flight dirs and/or flight-rank*.json files")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged JSON doc here too")
    ap.add_argument("--tail", type=int, default=0, metavar="N",
                    help="print only the last N timeline lines")
    args = ap.parse_args(argv)
    skipped: list = []
    dumps = load_dumps(args.paths, skipped=skipped)
    for path, why in skipped:
        # skip-and-REPORT: the operator must see which rank's box was
        # torn (a SIGKILL mid-write), but the merge of the survivors'
        # boxes must proceed — exit 0 iff >= 1 dump loaded
        print(f"flight: skipped corrupt dump {path}: {why}",
              file=sys.stderr)
    if not dumps:
        print(f"flight: no loadable flight-rank*.json under "
              f"{args.paths!r}", file=sys.stderr)
        return 1
    doc, summary = merge_dumps(dumps)
    summary["skipped_files"] = [p for p, _w in skipped]
    rows = doc["flight"]
    t0 = rows[0]["t_us"] if rows else 0.0
    shown = rows[-args.tail:] if args.tail else rows
    for e in shown:
        args_s = "" if not e["args"] else " " + json.dumps(
            e["args"], sort_keys=True, default=repr)
        mark = " !POISON" if e["poison"] else ""
        print(f"+{(e['t_us'] - t0) / 1e6:10.4f}s  rank{e['rank']}  "
              f"{e['kind']}{mark}{args_s}")
    if summary["slo_burns"]:
        burns = ", ".join(f"{t} x{n}" for t, n in
                          sorted(summary["slo_burns"].items()))
        print(f"flight: SLO burn edges on this timeline: {burns}")
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, args.out)
        summary["merged"] = args.out
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
