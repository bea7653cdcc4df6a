"""Host-side step timing for throughput accounting (SURVEY.md §5.1).

The [T1] primary metric is samples/sec/chip (BASELINE.json:2), so timing is a
first-class utility, not an afterthought. ``StepTimer`` excludes the first
``warmup_steps`` (compile-bearing) steps from steady-state rate computation —
under XLA the first invocation traces + compiles (~20-40s cold on TPU) and
would poison a naive average. ``warmup_steps=0`` counts everything from
construction time.

A copy of ``minips_tpu/utils/timing.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time

from minips_tpu_torch.obs.hist import Log2Histogram, N_BUCKETS, \
    merge_counts, summarize_counts

# the scalar counters a CommTimers snapshot carries (the histograms
# ride separately as bucket-count lists) — one list so snapshot, merge
# and the zero-snapshot can never drift apart
_FIELDS = ("pulls", "pull_latency_s", "pull_blocked_s", "push_acks",
           "push_ack_latency_s", "pull_rows_requested",
           "pull_rows_wire", "cache_hits", "cache_lookups")
_HISTS = ("pull_latency", "pull_blocked", "push_ack")


class CommTimers:
    """Per-leg wire timing for the overlapped PS pipeline
    (train/sharded_ps.py): pull send→last-reply latency vs. the time the
    caller actually spent BLOCKED waiting for it, and push send→ack
    latency. The interesting derived number is ``pull_overlap_fraction``
    — the share of pull latency hidden behind other work (1.0 = fully
    prefetched, 0.0 = fully synchronous); it is what the
    ``overlap_on_off_3proc`` bench sweep exists to move.

    Each quantity additionally feeds a fixed-bucket log2 histogram
    (obs/hist.py) so the done lines carry p50/p95/p99 next to the means
    — the tail is what the overlap and cache sweeps actually fight, and
    a mean cannot show it.

    Thread-safe: replies and acks land on the bus receive thread while
    the training thread records its blocked time. All cross-timer
    reading goes through :meth:`snapshot` — one lock acquisition per
    timer, everything copied out under it — and :meth:`summarize` turns
    any snapshot (or merged snapshots) into the summary dict, so
    aggregation never reads live fields piecemeal."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pulls = 0
        self.pull_latency_s = 0.0   # sent → last reply ARRIVED
        self.pull_blocked_s = 0.0   # caller actually waiting in wait()
        self.push_acks = 0
        self.push_ack_latency_s = 0.0  # frame send → ack received
        # pull-leg ROW flow (the dedup + row-cache observables): how many
        # rows callers asked for vs how many actually crossed the wire —
        # the gap is dupes collapsed, own-shard rows, and cache hits
        self.pull_rows_requested = 0
        self.pull_rows_wire = 0
        self.cache_hits = 0
        self.cache_lookups = 0
        # log2 latency histograms, guarded by self._lock (recorded in
        # the same critical sections as the sums they shadow)
        self.hists = {name: Log2Histogram() for name in _HISTS}

    def record_pull(self, latency_s: float, blocked_s: float) -> None:
        with self._lock:
            self.pulls += 1
            self.pull_latency_s += max(latency_s, 0.0)
            self.pull_blocked_s += max(blocked_s, 0.0)
            self.hists["pull_latency"].record_us_locked(
                max(latency_s, 0.0) * 1e6)
            self.hists["pull_blocked"].record_us_locked(
                max(blocked_s, 0.0) * 1e6)

    def record_pull_rows(self, requested: int, wire: int,
                         hits: int = 0, lookups: int = 0) -> None:
        """Per-request row accounting: ``requested`` keys asked for,
        ``wire`` unique miss rows actually sent to owners, and the row
        cache's hit/lookup counts for this request (0/0 when cache-off)."""
        with self._lock:
            self.pull_rows_requested += int(requested)
            self.pull_rows_wire += int(wire)
            self.cache_hits += int(hits)
            self.cache_lookups += int(lookups)

    def record_push_ack(self, latency_s: float) -> None:
        with self._lock:
            self.push_acks += 1
            self.push_ack_latency_s += max(latency_s, 0.0)
            self.hists["push_ack"].record_us_locked(
                max(latency_s, 0.0) * 1e6)

    @property
    def pull_overlap_fraction(self) -> float | None:
        """1 − blocked/latency over all pulls; None before any pull.
        Clamped at 0 (scheduling jitter can make blocked ≥ latency)."""
        with self._lock:
            if self.pull_latency_s <= 0.0:
                return None
            return max(0.0, 1.0 - self.pull_blocked_s
                       / self.pull_latency_s)

    def snapshot(self) -> dict:
        """Every counter + histogram, copied out under ONE lock
        acquisition — the only sanctioned way to read a live timer
        (the old ``aggregate`` reached into other timers' fields one
        lock at a time, so two timers could be read at inconsistent
        points mid-update)."""
        with self._lock:
            snap = {f: getattr(self, f) for f in _FIELDS}
            snap["hists"] = {n: list(h.counts)
                             for n, h in self.hists.items()}
        return snap

    @staticmethod
    def zero_snapshot() -> dict:
        snap = {f: 0 if f in ("pulls", "push_acks",
                              "pull_rows_requested", "pull_rows_wire",
                              "cache_hits", "cache_lookups") else 0.0
                for f in _FIELDS}
        snap["hists"] = {n: [0] * N_BUCKETS for n in _HISTS}
        return snap

    @staticmethod
    def merge_snapshots(snaps: "list[dict]") -> dict:
        out = CommTimers.zero_snapshot()
        for s in snaps:
            for f in _FIELDS:
                out[f] += s[f]
            for n in _HISTS:
                out["hists"][n] = merge_counts(
                    [out["hists"][n], s["hists"][n]])
        return out

    @staticmethod
    def summarize(snap: dict) -> dict:
        """Flat JSON-able record from a snapshot (live or merged) —
        means AND log2-histogram p50/p95/p99, side by side."""
        pulls, acks = snap["pulls"], snap["push_acks"]
        out = {
            "pulls": pulls,
            "pull_latency_ms_mean": round(
                1e3 * snap["pull_latency_s"] / pulls, 4)
            if pulls else None,
            "pull_blocked_ms_mean": round(
                1e3 * snap["pull_blocked_s"] / pulls, 4)
            if pulls else None,
            "push_acks": acks,
            "push_ack_ms_mean": round(
                1e3 * snap["push_ack_latency_s"] / acks, 4)
            if acks else None,
            # rows-local vs rows-wire: requested − wire = dupes +
            # own-shard rows + cache hits served without a frame
            "pull_rows_requested": snap["pull_rows_requested"],
            "pull_rows_wire": snap["pull_rows_wire"],
            "pull_rows_local": (snap["pull_rows_requested"]
                                - snap["pull_rows_wire"]),
            "cache_hits": snap["cache_hits"],
            "cache_lookups": snap["cache_lookups"],
            "cache_hit_rate": round(
                snap["cache_hits"] / snap["cache_lookups"], 4)
            if snap["cache_lookups"] else None,
        }
        # tail quantiles next to the means, same naming scheme
        for name, key in (("pull_latency", "pull_latency_ms"),
                          ("pull_blocked", "pull_blocked_ms"),
                          ("push_ack", "push_ack_ms")):
            s = summarize_counts(snap["hists"][name])
            for q in ("p50_ms", "p95_ms", "p99_ms"):
                out[f"{key}_{q[:-3]}"] = s.get(q)
        lat = snap["pull_latency_s"]
        out["pull_overlap_fraction"] = (
            round(max(0.0, 1.0 - snap["pull_blocked_s"] / lat), 4)
            if lat > 0.0 else None)
        return out

    def summary(self) -> dict:
        return self.summarize(self.snapshot())

    @staticmethod
    def aggregate(timers: "list[CommTimers]") -> dict:
        """One summary over several tables' timers (count-weighted):
        snapshot each under its own lock, merge, summarize."""
        return CommTimers.summarize(CommTimers.merge_snapshots(
            [t.snapshot() for t in timers]))


class StepTimer:
    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = max(int(warmup_steps), 0)
        self._steps = 0
        self._samples = 0
        self._t_start: float | None = (
            time.monotonic() if self.warmup_steps == 0 else None)
        self._t_last: float | None = None

    def step(self, n_samples: int) -> None:
        now = time.monotonic()
        self._steps += 1
        if self._steps == self.warmup_steps:
            # last warmup step just finished: steady state begins now
            self._t_start = now
            self._samples = 0
        elif self._steps > self.warmup_steps:
            self._samples += n_samples
        self._t_last = now

    @property
    def steady_seconds(self) -> float:
        if self._t_start is None or self._t_last is None:
            return 0.0
        return max(self._t_last - self._t_start, 0.0)

    @property
    def samples_per_sec(self) -> float:
        s = self.steady_seconds
        return self._samples / s if s > 0 else 0.0
