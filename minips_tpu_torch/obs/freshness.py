"""Push-visible-at-replica freshness tracking — the metric a recsys
fleet is paid on, measured with the stamps the serving plane already
ships.

Freshness is the wall time between a push landing at its OWNER and that
value being servable at a REPLICA. Every drill before this layer was
about read latency or staleness BOUNDS (the gate's ``admits`` proof);
none measured the lag itself. The plumbing is one head field: the owner
stamps each refresh frame with ``fts`` — the monotonic time of the
OLDEST push contained in that batch (per granted block, ``note_push``
records first-dirty time; the refresh pops it with the dirty set) — and
the replica records ``now - fts`` on delta apply. Grant snapshots stamp
``fts`` with the owner's state-read time, so their lag is pure
ship+install delay.

Honest limits, stated here because the number is only as good as they
are:

- **Refresh-interval-quantized.** A push becomes visible when the NEXT
  owner refresh ships, so observed lag ~= U(0, interval) + wire + apply.
  A p99 near the serve ``interval`` knob is the floor, not a problem.
- **Cross-process clocks.** ``fts`` is the owner's ``time.monotonic()``
  compared against the replica's. On one Linux host CLOCK_MONOTONIC is
  system-wide, so the loopback benches measure real lag (ms-scale
  scheduler noise). Across hosts the raw difference absorbs the boot
  offset — multi-host numbers need the flight-recorder offset alignment
  (obs/flight.py) applied first, and this layer does not pretend
  otherwise.
- **Renew-only frames carry no ``fts``.** A lease renewal with no dirty
  rows contains no push, so there is nothing to be fresh about; those
  frames are counted (``unstamped_frames``) but record no lag.

One tracker per (table, rank) — i.e. per tenant when tenancy is on,
since tenants are tables (tenant/registry.py). The done-line block
follows the obs convention: serving plane OFF -> the ``freshness``
block is ``None``; armed with no replica traffic -> ``{"count": 0}``
summaries and zero counters.

A copy of ``minips_tpu/obs/freshness.py``, which imports no JAX.
"""

from __future__ import annotations

import threading

from minips_tpu_torch.obs.hist import Log2Histogram, merge_counts, \
    summarize_counts

__all__ = ["FreshnessTracker", "merge_freshness"]


class FreshnessTracker:
    """Per-table freshness state: the replica-side visibility-lag
    histogram plus owner/replica engagement counters. Lives on the
    table's serve state (serve/plane.py) so it appears and disappears
    with the plane."""

    __slots__ = ("hist", "counters", "_lock")

    def __init__(self) -> None:
        self.hist = Log2Histogram()
        self._lock = threading.Lock()
        self.counters = {
            # owner side: refresh/grant frames shipped WITH an fts stamp
            "stamped_frames": 0,
            # owner side: frames shipped without one (renew-only)
            "unstamped_frames": 0,
            # replica side: lag samples recorded (one per stamped frame
            # applied, not per row — the lag is a frame property)
            "lag_samples": 0,
            # replica side: stamped frames whose lag came out negative
            # (cross-host clock skew) — clamped to 0 but counted, so a
            # multi-host run cannot silently report rosy lags
            "clock_skew_clamped": 0,
        }

    # ------------------------------------------------------------ owner
    def note_shipped(self, stamped: bool) -> None:
        with self._lock:
            if stamped:
                self.counters["stamped_frames"] += 1
            else:
                self.counters["unstamped_frames"] += 1

    # ---------------------------------------------------------- replica
    def note_lag(self, lag_s: float) -> None:
        """Record one push-visible-at-replica lag sample (seconds)."""
        with self._lock:
            self.counters["lag_samples"] += 1
            if lag_s < 0.0:
                self.counters["clock_skew_clamped"] += 1
                lag_s = 0.0
        self.hist.record_s(lag_s)

    # ------------------------------------------------------------ reads
    def snapshot_counts(self) -> list:
        return self.hist.snapshot()

    def record(self) -> dict:
        """Done-line shape for ONE table: lag summary + counters."""
        with self._lock:
            ctr = dict(self.counters)
        return {"lag": summarize_counts(self.hist.snapshot()), **ctr}


def merge_freshness(trackers: "list[FreshnessTracker]") -> dict:
    """Fleet view over several tables' trackers: elementwise hist merge
    (fixed buckets) + counter sums — ``{"count": 0}`` lag when armed but
    idle, matching ``summarize_counts``."""
    if not trackers:
        return {"lag": {"count": 0}, "stamped_frames": 0,
                "unstamped_frames": 0, "lag_samples": 0,
                "clock_skew_clamped": 0}
    counts = merge_counts([t.snapshot_counts() for t in trackers])
    out: dict = {"lag": summarize_counts(counts)}
    for k in trackers[0].counters:
        out[k] = sum(t.counters[k] for t in trackers)
    return out
