"""Fixed-bucket log2 latency histograms — the tail the means were hiding.

``CommTimers`` (utils/timing.py) has carried mean-only per-leg latencies
since the overlapped-pipeline PR, and every sweep since has fought tail
effects the means cannot show (bursty same-stamp cache misses, park/wake
latency, retransmit delays). This module is the cheap fix: a histogram
whose bucket index is ``ceil(log2(us))`` — one ``bit_length`` and one
list increment per sample, no allocation, bounded memory (one int per
bucket) — summarized as p50/p95/p99 next to the existing means in
``CommTimers.summary()`` and the ``wire_record`` done lines.

Buckets are FIXED (not adaptive): bucket 0 holds ``[0, 1)`` us, bucket
``i`` holds ``[2^(i-1), 2^i)`` us, 40 buckets reach ~9 minutes — so two
ranks' histograms merge by elementwise addition with no rebinning, which
is what lets the bench sum per-rank counts into fleet quantiles.
Quantiles interpolate linearly inside the winning bucket: exact enough
to separate a 2x tail regression, which is the job.

A copy of ``minips_tpu/obs/hist.py``, which imports no JAX.
"""

from __future__ import annotations

import threading

__all__ = ["Log2Histogram", "summarize_counts", "merge_counts",
           "slo_check"]

N_BUCKETS = 40  # 2^39 us ~ 9.1 min: past every deadline in the repo


class Log2Histogram:
    """Thread-safe fixed-bucket log2 histogram of microsecond latencies.

    The lock is per-sample but the critical section is two integer ops;
    callers that already serialize (``CommTimers`` holds its own lock)
    may use :meth:`record_us_locked` to skip it."""

    __slots__ = ("counts", "_lock")

    def __init__(self, counts: list[int] | None = None):
        self.counts = list(counts) if counts is not None \
            else [0] * N_BUCKETS
        if len(self.counts) != N_BUCKETS:
            raise ValueError(f"expected {N_BUCKETS} buckets, "
                             f"got {len(self.counts)}")
        self._lock = threading.Lock()

    @staticmethod
    def bucket_of(us: float) -> int:
        """``floor(log2(us)) + 1`` clamped to the table: [0,1)us -> 0,
        [1,2) -> 1, [2,4) -> 2, ... — one ``bit_length`` call."""
        if us < 1.0:
            return 0
        return min(int(us).bit_length(), N_BUCKETS - 1)

    def record_us(self, us: float) -> None:
        with self._lock:
            self.counts[self.bucket_of(us)] += 1

    def record_us_locked(self, us: float) -> None:
        """Record without taking the internal lock — for callers whose
        own lock already serializes every touch of this histogram."""
        self.counts[self.bucket_of(us)] += 1

    def record_s(self, seconds: float) -> None:
        self.record_us(max(seconds, 0.0) * 1e6)

    def snapshot(self) -> list[int]:
        with self._lock:
            return list(self.counts)

    def summary(self) -> dict:
        return summarize_counts(self.snapshot())


def _bucket_bounds(i: int) -> tuple[float, float]:
    """[lo, hi) in microseconds of bucket ``i``."""
    if i == 0:
        return 0.0, 1.0
    return float(2 ** (i - 1)), float(2 ** i)


def quantile_us(counts: list[int], q: float) -> float | None:
    """The ``q``-quantile (0..1) in microseconds, linearly interpolated
    inside the winning bucket; None on an empty histogram."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= target:
            lo, hi = _bucket_bounds(i)
            frac = (target - seen) / c
            return lo + frac * (hi - lo)
        seen += c
    lo, hi = _bucket_bounds(len(counts) - 1)
    return hi


def summarize_counts(counts: list[int]) -> dict:
    """The done-line shape of one histogram: ``{"count": 0}`` when idle
    (armed but no samples — distinct from the ``None`` an OFF layer
    reports), quantiles in milliseconds when populated."""
    total = sum(counts)
    if total == 0:
        return {"count": 0}
    out = {"count": total}
    for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
        v = quantile_us(counts, q)
        out[name] = round(v / 1e3, 4) if v is not None else None
    # max is the bucket ceiling of the last populated bucket — honest
    # about the resolution (we never stored the raw value)
    last = max(i for i, c in enumerate(counts) if c)
    out["max_le_ms"] = round(_bucket_bounds(last)[1] / 1e3, 4)
    return out


def slo_check(counts: list[int], target_ms: float,
              q: float = 0.99) -> dict:
    """SLO latency gate over one histogram (the serving plane's
    done-line ``serve.replica.slo`` block and the bench SERVE-SLO
    tripwire's runtime twin): the observed ``q``-quantile against a
    millisecond target. An EMPTY histogram is not a violation (idle is
    not slow) — ``violated`` is None there, mirroring the count-0
    convention above."""
    total = sum(counts)
    if total == 0:
        return {"count": 0, "target_ms": float(target_ms),
                "q": q, "observed_ms": None, "violated": None}
    v = quantile_us(counts, q)
    observed = round(v / 1e3, 4) if v is not None else None
    return {"count": total, "target_ms": float(target_ms), "q": q,
            "observed_ms": observed,
            "violated": bool(observed is not None
                             and observed > target_ms)}


def merge_counts(many: "list[list[int]]") -> list[int]:
    """Elementwise sum — sound because the buckets are fixed."""
    out = [0] * N_BUCKETS
    for counts in many:
        for i, c in enumerate(counts):
            out[i] += c
    return out
