"""Windowed metrics — per-interval deltas over the always-on counters
and log2 histograms, so "how is the fleet doing NOW" stops reading
"how has it done since boot".

Every latency histogram in the stack (obs/hist.py) and every load
counter (serve sheds, reliable retransmits, drops) is CUMULATIVE: cheap,
merge-able, and exactly wrong for control decisions. The autoscaler's
``up_p99_ms`` arming read the cumulative pull-latency hist, so a storm's
tail samples stayed in the p99 forever — the signal could arm but
provably never disarm (ROADMAP item 3 carry-forward (b)). This module is
the windowed layer over those same primitives:

- **Hist windows.** The log2 buckets are FIXED, so a histogram's delta
  over an interval is an elementwise subtraction, and a window quantile
  is ``summarize_counts`` over the elementwise SUM of the last K deltas
  — the identical trick the per-rank merge uses, pointed at time instead
  of space. No second recording path: the hot paths keep feeding the one
  cumulative histogram; :meth:`WindowedMetrics.roll` snapshots it once
  per interval (the trainer's clock boundary) and stores the delta in a
  bounded ring.
- **Counter windows.** Same shape, scalar: per-roll deltas of cumulative
  counters, summed over the window and divided by the window's wall span
  for a rate. A counter that went BACKWARD (layer restarted) re-baselines
  instead of booking a negative burst.
- **Gauges.** Values that are already instantaneous (oldest outstanding
  reliable gap age): the ring stores samples, the window reports
  last/max.

The layer is ALWAYS ON (``MINIPS_OBS=0`` disables it — that arm exists
for the OBS-TAX honesty measurement, not for production): the roll is
one snapshot pass per clock boundary, far off the per-frame hot path.
Off-vs-idle follows the obs convention — an OFF layer reports ``None``
in the done line, an armed-but-idle window reports ``{"count": 0}``.

Spec grammar (``MINIPS_OBS``): ``""``/``"1"`` = defaults on, ``"0"`` =
off, else ``window=<rolls>,ring=<rolls>`` (window = the default K
quantiles/rates read; ring = how many deltas are retained, the largest
readable window).

A copy of ``minips_tpu/obs/window.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from minips_tpu_torch.obs.hist import N_BUCKETS, quantile_us, summarize_counts

__all__ = ["ObsWindowConfig", "WindowedMetrics", "maybe_build"]

_DEF_WINDOW = 8
_DEF_RING = 32


class ObsWindowConfig:
    """Parsed ``MINIPS_OBS`` knobs (k=v comma list; ``"1"``/empty =
    every default)."""

    def __init__(self, *, window: int = _DEF_WINDOW,
                 ring: int = _DEF_RING):
        if window < 1:
            raise ValueError("MINIPS_OBS: window must be >= 1 roll")
        if ring < window:
            raise ValueError(
                f"MINIPS_OBS: ring {ring} must hold at least one "
                f"window ({window} rolls) — a window the ring cannot "
                "cover would silently report a shorter one")
        self.window = int(window)
        self.ring = int(ring)

    @classmethod
    def parse(cls, spec: str) -> "Optional[ObsWindowConfig]":
        """None = the layer is OFF (``"0"``); a config otherwise."""
        spec = (spec or "").strip()
        if spec == "0":
            return None
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_OBS: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in ("window", "ring"):
                raise ValueError(f"MINIPS_OBS: unknown knob {k!r}")
            try:
                kw[k] = int(v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_OBS: bad value for {k}: {v!r}") from e
        return cls(**kw)


def maybe_build(spec: Optional[str] = None
                ) -> "Optional[WindowedMetrics]":
    """Build from an explicit spec or ``$MINIPS_OBS`` (explicit wins,
    the shared knob convention); None when the layer is disabled."""
    if spec is None:
        spec = os.environ.get("MINIPS_OBS", "")
    cfg = ObsWindowConfig.parse(spec)
    if cfg is None:
        return None
    return WindowedMetrics(window=cfg.window, ring=cfg.ring)


class WindowedMetrics:
    """Ring-buffered per-roll deltas over registered cumulative signals.

    One instance per trainer (or mesh plane); :meth:`roll` is called
    from the push-driving thread at each clock boundary, reads may come
    from any thread (the autoscaler's decision step, the done line, a
    flight-recorder dump) — one lock serializes, and every critical
    section is a bounded copy (K deltas of 40 ints), never a wire or
    file touch."""

    def __init__(self, *, window: int = _DEF_WINDOW,
                 ring: int = _DEF_RING,
                 clock: Callable[[], float] = time.monotonic):
        cfg = ObsWindowConfig(window=window, ring=ring)  # re-validate
        self.window = cfg.window
        self.ring = cfg.ring
        self._clock = clock
        self._lock = threading.Lock()
        self._hists: dict[str, Callable[[], list]] = {}
        self._hist_last: dict[str, list[int]] = {}
        self._hist_ring: dict[str, deque] = {}
        self._counters: dict[str, Callable[[], float]] = {}
        self._ctr_last: dict[str, float] = {}
        self._ctr_ring: dict[str, deque] = {}
        self._gauges: dict[str, Callable[[], float]] = {}
        self._gauge_ring: dict[str, deque] = {}
        # roll timestamps, one longer than the ring so a full-ring
        # window still knows when its FIRST interval began (rates need
        # the span, not just the deltas)
        self._t_ring: deque = deque([clock()], maxlen=cfg.ring + 1)
        self.rolls = 0

    # -------------------------------------------------------- registration
    def register_hist(self, name: str,
                      fn: Callable[[], list]) -> None:
        """``fn`` returns the CURRENT cumulative bucket counts (any
        monotone per-bucket source: one Log2Histogram's counts, or an
        elementwise merge across tables — sums of monotone counts are
        monotone). Primed at registration: history before this call
        never enters a window."""
        with self._lock:
            cur = list(fn())
            if len(cur) != N_BUCKETS:
                raise ValueError(
                    f"hist {name!r}: expected {N_BUCKETS} buckets, "
                    f"got {len(cur)}")
            self._hists[name] = fn
            self._hist_last[name] = cur
            self._hist_ring[name] = deque(maxlen=self.ring)

    def register_counter(self, name: str,
                         fn: Callable[[], float]) -> None:
        with self._lock:
            self._counters[name] = fn
            self._ctr_last[name] = float(fn())
            self._ctr_ring[name] = deque(maxlen=self.ring)

    def register_gauge(self, name: str,
                       fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn
            self._gauge_ring[name] = deque(maxlen=self.ring)

    # --------------------------------------------------------------- roll
    def roll(self) -> None:
        """Close the current interval: snapshot every registered signal,
        ring-buffer the delta since the previous roll. A signal whose
        cumulative value stepped BACKWARD (restarted layer) re-baselines
        with a zero delta rather than booking a negative one.

        The registered fns are called OUTSIDE the window lock: they
        acquire foreign locks (CommTimers, the reliable channel, serve
        counters), and holding this lock across those acquisitions
        would let a reader blocked on it (a flight dump's snapshot
        hook, fired from a poison path that may itself hold a table
        lock a reliable-dispatched handler wants) close a cross-thread
        lock cycle. Rolls come from ONE thread (the push-driving
        clock boundary), so the unlocked read phase never races
        another roll; only the ring/baseline mutation needs the lock
        readers share."""
        now = self._clock()
        with self._lock:
            hists = list(self._hists.items())
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
        hist_cur = [(name, list(fn())) for name, fn in hists]
        ctr_cur = [(name, float(fn())) for name, fn in counters]
        gauge_cur = [(name, float(fn())) for name, fn in gauges]
        with self._lock:
            self._t_ring.append(now)
            self.rolls += 1
            for name, cur in hist_cur:
                last = self._hist_last[name]
                delta = [max(c - p, 0) for c, p in zip(cur, last)]
                self._hist_ring[name].append(delta)
                self._hist_last[name] = cur
            for name, cur in ctr_cur:
                delta = cur - self._ctr_last[name]
                self._ctr_ring[name].append(max(delta, 0.0))
                self._ctr_last[name] = cur
            for name, cur in gauge_cur:
                self._gauge_ring[name].append(cur)

    # -------------------------------------------------------------- reads
    def _k(self, window: Optional[int]) -> int:
        k = self.window if window is None else int(window)
        if k < 1:
            raise ValueError("window must be >= 1 roll")
        return min(k, self.ring)

    def window_counts(self, name: str,
                      window: Optional[int] = None
                      ) -> Optional[list[int]]:
        """Elementwise sum of the last ``window`` hist deltas — sound
        because the buckets are fixed (the per-rank-merge argument,
        applied over time). None for an unregistered name; all-zero for
        an idle (or not-yet-rolled) window."""
        k = self._k(window)
        with self._lock:
            ring = self._hist_ring.get(name)
            if ring is None:
                return None
            out = [0] * N_BUCKETS
            for delta in list(ring)[-k:]:
                for i, c in enumerate(delta):
                    out[i] += c
        return out

    def summarize(self, name: str,
                  window: Optional[int] = None) -> Optional[dict]:
        """``summarize_counts`` over the window sum: the done-line shape
        ({"count": 0} when the window saw no samples)."""
        counts = self.window_counts(name, window)
        return None if counts is None else summarize_counts(counts)

    def quantile_ms(self, name: str, q: float,
                    window: Optional[int] = None) -> Optional[float]:
        """The windowed quantile in milliseconds — the autoscaler's
        arming signal. None when the window is empty (idle ≠ slow) or
        the name is unregistered."""
        counts = self.window_counts(name, window)
        if counts is None:
            return None
        v = quantile_us(counts, q)
        return None if v is None else round(v / 1e3, 4)

    def delta_sum(self, name: str,
                  window: Optional[int] = None) -> Optional[float]:
        """Counter events inside the window (sum of the last K deltas)."""
        k = self._k(window)
        with self._lock:
            ring = self._ctr_ring.get(name)
            if ring is None:
                return None
            return float(sum(list(ring)[-k:]))

    def rate(self, name: str,
             window: Optional[int] = None) -> Optional[float]:
        """Counter events per SECOND over the window's wall span; None
        before the first roll or for an unregistered name."""
        k = self._k(window)
        with self._lock:
            ring = self._ctr_ring.get(name)
            if ring is None:
                return None
            deltas = list(ring)[-k:]
            if not deltas:
                return None
            ts = list(self._t_ring)
            # ts has one more entry than rolls retained: ts[-1] closed
            # the newest interval, ts[-(len(deltas)+1)] opened the
            # oldest one in this window
            span = ts[-1] - ts[-(len(deltas) + 1)]
            if span <= 0:
                return None
            return sum(deltas) / span

    def gauge(self, name: str, *, agg: str = "last",
              window: Optional[int] = None) -> Optional[float]:
        k = self._k(window)
        with self._lock:
            ring = self._gauge_ring.get(name)
            if ring is None or not ring:
                return None
            vals = list(ring)[-k:]
        return max(vals) if agg == "max" else vals[-1]

    # -------------------------------------------------------------- record
    def record(self, window: Optional[int] = None) -> dict:
        """The done-line ``window`` block: per-hist window summaries
        ({"count": 0} idle), per-counter window rates, gauge last/max —
        all over the DEFAULT window unless asked otherwise. The trainer
        reports None instead of calling this when the layer is off."""
        k = self._k(window)
        out: dict = {"rolls": self.rolls, "window": k,
                     "ring": self.ring, "hist": {}, "rate_per_s": {},
                     "events": {}, "gauge": {}}
        for name in list(self._hists):
            out["hist"][name] = self.summarize(name, k)
        for name in list(self._counters):
            r = self.rate(name, k)
            d = self.delta_sum(name, k)
            out["rate_per_s"][name] = (round(r, 3)
                                       if r is not None else None)
            out["events"][name] = int(d) if d is not None else None
        for name in list(self._gauges):
            g = self.gauge(name, agg="max", window=k)
            out["gauge"][name] = (round(g, 4) if g is not None
                                  else None)
        return out
