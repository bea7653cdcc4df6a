"""Open-loop traffic driver — serving load that arrives whether or not
the fleet keeps up, measured from SCHEDULED arrival time. A copy of
``minips_tpu/apps/traffic_driver.py`` (numpy and threads only).

Every serving drill before this one was CLOSED-LOOP: N worker threads
pull, think, pull again. A closed loop self-throttles — when the fleet
slows down the workers slow down WITH it, so offered load collapses to
match capacity and the recorded "latency" is service time only. That
under-reports the tail exactly when it matters (coordinated omission:
the requests that WOULD have queued were never issued). Production
traffic does not think; it arrives on its own schedule.

This driver replays a FIXED, fully precomputed arrival schedule against
``pull_serving`` and records, per request, the time from its scheduled
arrival to completion — queueing delay included, whether the request
queued in the kernel, the bus, or this driver's own dispatcher backlog.
The schedule is deterministic given the spec (arrivals by integrating
the rate curve, user draws from one seeded zipf stream), so two runs of
the same spec offer bit-identical load.

The rate curve models a recsys day in seconds: a base rate, an optional
diurnal ramp (raised-cosine between 1x and ``ramp``x over ``period``
seconds), and an optional flash crowd (``crowd=<at>+<dur>x<mult>``: at
second ``at``, for ``dur`` seconds, multiply by ``mult``). Users are
drawn zipf(``alpha``) over a ``users``-sized population (the "million
user" knob); each request reads that user's ``batch`` pseudo-random
embedding rows (a Knuth-hash fan-out, so hot users pin hot row sets).

Spec grammar (``MINIPS_TRAFFIC``): ``""``/``"0"`` = off, ``"1"`` =
defaults, else a k=v comma list::

    rate=500,users=1000000,alpha=1.1,batch=8,conc=4,ramp=2,period=10,
    crowd=4+2x8,seed=7

``rate=0`` is ARMED-IDLE: the schedule is empty, the dispatchers start
and issue nothing — bitwise-equal to off by construction (the
TRAFFIC-IDLE drill pins it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from minips_tpu_torch.obs.hist import Log2Histogram, summarize_counts

__all__ = ["TrafficConfig", "TrafficDriver", "maybe_config"]

_KNUTH = 2654435761  # multiplicative-hash user->rows fan-out
_MAX_ARRIVALS = 2_000_000  # schedule memory guard (~16MB of float64s)


class TrafficConfig:
    """Parsed ``MINIPS_TRAFFIC`` knobs."""

    def __init__(self, *, rate: float = 200.0, users: int = 1_000_000,
                 alpha: float = 1.1, batch: int = 8, conc: int = 4,
                 ramp: float = 1.0, period: float = 10.0,
                 crowd_at: float = 0.0, crowd_for: float = 0.0,
                 crowd_x: float = 1.0, seed: int = 0):
        # inverted comparisons so NaN fails validation instead of
        # slipping through (NaN < x is False for every x)
        if not (rate >= 0):
            raise ValueError("MINIPS_TRAFFIC: rate must be >= 0 req/s "
                             "(0 = armed-idle)")
        if users < 1:
            raise ValueError("MINIPS_TRAFFIC: users must be >= 1")
        if not (alpha > 1.0):
            raise ValueError(
                "MINIPS_TRAFFIC: alpha must be > 1 (zipf exponent)")
        if batch < 1:
            raise ValueError("MINIPS_TRAFFIC: batch must be >= 1 rows")
        if conc < 1:
            raise ValueError(
                "MINIPS_TRAFFIC: conc must be >= 1 dispatchers")
        if not (ramp >= 1.0):
            raise ValueError(
                "MINIPS_TRAFFIC: ramp is a peak multiplier, must be "
                ">= 1 (1 = flat)")
        if not (period > 0):
            raise ValueError("MINIPS_TRAFFIC: period must be > 0 s")
        if not (crowd_at >= 0 and crowd_for >= 0):
            raise ValueError(
                "MINIPS_TRAFFIC: crowd at/duration must be >= 0 s")
        if not (crowd_x >= 1.0):
            raise ValueError(
                "MINIPS_TRAFFIC: crowd multiplier must be >= 1")
        self.rate = float(rate)
        self.users = int(users)
        self.alpha = float(alpha)
        self.batch = int(batch)
        self.conc = int(conc)
        self.ramp = float(ramp)
        self.period = float(period)
        self.crowd_at = float(crowd_at)
        self.crowd_for = float(crowd_for)
        self.crowd_x = float(crowd_x)
        self.seed = int(seed)

    _CASTS = {"rate": float, "users": int, "alpha": float,
              "batch": int, "conc": int, "ramp": float,
              "period": float, "seed": int}

    @classmethod
    def parse(cls, spec: str) -> "Optional[TrafficConfig]":
        """None = the layer is OFF (``""``/``"0"``); config otherwise."""
        spec = (spec or "").strip()
        if spec in ("", "0"):
            return None
        if spec in ("1", "on", "true"):
            return cls()
        kw: dict = {}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_TRAFFIC: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k == "crowd":
                kw.update(cls._parse_crowd(v.strip()))
                continue
            cast = cls._CASTS.get(k)
            if cast is None:
                raise ValueError(
                    f"MINIPS_TRAFFIC: unknown knob {k!r}")
            try:
                kw[k] = cast(v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_TRAFFIC: bad value for {k}: {v!r}") from e
        return cls(**kw)

    @staticmethod
    def _parse_crowd(v: str) -> dict:
        """``<at>+<dur>x<mult>`` -> crowd_at/crowd_for/crowd_x."""
        at_s, plus, rest = v.partition("+")
        dur_s, x, mult_s = rest.partition("x")
        if not plus or not x:
            raise ValueError(
                f"MINIPS_TRAFFIC: crowd wants <at>+<dur>x<mult> "
                f"(e.g. 4+2x8), got {v!r}")
        try:
            return {"crowd_at": float(at_s), "crowd_for": float(dur_s),
                    "crowd_x": float(mult_s)}
        except ValueError as e:
            raise ValueError(
                f"MINIPS_TRAFFIC: bad crowd value {v!r}") from e

    def signature(self) -> tuple:
        return (self.rate, self.users, self.alpha, self.batch,
                self.conc, self.ramp, self.period, self.crowd_at,
                self.crowd_for, self.crowd_x, self.seed)

    # ------------------------------------------------------- rate curve
    def rate_at(self, t: float) -> float:
        """Offered req/s at second ``t`` of the run (deterministic)."""
        r = self.rate
        if self.ramp > 1.0:
            phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / self.period))
            r *= 1.0 + (self.ramp - 1.0) * phase
        if self.crowd_for > 0 and \
                self.crowd_at <= t < self.crowd_at + self.crowd_for:
            r *= self.crowd_x
        return r


def maybe_config(spec: Optional[str] = None
                 ) -> "Optional[TrafficConfig]":
    """Explicit spec wins, else ``$MINIPS_TRAFFIC``; None when off."""
    if spec is None:
        spec = os.environ.get("MINIPS_TRAFFIC", "")
    return TrafficConfig.parse(spec)


class TrafficDriver:
    """Replays one precomputed schedule against a pull callable.

    ``pull_fn(keys)`` is ``table.pull_serving`` (or any compatible
    read); ``rows`` bounds the key space. The schedule covers
    ``duration_s`` seconds; :meth:`start` launches ``conc`` dispatcher
    threads that sleep until each arrival's scheduled time and issue it
    — a dispatcher that falls behind issues immediately, and the
    recorded latency (completion minus SCHEDULED arrival) keeps the
    queueing delay either way."""

    def __init__(self, cfg: TrafficConfig,
                 pull_fn: Callable, rows: int, duration_s: float):
        if rows < 1:
            raise ValueError("traffic driver needs rows >= 1")
        self.cfg = cfg
        self._pull = pull_fn
        self._rows = int(rows)
        self.duration_s = float(duration_s)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._next = 0
        self._threads: list = []
        self._t0: Optional[float] = None
        self.hist_sched = Log2Histogram()  # scheduled-arrival -> done
        self.hist_svc = Log2Histogram()    # issue -> done (service)
        self.counters = {"requests": 0, "rows": 0, "errors": 0,
                         "late_issues": 0}
        self._first_error: Optional[str] = None
        self._build_schedule()

    # ---------------------------------------------------------- schedule
    def _build_schedule(self) -> None:
        cfg = self.cfg
        arrivals = []
        t = 0.0
        while t < self.duration_s:
            r = cfg.rate_at(t)
            if r <= 0:
                break
            t += 1.0 / r
            if t >= self.duration_s:
                break
            arrivals.append(t)
            if len(arrivals) > _MAX_ARRIVALS:
                raise ValueError(
                    "MINIPS_TRAFFIC: schedule exceeds "
                    f"{_MAX_ARRIVALS} arrivals — lower rate/duration")
        self.arrivals = np.asarray(arrivals, dtype=np.float64)
        n = len(self.arrivals)
        rng = np.random.default_rng(cfg.seed)
        z = rng.zipf(cfg.alpha, size=n) if n else \
            np.zeros(0, dtype=np.int64)
        self._users = ((z.astype(np.int64) - 1) % cfg.users)

    def _keys_for(self, i: int) -> np.ndarray:
        u = int(self._users[i])
        j = np.arange(self.cfg.batch, dtype=np.int64)
        return (u * _KNUTH + j * 40503) % self._rows

    # -------------------------------------------------------- dispatch
    def _worker(self) -> None:
        n = len(self.arrivals)
        while not self._stop.is_set():
            with self._lock:
                i = self._next
                if i >= n:
                    return
                self._next = i + 1
            ta = self._t0 + float(self.arrivals[i])
            delay = ta - time.perf_counter()
            if delay > 0:
                if self._stop.wait(delay):
                    return
            else:
                with self._lock:
                    self.counters["late_issues"] += 1
            keys = self._keys_for(i)
            t1 = time.perf_counter()
            try:
                self._pull(keys)
            except Exception as e:  # noqa: BLE001 — driver survives
                with self._lock:
                    self.counters["errors"] += 1
                    if self._first_error is None:
                        self._first_error = repr(e)[:200]
                continue
            t2 = time.perf_counter()
            self.hist_sched.record_s(t2 - ta)
            self.hist_svc.record_s(t2 - t1)
            with self._lock:
                self.counters["requests"] += 1
                self.counters["rows"] += self.cfg.batch

    def start(self) -> None:
        self._t0 = time.perf_counter()
        for k in range(self.cfg.conc):
            th = threading.Thread(target=self._worker,
                                  name=f"traffic-{k}", daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30.0)

    # ------------------------------------------------------------ record
    def record(self) -> dict:
        with self._lock:
            ctr = dict(self.counters)
            issued = ctr["requests"] + ctr["errors"]
        return {"open_loop": 1, "rate": self.cfg.rate,
                "users": self.cfg.users, "alpha": self.cfg.alpha,
                "batch": self.cfg.batch, "conc": self.cfg.conc,
                "ramp": self.cfg.ramp, "crowd_x": self.cfg.crowd_x,
                "seed": self.cfg.seed,
                "scheduled": int(len(self.arrivals)),
                "unissued": int(len(self.arrivals)) - issued,
                # the honest number: scheduled arrival -> completion
                "sched_ms": summarize_counts(self.hist_sched.snapshot()),
                # service time alone, for the closed-vs-open comparison
                "svc_ms": summarize_counts(self.hist_svc.snapshot()),
                **ctr,
                "first_error": self._first_error}
