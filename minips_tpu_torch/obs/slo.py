"""Multi-window SLO burn-rate accounting over the windowed quantiles —
the layer that turns "p99 looks high" into a signal the fleet can act
on, per tenant, without paging on one bad interval.

The classic burn-rate alert (SRE workbook shape): pick an objective
("99% of reads under 20ms"), measure the fraction of samples violating
it, and divide by the error budget ``1 - q``. A burn of 1.0 means the
budget is being spent exactly at the sustainable rate; 10x means it is
gone in a tenth of the window. One window cannot be both fast and
credible, so the standard fix is TWO: a metric is BURNING only when the
fast window (reacts in seconds) AND the slow window (filters blips)
both exceed the threshold. Both reads come from the windowed
layer (obs/window.py) over the same log2 histograms everything else
reports — no second recording path, and the log2 quantization is
explicit in the math (the straddling bucket contributes linearly).

Three objectives, each optional (target 0 = not monitored), each keyed
by tenant (tenants are tables — tenant/registry.py; with tenancy off
there is one implicit ``*`` tenant over the fleet signals):

- ``fresh_ms`` — push-visible-at-replica lag (obs/freshness.py)
- ``read_ms``  — serving read latency (``pull_latency`` hists)
- ``shed_rate`` — admission sheds per second (rate, not quantile: the
  burn is observed rate / target rate)

A rising burn edge emits a flight-recorder ``slo_burn`` CHECKPOINT
(obs/flight.py — event + dump, zero pre-arming, so the violation IS the
post-mortem box); a falling edge emits a plain ``slo_clear`` event. The
burning set feeds two consumers: the serving plane's promotion budget
(``replica_boost`` — a burning tenant's tables get ``boost`` extra
replicas while burning, the "replica budgets ride demand" half of
ROADMAP item 4) and the autoscaler's arming pressure
(balance/autoscaler.py ``_slo_pressure``, the rank half).

Spec grammar (``MINIPS_SLO``): ``""``/``"0"`` = off, ``"1"`` = armed
with defaults (no targets — armed-idle), else a k=v comma list::

    fresh_ms=50,read_ms=20,shed_rate=5,fast=2,slow=8,burn=1.0,q=0.99,
    boost=1,pressure=1

Done-line convention: layer OFF -> ``slo`` block is ``None``;
armed with no targets or no traffic -> zero counters, empty burning set.

A copy of ``minips_tpu/obs/slo.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from minips_tpu_torch.obs import flight as _flight

__all__ = ["SloConfig", "SloTracker", "maybe_config"]

_DEF_FAST = 2
_DEF_SLOW = 8


def _bounds_us(i: int) -> tuple[float, float]:
    """[lo, hi) of log2 bucket ``i`` in microseconds (obs/hist.py)."""
    if i == 0:
        return 0.0, 1.0
    return float(2 ** (i - 1)), float(2 ** i)


def frac_over_target(counts: list, target_us: float) -> float:
    """Fraction of samples above ``target_us`` given log2 bucket counts.
    Buckets fully above the target count whole; the straddling bucket
    contributes its linear fraction above it (same interpolation the
    quantiles use — honest to the bucket resolution, no better)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    over = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        lo, hi = _bounds_us(i)
        if lo >= target_us:
            over += c
        elif hi > target_us:
            over += c * (hi - target_us) / (hi - lo)
    return over / total


class SloConfig:
    """Parsed ``MINIPS_SLO`` knobs."""

    def __init__(self, *, fresh_ms: float = 0.0, read_ms: float = 0.0,
                 shed_rate: float = 0.0, fast: int = _DEF_FAST,
                 slow: int = _DEF_SLOW, burn: float = 1.0,
                 q: float = 0.99, boost: int = 1, pressure: int = 1):
        # inverted comparisons so NaN fails validation instead of
        # slipping through (NaN < x is False for every x)
        if not (fresh_ms >= 0 and read_ms >= 0 and shed_rate >= 0):
            raise ValueError("MINIPS_SLO: targets must be >= 0 "
                             "(0 = not monitored)")
        if fast < 1:
            raise ValueError("MINIPS_SLO: fast window must be >= 1 roll")
        if slow < fast:
            raise ValueError(
                f"MINIPS_SLO: slow window ({slow}) must be >= fast "
                f"({fast}) — a slow window shorter than the fast one "
                "inverts the blip filter")
        if not (burn > 0):
            raise ValueError("MINIPS_SLO: burn threshold must be > 0")
        if not (0.0 < q < 1.0):
            raise ValueError("MINIPS_SLO: q must be in (0, 1)")
        if boost < 0:
            raise ValueError("MINIPS_SLO: boost must be >= 0 replicas")
        if pressure not in (0, 1):
            raise ValueError("MINIPS_SLO: pressure must be 0 or 1")
        self.fresh_ms = float(fresh_ms)
        self.read_ms = float(read_ms)
        self.shed_rate = float(shed_rate)
        self.fast = int(fast)
        self.slow = int(slow)
        self.burn = float(burn)
        self.q = float(q)
        self.boost = int(boost)
        self.pressure = int(pressure)

    _CASTS = {"fresh_ms": float, "read_ms": float, "shed_rate": float,
              "fast": int, "slow": int, "burn": float, "q": float,
              "boost": int, "pressure": int}

    @classmethod
    def parse(cls, spec: str) -> "Optional[SloConfig]":
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
                    f"MINIPS_SLO: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            cast = cls._CASTS.get(k)
            if cast is None:
                raise ValueError(f"MINIPS_SLO: unknown knob {k!r}")
            try:
                kw[k] = cast(v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_SLO: bad value for {k}: {v!r}") from e
        return cls(**kw)

    def signature(self) -> tuple:
        return (self.fresh_ms, self.read_ms, self.shed_rate, self.fast,
                self.slow, self.burn, self.q, self.boost, self.pressure)


def maybe_config(spec: Optional[str] = None) -> "Optional[SloConfig]":
    """Explicit spec wins, else ``$MINIPS_SLO`` (the shared knob
    convention); None when the layer is off."""
    if spec is None:
        spec = os.environ.get("MINIPS_SLO", "")
    return SloConfig.parse(spec)


# (metric key, config target attr, windowed signal prefix, kind)
_METRICS = (("read", "read_ms", "pull_latency", "hist"),
            ("fresh", "fresh_ms", "freshness", "hist"),
            ("shed", "shed_rate", "shed", "counter"))


class SloTracker:
    """Evaluates the burn state once per windowed roll and serves the
    burning set to the promotion budget and the autoscaler.

    ``tenants`` is the list of tenant/table names to key by (empty ->
    one implicit ``"*"`` tenant over the fleet signals). Per-tenant
    signals (``pull_latency:{name}`` etc., registered by the trainer
    when tenancy is on) are preferred; an unregistered per-tenant name
    falls back to the fleet signal so an SLO on an untagged run still
    evaluates."""

    def __init__(self, cfg: SloConfig, ow, tenants: "list[str]"):
        if ow is None:
            raise ValueError(
                "MINIPS_SLO reads the windowed quantiles — it cannot "
                "run with MINIPS_OBS=0")
        self.cfg = cfg
        self._ow = ow
        self.tenants = list(tenants) or ["*"]
        self._lock = threading.Lock()
        self._state: dict = {}       # (tenant, metric) -> burning bool
        self._last: dict = {}        # (tenant, metric) -> (fast, slow)
        self._budget: dict = {t: 0 for t in self.tenants}
        self.counters = {"checks": 0, "burns": 0, "clears": 0,
                         "boost_ticks": 0}

    # ------------------------------------------------------------- eval
    def _signal(self, prefix: str, tenant: str) -> str:
        if tenant != "*":
            return f"{prefix}:{tenant}"
        return prefix

    def _burn_pair(self, tenant: str, target: float, prefix: str,
                   kind: str) -> "Optional[tuple[float, float]]":
        """(fast_burn, slow_burn) for one (tenant, metric); None when
        the signal is unregistered in the windowed layer."""
        name = self._signal(prefix, tenant)
        if kind == "hist":
            tgt_us = target * 1e3
            budget = max(1.0 - self.cfg.q, 1e-9)
            pair = []
            for k in (self.cfg.fast, self.cfg.slow):
                counts = self._ow.window_counts(name, k)
                if counts is None and tenant != "*":
                    counts = self._ow.window_counts(prefix, k)
                if counts is None:
                    return None
                pair.append(frac_over_target(counts, tgt_us) / budget)
            return pair[0], pair[1]
        # counter: burn = observed events/s over the window / target
        pair = []
        for k in (self.cfg.fast, self.cfg.slow):
            r = self._ow.rate(name, k)
            if r is None and tenant != "*":
                r = self._ow.rate(prefix, k)
            if r is None:
                return None
            pair.append(r / target)
        return pair[0], pair[1]

    def on_roll(self) -> None:
        """Re-evaluate every (tenant, metric) pair; called from the
        tick thread right after ``WindowedMetrics.roll()`` so the fast
        window always includes the interval that just closed."""
        cfg = self.cfg
        edges = []
        with self._lock:
            self.counters["checks"] += 1
            for tenant in self.tenants:
                for metric, attr, prefix, kind in _METRICS:
                    target = getattr(cfg, attr)
                    if target <= 0:
                        continue
                    pair = self._burn_pair(tenant, target, prefix, kind)
                    if pair is None:
                        continue
                    fast_b, slow_b = pair
                    key = (tenant, metric)
                    self._last[key] = (fast_b, slow_b)
                    now_burning = (fast_b >= cfg.burn
                                   and slow_b >= cfg.burn)
                    was = self._state.get(key, False)
                    if now_burning and not was:
                        self.counters["burns"] += 1
                        edges.append(("burn", tenant, metric,
                                      fast_b, slow_b, target))
                    elif was and not now_burning:
                        self.counters["clears"] += 1
                        edges.append(("clear", tenant, metric,
                                      fast_b, slow_b, target))
                    self._state[key] = now_burning
        # flight I/O outside the lock: a checkpoint dumps a file
        for edge, tenant, metric, fast_b, slow_b, target in edges:
            args = {"tenant": tenant, "metric": metric,
                    "fast_burn": round(fast_b, 3),
                    "slow_burn": round(slow_b, 3), "target": target}
            if edge == "burn":
                _flight.checkpoint("slo_burn", args)
            else:
                _flight.record("slo_clear", args)

    # -------------------------------------------------------- consumers
    def burning(self, tenant: str) -> bool:
        with self._lock:
            return any(b for (t, _m), b in self._state.items()
                       if b and t in (tenant, "*"))

    def burning_tenants(self) -> "list[str]":
        with self._lock:
            return sorted({t for (t, _m), b in self._state.items()
                           if b})

    def replica_boost(self, tenant: str) -> int:
        """Extra replicas the promotion budget grants this tenant's
        tables while it burns (serve/plane.py ``_promote_hot``)."""
        if self.cfg.boost <= 0 or not self.burning(tenant):
            return 0
        with self._lock:
            self.counters["boost_ticks"] += 1
        return self.cfg.boost

    def note_budget(self, tenant: str, nrep: int) -> None:
        """Promotion budget actually applied — the artifact's proof
        that the replica budget flexed (max over the run)."""
        with self._lock:
            if nrep > self._budget.get(tenant, 0):
                self._budget[tenant] = int(nrep)

    def pressure_quanta(self) -> int:
        """Burning-tenant count for the autoscaler's arming pressure
        (0 when the ``pressure`` knob is off)."""
        if not self.cfg.pressure:
            return 0
        return len(self.burning_tenants())

    # ------------------------------------------------------------ record
    def record(self) -> dict:
        cfg = self.cfg
        with self._lock:
            per_tenant: dict = {}
            for tenant in self.tenants:
                burning = sorted(m for (t, m), b in self._state.items()
                                 if b and t == tenant)
                tn: dict = {"burning": burning,
                            "max_budget": self._budget.get(tenant, 0)}
                for metric, attr, _p, _k in _METRICS:
                    pair = self._last.get((tenant, metric))
                    if pair is not None:
                        tn[f"{metric}_burn"] = [round(pair[0], 3),
                                                round(pair[1], 3)]
                per_tenant[tenant] = tn
            return {"fast": cfg.fast, "slow": cfg.slow,
                    "burn": cfg.burn, "q": cfg.q, "boost": cfg.boost,
                    "pressure": cfg.pressure,
                    "targets": {"fresh_ms": cfg.fresh_ms,
                                "read_ms": cfg.read_ms,
                                "shed_rate": cfg.shed_rate},
                    **dict(self.counters),
                    "burning": sorted(
                        f"{t}/{m}" for (t, m), b in self._state.items()
                        if b),
                    "tenants": per_tenant}
