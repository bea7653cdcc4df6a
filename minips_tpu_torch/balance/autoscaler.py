"""Closed-loop autoscaler — half two of the production control plane
(ROADMAP item 3: elasticity driven by DEMAND, not by drill scripts).

The membership plane gives the job join/drain/death transitions; the
drill apps trigger them by step number (``--join-at``, ``--drain-at``).
This module closes the loop from LOAD instead: a decision step on the
lease holder (balance/control_plane.py — it survives coordinator
failover because every rank runs one and only the holder's acts) watches
signals the system already exports and drives the same ``mbJ`` admit /
``mbDr`` drain machinery:

- **serve-plane shed/backpressure counters** — each owner's
  ``TableServeState.load_signal()`` (cumulative, so a missed report
  loses nothing) rides the ``rbH`` heat report every clock; the
  autoscaler diffs per (table, rank) to get a fleet sheds-per-tick rate.
  This is the primary storm signal: admission refusing load is the
  system itself saying it is over capacity.
- **SERVE-SLO p99** — the always-on pull-latency histograms, summarized
  into the same report (``up_p99_ms`` arms it). Since the windowed
  metrics layer (obs/window.py) the reported value is the WINDOWED
  quantile over the last ``MINIPS_OBS window=`` clock boundaries, not
  the cumulative-since-boot hist: a storm that ends leaves the signal
  within one window, so the loop can DISARM — the cumulative quantile
  could arm but provably never forget a storm (ROADMAP item 3
  carry-forward (b), closed). Ranks running ``MINIPS_OBS=0`` fall back
  to the cumulative value, honestly reintroducing that limit.
- **per-owner heat imbalance** — max/mean of the reports' ``total``
  heat (``imb`` arms it), the same observable the rebalancer's
  hysteresis reads.

Decisions, with hysteresis and a cool-down so shed BURSTS don't flap
membership: ``up_after`` consecutive hot ticks admit ONE standby (the
membership queue holds announced standbys — ``Membership.hold_joins`` —
until the autoscaler grants a credit; placement is the heat-aware
``plan_admission``, so the joiner absorbs the hot range at admission);
``down_after`` consecutive calm ticks drain ONE autoscaler-grown rank
(highest-ranked member of ``live − initial_live`` — the floor is the
operator's launch config, so the loop can never shrink the fleet below
what it was handed, and never drains the lease holder). Every action
opens a ``cool``-tick window in which signals are recorded but not
acted on.

Armed by ``MINIPS_AUTOSCALE`` (requires ``MINIPS_ELASTIC``; off by
default — armed-but-idle is pinned bitwise-equal to off by the lockstep
drill: the loop only ever reads reports until a threshold trips)::

    MINIPS_AUTOSCALE="1"                       # every default
    MINIPS_AUTOSCALE="up_shed=8,up_after=2,down_after=6,cool=4"

Knob table: docs/api.md "Closed-loop autoscaler".

A copy of ``minips_tpu/balance/autoscaler.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
from typing import Optional

from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc

__all__ = ["AutoscaleConfig", "Autoscaler"]


class AutoscaleConfig:
    """Parsed ``MINIPS_AUTOSCALE`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default)."""

    def __init__(self, *, up_shed: float = 1.0, up_p99_ms: float = 0.0,
                 imb: float = 0.0, up_after: int = 2,
                 down_after: int = 6, cool: int = 4, max_live: int = 0):
        if up_shed <= 0:
            raise ValueError("up_shed must be > 0 sheds/tick (the shed "
                             "signal is always armed)")
        if up_p99_ms < 0 or imb < 0:
            raise ValueError("up_p99_ms and imb must be >= 0 (0 = that "
                             "signal off)")
        if imb and imb < 1.0:
            raise ValueError("imb is a max/mean ratio: >= 1.0, or 0 "
                             "for off")
        if up_after < 1 or down_after < 1:
            raise ValueError("up_after/down_after must be >= 1 tick "
                             "(hysteresis needs a streak)")
        if cool < 0:
            raise ValueError("cool must be >= 0 ticks")
        if max_live < 0:
            raise ValueError("max_live must be >= 0 (0 = no cap)")
        self.up_shed = float(up_shed)      # fleet sheds/tick arming rate
        self.up_p99_ms = float(up_p99_ms)  # pull p99 arming bound (0=off)
        self.imb = float(imb)              # heat max/mean bound (0=off)
        self.up_after = int(up_after)      # hot ticks before an admit
        self.down_after = int(down_after)  # calm ticks before a drain
        self.cool = int(cool)              # post-action quiet window
        self.max_live = int(max_live)      # live-rank ceiling (0=none)

    @classmethod
    def parse(cls, spec: str) -> "AutoscaleConfig":
        spec = (spec or "").strip()
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"up_shed": float, "up_p99_ms": float, "imb": float,
                 "up_after": int, "down_after": int, "cool": int,
                 "max_live": int}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_AUTOSCALE: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_AUTOSCALE: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_AUTOSCALE: bad value for {k}: {v!r}") from e
        return cls(**kw)


class Autoscaler:
    """The decision loop. One instance per rank (construction arms
    ``Membership.hold_joins`` fleet-wide so announced standbys queue for
    a credit instead of auto-admitting); only the CURRENT lease holder's
    ``on_tick`` decides, so the loop survives coordinator failover with
    at most one boundary of lost streak state — the signals themselves
    re-gossip every tick."""

    def __init__(self, trainer, membership, cfg: AutoscaleConfig):
        if trainer.rebalancer is None:
            raise RuntimeError(
                "the autoscaler reads load signals off the rbH report "
                "wire — membership arms the rebalancer machinery first")
        self.trainer = trainer
        self.mb = membership
        self.cfg = cfg
        self.rb = trainer.rebalancer
        self.rank = int(trainer.bus.my_id)
        membership.hold_joins = True
        # the drain floor AND the grown-set baseline: launch-config live
        # ranks are the operator's, only autoscaler growth is reclaimed
        self._initial_live = frozenset(membership.live_view())
        self._lock = threading.Lock()
        self._prev: dict[tuple, float] = {}  # (table, rank) -> last shed
        self._hot = 0
        self._calm = 0
        self._cooldown = 0
        self._streak_rates: list[float] = []  # shed/tick, hot streak
        self._calm_rates: list[float] = []    # shed/tick, calm streak
        # the closed loop's evidence pair: the shed rate that FORCED the
        # first admit (mean over its hot streak) vs the rate the loop
        # saw before its first drain (mean over the calm streak that
        # triggered it) — pre >= up_shed > post by construction when
        # both actions fired, so recorded values prove the loop acted
        # on pressure rising AND on pressure falling, not on a timer
        self.shed_rate_pre: Optional[float] = None
        self.shed_rate_post: Optional[float] = None
        self.p99_hot_ms = 0.0
        self.p99_last_ms: Optional[float] = None
        self.counters = {"admits": 0, "drains": 0, "hot_ticks": 0,
                         "calm_ticks": 0, "sheds_seen": 0}
        # tenancy (tenant/registry.py): the per-tenant split of the
        # summed signals — last tick's {table: {shed_d, p99, heat}}
        # plus the current CULPRIT (max shed rate, p99 tie-break), so
        # an elastic decision names the tenant that caused it instead
        # of "the fleet" (the summed-signals limit). Empty/None
        # with tenancy off — the decision thresholds themselves stay
        # fleet-wide either way: capacity is still shared.
        self._by_tenant: dict[str, dict] = {}
        self._culprit: Optional[str] = None

    # ------------------------------------------------------------ signals
    def _signals(self) -> tuple[float, Optional[float], float]:
        """(fleet sheds this tick, max p99 ms, heat max/mean ratio) from
        the coordinator's stored heat reports. Shed counters arrive
        cumulative (a lost report tick never loses a shed); the diff
        against the previous observation is the per-tick rate. A rank
        whose counter went BACKWARD restarted — reset its baseline."""
        shed_d = 0.0
        p99s: list[float] = []
        totals: list[float] = []
        tenancy = getattr(self.trainer, "tenant_registry",
                          None) is not None
        by: dict[str, dict] = {}
        for name in self.trainer.tables:
            td = 0.0
            tp: list[float] = []
            th = 0.0
            for r, rep in self.rb.heat_reports(name).items():
                sv = rep.get("sv") or {}
                cur = float(sv.get("shed", 0.0))
                key = (name, int(r))
                prev = self._prev.get(key)
                if prev is not None and cur > prev:
                    shed_d += cur - prev
                    td += cur - prev
                self._prev[key] = cur
                p = rep.get("p99")
                if isinstance(p, (int, float)):
                    p99s.append(float(p))
                    tp.append(float(p))
                totals.append(float(rep.get("total", 0.0)))
                th += float(rep.get("total", 0.0))
            if tenancy:
                by[name] = {"shed_d": round(td, 3),
                            "p99_ms": max(tp) if tp else None,
                            "heat": round(th, 3)}
        if tenancy and by:
            # the culprit: most shed pressure this tick, worst tail as
            # the tie-break — recorded into every decision's why
            self._by_tenant = by
            self._culprit = max(
                by, key=lambda n: (by[n]["shed_d"],
                                   by[n]["p99_ms"] or 0.0))
        mean = sum(totals) / len(totals) if totals else 0.0
        ratio = (max(totals) / mean) if mean > 0 else 0.0
        return shed_d, (max(p99s) if p99s else None), ratio

    def _slow_pressure(self) -> float:
        """Fail-slow coupling: a quorum-corroborated SLOW VERDICT is
        shed pressure by definition — the fleet's effective capacity
        shrank by the sick rank even though no bucket refused yet.
        One arming quantum per verdicted rank per tick, folded into
        the HOT decision ONLY (never into ``sheds_seen`` or the
        streak-rate evidence stats, which are documented to count
        real refusals); the pressure disappears with the verdict."""
        view = getattr(self.mb, "slow_view", None)
        if view is None:
            return 0.0
        nslow = len(view())
        if nslow:
            with self._lock:
                self.counters["slow_pressure_ticks"] = \
                    self.counters.get("slow_pressure_ticks", 0) + 1
        return nslow * self.cfg.up_shed

    def _slo_pressure(self) -> float:
        """SLO-burn coupling (obs/slo.py): a tenant burning its error
        budget on BOTH windows is demand pressure even before a bucket
        refuses — the serving plane's promotion budget flexes replicas
        immediately (serve/plane.py), and this is the rank half of the
        same signal. One arming quantum per burning tenant per tick,
        folded into the HOT decision ONLY, counted apart (the
        ``_slow_pressure`` contract: never into ``sheds_seen`` or the
        streak-rate evidence); gone the roll the burn clears."""
        sl = getattr(self.trainer, "slo_tracker", None)
        if sl is None:
            return 0.0
        nburn = sl.pressure_quanta()
        if nburn:
            with self._lock:
                self.counters["slo_pressure_ticks"] = \
                    self.counters.get("slo_pressure_ticks", 0) + 1
        return nburn * self.cfg.up_shed

    # --------------------------------------------------------------- tick
    def on_tick(self) -> None:
        """Called from ``ShardedPSTrainer.tick`` just before the
        membership queues run, COORDINATOR ONLY in effect: a credit
        granted here is consumed by ``membership.on_tick`` at this same
        boundary. Non-holders keep no streaks — a successor starts cold
        and re-arms from re-gossiped signals within ``up_after`` ticks."""
        if self.mb.coord != self.rank:
            self._hot = self._calm = 0
            self._streak_rates.clear()
            self._calm_rates.clear()
            return
        shed_d, p99, ratio = self._signals()
        with self._lock:
            self.counters["sheds_seen"] += int(shed_d)
        self.p99_last_ms = p99
        cfg = self.cfg
        hot = (shed_d + self._slow_pressure() + self._slo_pressure()
               >= cfg.up_shed
               or (cfg.up_p99_ms > 0 and p99 is not None
                   and p99 >= cfg.up_p99_ms)
               or (cfg.imb > 0 and ratio >= cfg.imb))
        if hot:
            self.counters["hot_ticks"] += 1
            self._streak_rates.append(shed_d)
            if p99 is not None:
                self.p99_hot_ms = max(self.p99_hot_ms, p99)
        if self._cooldown > 0:
            # the flap damper: signals are recorded above but no action
            # fires until the window closes — a shed burst straddling an
            # admit must not immediately admit again (or drain)
            self._cooldown -= 1
            return
        if hot:
            self._hot += 1
            self._calm = 0
            self._calm_rates.clear()
            if self._hot >= cfg.up_after:
                self._try_admit()
        else:
            self.counters["calm_ticks"] += 1
            self._calm += 1
            self._calm_rates.append(shed_d)
            self._hot = 0
            self._streak_rates.clear()
            if self._calm >= cfg.down_after:
                self._try_drain()

    # ------------------------------------------------------------ actions
    def _try_admit(self) -> None:
        cfg = self.cfg
        if self.mb.pending_joins() < 1:
            return  # hot with no standby to admit: stay hot, no flap
        live = self.mb.live_view()
        if cfg.max_live and len(live) >= cfg.max_live:
            return
        # the hot-streak mean shed rate, computed ONCE: it is both the
        # first-admit evidence stat (shed_rate_pre) and the decision's
        # recorded WHY — captured BEFORE the streak state is cleared
        # below, because the signal values at decision time are what a
        # post-mortem needs to judge the loop
        rate_now = (round(sum(self._streak_rates)
                          / len(self._streak_rates), 3)
                    if self._streak_rates else None)
        if self.counters["admits"] == 0 and rate_now is not None:
            self.shed_rate_pre = rate_now
        why = {"live": sorted(live),
               "shed_rate": rate_now,
               "p99_ms": self.p99_last_ms,
               "hot_streak": self._hot}
        if self._culprit is not None:
            why["tenant"] = self._culprit  # who caused the scale-up
        self.mb.grant_join()
        with self._lock:
            self.counters["admits"] += 1
        self._hot = 0
        self._streak_rates.clear()
        self._cooldown = cfg.cool
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("autoscale", "as_admit",
                       {"live": sorted(live),
                        "pre_rate": self.shed_rate_pre})
        # a scaling DECISION, not a failure: recorded + dumped via
        # checkpoint() so the box always carries the latest action
        # without growing the poison reasons list or flagging healthy
        # autoscaling as a poison on the merged timeline
        _fl.checkpoint("as_admit", why)

    def _try_drain(self) -> None:
        from minips_tpu_torch.balance.membership import Membership

        live = self.mb.live_view()
        # only reclaim autoscaler growth (live − launch config), highest
        # rank first, never the lease holder: the fleet floor is the
        # operator's and the planner cannot drain itself
        cands = [r for r in sorted(live - self._initial_live,
                                   reverse=True) if r != self.mb.coord]
        if not cands:
            self._calm = 0
            self._calm_rates.clear()
            return
        victim = cands[0]
        # the decision-relevant calm rate: the SAME last-down_after
        # slice the loop judged (the full-list mean can differ after a
        # long calm tail, and the box must carry the value consulted)
        rate_now = (round(sum(self._calm_rates[-self.cfg.down_after:])
                          / min(len(self._calm_rates),
                                self.cfg.down_after), 3)
                    if self._calm_rates else 0.0)
        if self.counters["drains"] == 0 and self._calm_rates:
            self.shed_rate_post = rate_now
        why = {"rank": int(victim),
               "shed_rate": rate_now,
               "p99_ms": self.p99_last_ms,
               "calm_streak": self._calm}
        if self._culprit is not None:
            # the tenant whose pressure the calm streak released —
            # last hot culprit, the drain's "who stopped storming"
            why["tenant"] = self._culprit
        self.trainer.bus.send(victim, Membership.DRAIN_KIND,
                              {**self.mb.lease.stamp()})
        with self._lock:
            self.counters["drains"] += 1
        self._calm = 0
        self._calm_rates.clear()
        self._cooldown = self.cfg.cool
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("autoscale", "as_drain", {"rank": int(victim)})
        _fl.checkpoint("as_drain", why)

    # -------------------------------------------------- handover transfer
    def export_state(self) -> dict:
        """The hysteresis state a graceful lease handover ships to the
        successor (``Membership.handover`` → ``mbH``): streaks, the
        cool-down window, the rates being averaged, and the per-(table,
        rank) shed-counter baselines — WITHOUT the baselines the
        successor's first diff re-baselines and silently swallows one
        tick of sheds. Counters and evidence stats stay local: they are
        per-rank observability, not loop state."""
        with self._lock:
            return {
                "hot": self._hot, "calm": self._calm,
                "cooldown": self._cooldown,
                "streak_rates": list(self._streak_rates),
                "calm_rates": list(self._calm_rates),
                # wire-safe encoding: framing str-coerces dict keys, so
                # tuple keys ride as a row list
                "prev": [[name, int(r), float(v)]
                         for (name, r), v in self._prev.items()],
            }

    def install_state(self, state: dict) -> None:
        """Install a handed-over hysteresis state (the successor's side
        of ``mbH``). The next ``on_tick`` on the new holder then
        decides exactly as an uninterrupted coordinator would —
        pinned by the handover oracle test."""
        with self._lock:
            self._hot = int(state.get("hot", 0))
            self._calm = int(state.get("calm", 0))
            self._cooldown = int(state.get("cooldown", 0))
            self._streak_rates = [float(x) for x in
                                  state.get("streak_rates", ())]
            self._calm_rates = [float(x) for x in
                                state.get("calm_rates", ())]
            self._prev = {(str(name), int(r)): float(v)
                          for name, r, v in state.get("prev", ())}

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out.update({
            "coord": self.mb.coord,
            "lease_term": self.mb.lease.current()[0],
            "shed_rate_pre": self.shed_rate_pre,
            "shed_rate_post": self.shed_rate_post,
            "p99_hot_ms": round(self.p99_hot_ms, 3) or None,
            "p99_last_ms": self.p99_last_ms,
        })
        if getattr(self.trainer, "tenant_registry", None) is not None:
            out["tenants"] = dict(self._by_tenant)
            out["culprit"] = self._culprit
        return out
