"""The heat-aware shard rebalancer: planner + coordinator.

The sharded PS partitions tables by STATIC contiguous key range
(parallel/partition.RangePartitioner), so zipf-skewed traffic lands its
whole head on one owner and that shard paces the system. This module
closes the loop online:

1. every owner keeps decayed per-key-block heat on its serve path
   (balance/heat.py) and gossips a bounded report to the coordinator
   (rank 0) every clock: ``rbH:{table}`` — epoch, settled flag, total
   owned heat, and its top-k hottest blocks;
2. once every live rank is SETTLED at the same routing epoch, the
   report interval has elapsed, and the max/mean per-shard heat ratio
   exceeds the hysteresis threshold, the coordinator greedily bin-packs
   hot blocks away from the hottest shard (:func:`plan_assignment`) and
   broadcasts the FULL new block→owner overlay stamped with the next
   routing epoch (``rbP:{table}``);
3. every rank adopts the plan at its next clock boundary
   (``ShardedPSTrainer.tick``) — the epoch-fenced migration itself
   (state ship, stale-frame forward/refuse, rbA/rbF fencing) lives in
   train/sharded_ps.py, where the storage and locks are.

Config rides ``MINIPS_REBALANCE`` (off by default), e.g.::

    MINIPS_REBALANCE="interval=1.0,threshold=1.3,max_blocks=8,block=64"

``"1"`` selects all defaults. Knob reference: docs/api.md; protocol and
safety argument: docs/architecture.md "Heat-aware shard rebalancer".

A copy of ``minips_tpu/balance/rebalancer.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc

__all__ = ["RebalanceConfig", "Rebalancer", "plan_assignment"]


class RebalanceConfig:
    """Parsed ``MINIPS_REBALANCE`` knobs (all optional, ``k=v`` comma
    list; the bare string ``"1"`` = every default)."""

    def __init__(self, *, interval: float = 1.0, threshold: float = 1.3,
                 max_blocks: int = 8, block: int = 0, decay: float = 0.8,
                 topk: int = 32, min_heat: float = 1.0):
        if interval < 0:
            raise ValueError("interval must be >= 0")
        if threshold < 1.0:
            raise ValueError("threshold must be >= 1.0 (a max/mean "
                             "ratio below 1 is impossible)")
        if max_blocks < 1:
            raise ValueError("max_blocks must be >= 1")
        if block < 0:
            raise ValueError("block must be >= 0 (0 = auto)")
        self.interval = float(interval)   # min seconds between plans
        self.threshold = float(threshold)  # max/mean heat arming ratio
        self.max_blocks = int(max_blocks)  # blocks moved per plan
        self.block = int(block)            # keys per block (0 = auto)
        self.decay = float(decay)          # per-tick heat decay
        self.topk = int(topk)              # movable candidates per report
        self.min_heat = float(min_heat)    # don't plan on noise

    @classmethod
    def parse(cls, spec: str) -> "RebalanceConfig":
        spec = (spec or "").strip()
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"interval": float, "threshold": float, "decay": float,
                 "min_heat": float, "max_blocks": int, "block": int,
                 "topk": int}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"MINIPS_REBALANCE: expected k=v, "
                                 f"got {item!r}")
            k, v = item.split("=", 1)
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_REBALANCE: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_REBALANCE: bad value for {k}: {v!r}") from e
        return cls(**kw)


def plan_assignment(loads, candidates: dict, threshold: float,
                    max_blocks: int) -> list[tuple[int, int, int]]:
    """Greedy bin-pack of hot blocks, with hysteresis.

    ``loads`` is per-shard total heat; ``candidates`` maps movable
    ``block -> (current_owner, heat)``. Returns up to ``max_blocks``
    moves ``(block, src, dst)``, or ``[]`` when the imbalance is under
    ``threshold`` (hysteresis: the rebalancer only fires past the
    arming ratio, so balanced traffic never migrates anything).

    Invariants (property-tested): each move takes the hottest movable
    block of the CURRENTLY hottest shard whose heat fits strictly
    inside the hot→cool gap — so the pairwise imbalance strictly
    decreases on every move and the plan can never overshoot into a
    new, worse hotspot; a block is moved at most once per plan."""
    loads = np.asarray(loads, np.float64).copy()
    n = loads.size
    mean = loads.sum() / n if n else 0.0
    if mean <= 0.0 or loads.max() / mean < threshold:
        return []
    by_owner: dict[int, list[tuple[float, int]]] = {}
    for b, (o, h) in candidates.items():
        if h > 0.0:
            by_owner.setdefault(int(o), []).append((float(h), int(b)))
    for o in by_owner:
        by_owner[o].sort(reverse=True)
    moves: list[tuple[int, int, int]] = []
    while len(moves) < max_blocks:
        if loads.max() / mean < threshold:
            break  # balanced enough: stop early (the other hysteresis)
        hot = int(np.argmax(loads))
        cool = int(np.argmin(loads))
        gap = loads[hot] - loads[cool]
        pick = None
        for i, (h, _b) in enumerate(by_owner.get(hot, ())):
            if h < gap:  # strictly improving and non-flipping
                pick = i
                break
        if pick is None:
            break  # nothing movable improves the hottest shard
        h, b = by_owner[hot].pop(pick)
        moves.append((b, hot, cool))
        loads[hot] -= h
        loads[cool] += h
    return moves


class Rebalancer:
    """Per-trainer rebalance driver: heat reports every clock, plans at
    the coordinator (rank 0), plan adoption at each rank's own clock
    boundary. The migration mechanics (state ship, fences, stale-frame
    handling) live on the tables; this object is the control loop."""

    HEAT_KIND = "rbH"
    PLAN_KIND = "rbP"

    def __init__(self, trainer, cfg: RebalanceConfig, *,
                 plan_heat: bool = True):
        """``plan_heat=False`` arms the migration MACHINERY (router,
        heat accounting, plan adoption, fences) without the heat-driven
        planner — the elastic membership plane (balance/membership.py)
        needs the former even when nobody asked for the latter."""
        self.trainer = trainer
        self.cfg = cfg
        self.plan_heat = bool(plan_heat)
        self.bus = trainer.bus
        self.rank = trainer.bus.my_id
        self.n = trainer.num_processes
        self.coord = 0
        self.plans = 0
        self.stale_plans_fenced = 0  # rbP frames dropped by lease term
        # tenancy (tenant/registry.py): rbH frames whose tenant stamp
        # disagreed with the table they arrived on (dropped — block
        # ids are table-local, a crossed report must never feed a
        # plan), and heat plans deferred so one tenant's migration
        # never overlaps another's staging window
        self.tenant_heat_crossed = 0
        self.tenant_plans_deferred = 0
        self._stopped = False
        self._drive_thread: Optional[int] = None  # push-driving thread
        self._lock = threading.Lock()
        self._pending: dict[str, dict] = {}        # table -> newest plan
        self._reports: dict[str, dict[int, dict]] = {}  # table -> rank ->
        self._last_plan: dict[str, float] = {}
        self._t0 = time.monotonic()
        for name, t in trainer.tables.items():
            t.attach_rebalancer(self, cfg)
            self.bus.on(f"{self.PLAN_KIND}:{name}",
                        self._mk_on_plan(name))
            self.bus.on(f"{self.HEAT_KIND}:{name}",
                        self._mk_on_heat(name))

    # ------------------------------------------------------------ handlers
    def _lease(self):
        """The coordinator lease when the membership plane is armed
        (balance/control_plane.py) — plan broadcasts are stamped with
        its term and stale-term plans fenced at receive; None keeps the
        pre-lease wire for rebalance-only fleets."""
        mb = getattr(self.trainer, "membership", None)
        return mb.lease if mb is not None else None

    def _lease_stamp(self) -> dict:
        lease = self._lease()
        return lease.stamp() if lease is not None else {}

    def _mk_on_plan(self, name: str):
        def on_plan(sender: int, payload: dict) -> None:
            mb = getattr(self.trainer, "membership", None)
            if mb is not None and not mb.fence_frame(payload):
                # a partitioned ex-coordinator's post-return plan:
                # fenced by lease term, never adopted — the epoch
                # check alone cannot save us (the stale holder may
                # stamp any epoch it likes)
                self.stale_plans_fenced += 1
                return
            if mb is not None and mb.refuses_own_death_plan(payload):
                # a death plan naming THIS rank: the convicted-but-
                # alive rank (partition survivor the fleet gave up on)
                # must not adopt its own death — see membership.py
                return
            extras = {k: payload[k] for k in ("dead", "rstep")
                      if k in payload}
            self.note_plan(name, int(payload.get("ep", 0)),
                           dict(zip(payload.get("ovb", ()),
                                    payload.get("ovo", ()))),
                           extras=extras or None)
        return on_plan

    def note_plan(self, name: str, ep: int, ov: dict,
                  extras: Optional[dict] = None) -> None:
        """Stash a routing table for the table's owner thread to adopt
        at its next clock boundary / pull-wait poll. Adoption NEVER
        happens on the bus receive thread: the adoption ack's ordering
        promise ('my stale pushes all precede it') only holds from the
        thread that drives pushes. ``extras`` carry a membership
        transition's metadata (dead sources + restore step) through to
        ``adopt_table``."""
        with self._lock:
            cur = self._pending.get(name)
            if cur is None or ep > cur["ep"]:
                self._pending[name] = {"ep": ep, "ov": dict(ov),
                                       "extras": extras}

    def issue_plan(self, name: str, ep: int, ov: dict,
                   extras: Optional[dict] = None) -> None:
        """Coordinator-side plan broadcast + immediate local adoption —
        the membership plane's transition emitter (and the one path a
        plan's extras ride, so death restores dispatch identically at
        every rank). The caller must be at its clock boundary on the
        push-driving thread, like ``_maybe_plan``."""
        payload = {"ep": int(ep), "ovb": [int(b) for b in ov],
                   "ovo": [int(o) for o in ov.values()],
                   **self._lease_stamp()}
        if extras:
            payload.update(extras)
        self.bus.publish(f"{self.PLAN_KIND}:{name}", payload)
        self.plans += 1
        self.note_plan(name, ep, ov, extras=extras)
        self._adopt_one(name, self.trainer.tables[name])

    def claim_drive_thread(self) -> None:
        """Declare the CALLING thread the push-driving thread (the
        ``stop()`` rule, without stopping planning): a draining rank's
        leave loop adopts plans from its own thread after its last
        tick ran elsewhere."""
        self._drive_thread = threading.get_ident()

    def _mk_on_heat(self, name: str):
        def on_heat(sender: int, payload: dict) -> None:
            # tenancy namespace guard: block ids in a heat report are
            # TABLE-LOCAL, so a report stamped for a different tenant
            # than the table this wire belongs to (half-armed fleet,
            # divergent registry order) must never enter the planner —
            # the config stamp poisons the data wire for the same
            # divergence; this is the control wire's twin
            t = self.trainer.tables.get(name)
            tid = getattr(t, "_tenant_tid", 0) if t is not None else 0
            if int(payload.get("tb", 0)) != tid:
                self.tenant_heat_crossed += 1
                return
            with self._lock:
                self._reports.setdefault(name, {})[sender] = payload
        return on_heat

    # ------------------------------------------------------------ the loop
    def on_tick(self) -> None:
        """Called from ``ShardedPSTrainer.tick`` at the clock boundary,
        after the push drain and before the clock advances: adopt any
        pending plan (the epoch fence point), decay heat, gossip the
        report, and — at the coordinator — maybe plan."""
        now = time.monotonic()
        # the tick caller IS the push-driving thread by contract; record
        # it so adopt_now() can refuse other threads (see below)
        self._drive_thread = threading.get_ident()
        for name, t in self.trainer.tables.items():
            self._adopt_one(name, t)
            if t._heat is not None:
                t._heat.tick()
            self._send_heat(name, t)
            if self.rank == self.coord and not self._stopped:
                self._maybe_plan(name, t, now)

    def adopt_now(self) -> None:
        """Adopt pending plans outside the tick path — finalize and
        pull_all call this so a plan landing after a rank's last tick
        still gets its adoption ack (a missing ack would hold peers'
        fences open until their pull deadline poisons).

        THREAD-GUARDED (serving plane): the pull-wait poll also calls
        this, and under a read storm pulls run on READER threads
        concurrent with the training thread's pushes — an adoption from
        a reader could emit its rbA around a mid-flight old-table push
        send and void the fence (the exact bus-thread hazard the
        migration's review fixed). Once a tick has identified the push-driving
        thread, every other thread's adopt_now is a no-op; the driving
        thread's next tick (bounded — it ticks every step) adopts
        instead. Before the first tick any thread may adopt (raw-table
        drills drive no concurrent pushes)."""
        if self._drive_thread is not None \
                and self._drive_thread != threading.get_ident():
            return
        for name, t in self.trainer.tables.items():
            self._adopt_one(name, t)

    def install_reports(self, reports: dict[str, dict[int, dict]]) -> None:
        """Install a handed-over report store (graceful lease handover,
        balance/membership.Membership._on_handover): the successor's
        first coordinator boundary sees the old holder's load picture
        instead of a cold start. Fresher reports that already arrived
        here win — a transferred snapshot must never roll a rank's
        report backward past one the rank re-gossiped directly."""
        with self._lock:
            for name, by_rank in reports.items():
                store = self._reports.setdefault(name, {})
                for r, rep in by_rank.items():
                    store.setdefault(int(r), dict(rep))

    def heat_reports(self, name: str) -> dict[int, dict]:
        """Snapshot of the coordinator's stored per-rank heat reports
        for ``name`` — the membership plane's admission planner reads
        them so a joiner's placement can be heat-aware instead of
        home-blocks-only (balance/membership.plan_admission)."""
        with self._lock:
            return {r: dict(rep)
                    for r, rep in self._reports.get(name, {}).items()}

    def has_pending(self, name: str) -> bool:
        """A plan for ``name`` is noted but not yet adopted — readers
        blocked on keys the pending table re-homes wait for the
        driving thread's adoption instead of re-issuing pulls the old
        table routes straight back (train/sharded_ps._read_local)."""
        with self._lock:
            return name in self._pending

    def stop(self) -> None:
        """No further plans (finalize): migrations already in flight
        still settle through the normal fence path. The CALLING thread
        becomes the push-driving thread: finalize() drains pushes on
        this thread next, so the thread-guard must let ITS adopt_now
        through even when ticks ran elsewhere — otherwise the final
        pending plan's rbA never goes out and peers' fences hold to
        their pull deadline (the exact poison adopt_now prevents)."""
        self._stopped = True
        self._drive_thread = threading.get_ident()

    def _adopt_one(self, name: str, t) -> None:
        with self._lock:
            plan = self._pending.pop(name, None)
        if plan is None:
            return
        extras = plan.get("extras") or {}
        dead = frozenset(int(r) for r in extras.get("dead") or ())
        restore = None
        if dead:
            mb = getattr(self.trainer, "membership", None)
            if mb is not None:
                restore = mb.block_restorer(name, extras)
        t.adopt_table(plan["ep"], plan["ov"], dead=dead,
                      restore=restore)

    def _send_heat(self, name: str, t) -> None:
        ep, _ov = t.router.table()
        owned = np.nonzero(t.router.owner_of_blocks() == self.rank)[0]
        rep = t._heat.report(owned, self.cfg.topk)
        rep["ep"] = ep
        rep["settled"] = t.rebalance_settled()
        if getattr(self.trainer, "autoscaler", None) is not None:
            # autoscaler load signals ride the heat report (balance/
            # autoscaler.py): cumulative serve-plane shed counters plus
            # the pull p99 — re-gossiped every tick, so a lease
            # successor's autoscaler reconstructs the fleet load
            # picture in one boundary with no extra wire. The p99 is
            # the WINDOWED quantile (obs/window.py, rolled by the
            # trainer at this same clock boundary): an idle window
            # reports None (calm), and a storm that ENDED leaves the
            # signal within one window — the disarm the cumulative
            # hist could never produce. MINIPS_OBS=0 falls back to the
            # cumulative quantile (the pre-window behavior, kept only
            # for the tax A/B arm).
            if t._sv is not None:
                rep["sv"] = t._sv.load_signal()
            ow = getattr(self.trainer, "obs_window", None)
            if ow is not None:
                # tenancy armed: the report carries THIS tenant's own
                # windowed pull p99 (registered per table by
                # _register_window_signals), so the autoscaler's SLO
                # arming judges each tenant against its own tail
                # instead of the fleet blend
                sig = ("pull_latency" if not getattr(t, "_tenant_tid", 0)
                       else f"pull_latency:{name}")
                rep["p99"] = ow.quantile_ms(sig, 0.99)
            else:
                from minips_tpu_torch.obs.hist import summarize_counts

                rep["p99"] = summarize_counts(
                    t.timers.snapshot()["hists"]["pull_latency"]).get(
                        "p99_ms")
        if self.rank == self.coord:
            with self._lock:
                self._reports.setdefault(name, {})[self.rank] = rep
        else:
            self.bus.send(self.coord, f"{self.HEAT_KIND}:{name}", rep)

    def _live_ranks(self) -> set[int]:
        excluded = getattr(self.trainer.gossip, "excluded", set())
        return set(range(self.n)) - set(excluded)

    def _maybe_plan(self, name: str, t, now: float) -> None:
        if not self.plan_heat:
            return
        mb = getattr(self.trainer, "membership", None)
        if mb is not None and mb.busy:
            # a membership transition is in flight: its plan must not
            # interleave with a heat plan (the planner's one-plan-at-a-
            # time quality rule; adoption itself tolerates pipelining)
            return
        if getattr(t, "_tenant_tid", 0):
            # per-tenant migration scheduling: at most ONE tenant's
            # heat migration in flight fleet-wide — a plan for this
            # table is deferred while any other table has a pending
            # plan or unsettled fences, so two tenants' state ships
            # can never stack in one staging window (the per-round
            # reshard cap bounds each table alone; overlap would sum
            # them). Membership transitions (join/drain/death) stay
            # fleet-wide — an evacuation must cover every table at
            # once, the documented honest limit.
            for oname, ot in self.trainer.tables.items():
                if oname != name and (self.has_pending(oname)
                                      or not ot.rebalance_settled()):
                    self.tenant_plans_deferred += 1
                    return
        last = self._last_plan.get(name, self._t0)
        if now - last < self.cfg.interval:
            return
        ep, ov = t.router.table()
        live = self._live_ranks()
        with self._lock:
            reports = dict(self._reports.get(name, {}))
        if not live <= set(reports):
            return
        # plan only over a SETTLED fleet at the current epoch: a rank
        # mid-migration (fences pending) or still on the old table would
        # make the diff-based adoption ambiguous — one plan in flight
        # at a time, by construction
        if any(reports[r].get("ep") != ep or not reports[r].get("settled")
               for r in live):
            return
        # plan over LIVE ranks only, in a compact index space: a dead
        # excluded rank must never appear as a zero-load migration
        # target (state shipped to a corpse is state lost), nor deflate
        # the mean into spuriously arming the threshold
        live_sorted = sorted(live)
        if len(live_sorted) < 2:
            return
        loads = np.zeros(len(live_sorted), np.float64)
        candidates: dict[int, tuple[int, float]] = {}
        for i, r in enumerate(live_sorted):
            rep = reports[r]
            loads[i] = float(rep.get("total", 0.0))
            for b, h in zip(rep.get("blocks", ()), rep.get("heat", ())):
                candidates[int(b)] = (i, float(h))
        if loads.sum() < self.cfg.min_heat:
            return
        # fail-slow DEMOTION (obs/slowness.py, the write/placement
        # mitigation): while a quorum-corroborated slow verdict stands
        # the planner runs a DEMOTE pass instead of the heat pass —
        # the sick rank's load is multiplied by the demote bias (its
        # effective capacity shrank by that factor), candidates narrow
        # to blocks the sick rank owns, and the arming ratio drops to
        # 1.0: a verdict IS the arming — demotion must move hot blocks
        # off the sick rank even when raw heat looks balanced (a
        # ratio threshold can provably never clear cfg.threshold >= 3
        # in a small fleet: one biased rank tops out at 3b/(2+b) < 3).
        # plan_assignment's strictly-inside-the-gap rule still bounds
        # every move, so demotion cannot overshoot into a new hotspot;
        # the bias lifts by itself when the verdict clears (slow_view
        # recomputes), so a recovered rank's blocks stay put.
        slow: set[int] = set()
        bias = 0.0
        if mb is not None:
            view = getattr(mb, "slow_view", None)
            if view is not None:
                slow = view()
                bias = mb.slow_demote_bias()
        sick_idx = {i for i, r in enumerate(live_sorted) if r in slow}
        if sick_idx and bias > 1.0:
            for i in sick_idx:
                loads[i] *= bias
            sick_cands = {b: ih for b, ih in candidates.items()
                          if ih[0] in sick_idx}
            moves = [(b, live_sorted[s], live_sorted[d])
                     for b, s, d in plan_assignment(
                         loads, sick_cands, 1.0, self.cfg.max_blocks)]
        else:
            moves = [(b, live_sorted[s], live_sorted[d])
                     for b, s, d in plan_assignment(
                         loads, candidates, self.cfg.threshold,
                         self.cfg.max_blocks)]
        if not moves:
            return
        demoted = sorted({s for _b, s, _d in moves if s in slow})
        if demoted:
            # the DEMOTE decision into the black box: which sick
            # rank(s) lost how many blocks, under which verdict view
            _fl.record("demote",
                       {"table": name, "ranks": demoted,
                        "blocks": sum(1 for _b, s, _d in moves
                                      if s in slow),
                        "bias": bias, "ep": ep + 1})
        new_ov = dict(ov)
        for b, _src, dst in moves:
            if dst == t.router.home_of(b):
                new_ov.pop(b, None)  # moving home: leave the base map
            else:
                new_ov[b] = dst
        new_ep = ep + 1
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("rebalance", "rb_plan",
                       {"table": name, "ep": new_ep,
                        "moves": [[int(b), int(s), int(d)]
                                  for b, s, d in moves]})
        self.bus.publish(f"{self.PLAN_KIND}:{name}",
                         {"ep": new_ep,
                          "ovb": [int(b) for b in new_ov],
                          "ovo": [int(o) for o in new_ov.values()],
                          **self._lease_stamp()})
        self.plans += 1
        self._last_plan[name] = now
        # the coordinator is at its own clock boundary right now: adopt
        # immediately (peers adopt at theirs; the epoch fence covers the
        # window in between)
        t.adopt_table(new_ep, new_ov)

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        out = {"plans": self.plans,
               "stale_plans_fenced": self.stale_plans_fenced,
               "tenant_heat_crossed": self.tenant_heat_crossed,
               "tenant_plans_deferred": self.tenant_plans_deferred}
        per = {}
        for name, t in self.trainer.tables.items():
            per[name] = t.rebalance_table_stats()
        out["tables"] = per
        out["epoch"] = max((p["epoch"] for p in per.values()), default=0)
        for k in ("blocks_in", "blocks_out", "forwarded_pushes",
                  "refused_pulls", "migrated_rows", "blocks_restored",
                  "pushes_lost_to_dead"):
            out[k] = sum(p.get(k, 0) for p in per.values())
        # a MAX, not a sum: the staging cap bounds each rank's worst
        # simultaneous snapshot — the RESHARD-MEM gate's p2p baseline
        out["peak_stage_bytes"] = max(
            (p.get("peak_stage_bytes", 0) for p in per.values()),
            default=0)
        return out
