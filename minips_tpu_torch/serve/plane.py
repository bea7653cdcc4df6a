"""Snapshot-consistent hot-range read replicas + admission control.

The read-mostly serving plane over the key-range-sharded PS
(train/sharded_ps.py). Three cooperating roles, all carried by the same
``TableServeState`` object every rank holds per table:

OWNER — promotes its hottest key blocks (the decayed heat accounting
the rebalancer already keeps, balance/heat.py; the serve plane arms a
``HeatAccountant`` itself when the rebalancer is off) to ``replicas``
peer ranks: a full-block snapshot grant (``svU full=1``), then
stamped DELTA frames every ``interval`` seconds shipping only the rows
pushes dirtied since the last refresh (``svU full=0`` — the
SparCML-style sparse refresh stream; rows ride the table's configured
pull wire, int8 when configured, so the refresh bytes get the same
codec the pull path already pays for). An empty delta still goes out:
it renews the LEASE and advances the snapshot STAMP, without which the
replica's admissible window would freeze while clocks advance. Owners
broadcast their replica map (``svM``) so clients can route; a block
that cools below ``min_heat/2`` (hysteresis) or MIGRATES AWAY under a
rebalance plan is revoked (``svR``) — lease/epoch invalidation rides
the same ``adopt_table`` fence point the rebalancer uses, so serving
composes with online migration instead of fighting it.

THE STALENESS ARGUMENT (why a replica hit is provably no staler than
an owner pull): every grant/delta is stamped with the owner's
``ClockGossip.global_min()`` read BEFORE the state read. Per-link FIFO
means a peer's pushes through clock ``k`` are applied at the owner
before the owner's view shows ``k`` — so a snapshot stamped ``g``
contains EVERY worker's updates through ``g``, the requester's own
included (the owner pull path stamps ``min_excluding(requester)``,
which is ≥ ``global_min`` — the replica stamp is strictly more
conservative). A replica serves a pull stamped with requester clock
``c`` only when ``consistency.gate.admits(stamp, c, s)`` — the
IDENTICAL predicate the owner-side park and the client RowCache run — and
otherwise refuses (``svN``), so the SSP bound holds unchanged and the
client row cache ingests replica replies with no new rule. The
certificate survives migration (the rows provably contain everything
through ``stamp`` regardless of who owns the block now); leases and
revocation are about liveness and protocol hygiene, not the bound.

REPLICA — holds granted block snapshots and serves ``svP`` pulls from
them (no parking: a request the snapshot cannot admit is refused and
the client falls back to the owner, whose park machinery is the one
place requests wait). Expired leases refuse too — a mute owner's
replicas go dark instead of serving an ever-staler snapshot (the
``admits`` check would refuse eventually anyway; the lease refuses
promptly).

CLIENT — fans hot-block pull legs out across ``{owner} ∪ holders``
round-robin (``route_targets``), falls back to the owner on any
refusal, and honors the owner's admission verdicts: ``svS`` redirects
the leg to a replica, ``svB`` schedules a delayed retry. Retried legs
carry ``rt >= 1`` and are force-admitted at the owner — every path is
bounded (at most two extra hops) and every refusal is explicit:
backpressure, never silence.

Everything is OFF by default; ``MINIPS_SERVE`` (or
``ShardedPSTrainer(serve=...)``) arms it::

    MINIPS_SERVE="replicas=2,hot=8,interval=0.1,min_heat=64,lease=2.0"

Knob reference: docs/api.md; protocol walkthrough: docs/serving.md.

A copy of ``minips_tpu/serve/plane.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from minips_tpu_torch.consistency.gate import admits
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc
from minips_tpu_torch.obs.freshness import FreshnessTracker
from minips_tpu_torch.obs.hist import Log2Histogram, merge_counts, slo_check
from minips_tpu_torch.serve.admission import TokenBucket

__all__ = ["ServeConfig", "ServePlane", "TableServeState"]


class ServeConfig:
    """Parsed ``MINIPS_SERVE`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default)."""

    def __init__(self, *, replicas: int = 1, hot: int = 8,
                 interval: float = 0.25, min_heat: float = 64.0,
                 lease: float = 2.0, rate: float = 0.0, burst: int = 32,
                 retry_ms: float = 2.0, decay: float = 0.8,
                 topk: int = 32, slo_p99_ms: float = 0.0):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if hot < 1:
            raise ValueError("hot must be >= 1")
        if interval < 0:
            raise ValueError("interval must be >= 0 (0 = refresh at "
                             "every clock boundary)")
        if lease <= 0:
            raise ValueError("lease must be > 0")
        if rate < 0:
            raise ValueError("rate must be >= 0 (0 = admission off)")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        if retry_ms < 0:
            raise ValueError("retry_ms must be >= 0")
        self.replicas = int(replicas)    # holders per promoted block
        self.hot = int(hot)              # max promoted blocks per owner
        self.interval = float(interval)  # refresh/promotion cadence (s)
        self.min_heat = float(min_heat)  # promotion threshold
        self.lease = float(lease)        # lease duration (s)
        self.rate = float(rate)          # admission: pulls/sec (0=off)
        self.burst = int(burst)          # admission: bucket capacity
        self.retry_ms = float(retry_ms)  # svB client backoff
        self.decay = float(decay)        # heat decay (rebalancer off)
        self.topk = int(topk)            # heat-report candidates
        self.slo_p99_ms = float(slo_p99_ms)  # pull p99 target (0=off)

    @classmethod
    def parse(cls, spec: str) -> "ServeConfig":
        spec = (spec or "").strip()
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"interval": float, "min_heat": float, "lease": float,
                 "rate": float, "retry_ms": float, "decay": float,
                 "slo_p99_ms": float, "replicas": int, "hot": int,
                 "burst": int, "topk": int}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_SERVE: expected k=v, got {item!r}")
            k, v = item.split("=", 1)
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_SERVE: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_SERVE: bad value for {k}: {v!r}") from e
        return cls(**kw)


# every counter the done-line "serve.replica" block carries — zeros when
# armed-but-idle (the obs off-vs-idle convention; OFF is the None the
# trainer reports with no plane attached)
_COUNTERS = (
    # owner side
    "grants", "revokes", "refresh_frames", "refresh_rows",
    "shed_redirects", "shed_partial", "backpressure", "forced_admits",
    # replica side
    "replica_served_requests", "replica_served_rows",
    "replica_local_rows", "lease_refused", "stale_refused",
    "orphan_frames",
    # client side
    "replica_rows_routed", "replica_fallbacks",
    "shed_redirected_legs", "shed_local_legs", "backpressure_waits",
    "stale_reads",
)


class TableServeState:
    """Per-table serving state: one object per (rank, table) carrying
    the owner / replica / client roles (which role fires depends on
    which frames arrive). Bound via ``ShardedTable.attach_serve_plane``
    — must happen before traffic, like the rebalancer."""

    def __init__(self, table, plane: "Optional[ServePlane]",
                 cfg: ServeConfig):
        self.table = table
        self.plane = plane
        self.cfg = cfg
        # tenancy (tenant/registry.py): a tenant's spec'd rate/burst
        # override the fleet-wide knobs — each tenant sheds into ITS
        # OWN bucket, so one tenant's storm can never drain another's
        # tokens. Under the registry's ``shared=1`` contrast arm every
        # table takes the plane's ONE fleet bucket instead (the
        # pre-tenancy coupling the multi_tenant bench measures
        # against) at the fleet rate.
        sp = getattr(table, "_tenant", None)
        self._rate = cfg.rate if sp is None or sp.rate is None \
            else sp.rate
        burst = cfg.burst if sp is None or sp.burst is None \
            else sp.burst
        shared = getattr(plane, "shared_bucket", None)
        if shared is not None:
            self.bucket = shared
            self._rate = cfg.rate
        else:
            self.bucket = TokenBucket(self._rate, burst)
        # owner role: granted block -> holder set, dirty key sets
        self._granted: dict[int, tuple[int, ...]] = {}
        self._dirty: dict[int, set[int]] = {}
        # freshness (obs/freshness.py): per dirty block, the monotonic
        # time of the FIRST push since the last refresh — the refresh
        # head's ``fts`` stamp is the min over the blocks it ships, so
        # the replica's ``now - fts`` is the oldest-contained-push
        # visibility lag
        self._dirty_t0: dict[int, float] = {}
        self.fresh = FreshnessTracker()
        self._ow_lock = threading.Lock()
        self._t_last_refresh = 0.0
        self._stopped = False
        # replica role: held block -> snapshot
        self._held: dict[int, dict] = {}
        self._rp_lock = threading.Lock()
        self.hist_replica = Log2Histogram()
        # client role: per-owner replica maps, merged for routing
        self._maps: dict[int, dict[int, tuple[int, ...]]] = {}
        self._merged: dict[int, tuple[int, ...]] = {}
        self._cl_lock = threading.Lock()
        self._rr = 0  # round-robin cursor (benign races are fine)
        self.counters = {k: 0 for k in _COUNTERS}
        self._cnt_lock = threading.Lock()

    # ------------------------------------------------------------ plumbing
    def handlers(self) -> list[tuple[str, object]]:
        """(frame kind, handler) pairs ``attach_serve_plane`` registers
        on the bus under ``<kind>:<table>``."""
        return [("svP", self._on_replica_pull),
                ("svU", self._on_update),
                ("svR", self._on_revoke),
                ("svM", self._on_map),
                ("svN", self._on_replica_refused),
                ("svS", self._on_shed),
                ("svB", self._on_backpressure)]

    def _count(self, key: str, n: int = 1) -> None:
        with self._cnt_lock:
            self.counters[key] += n

    def _tenant_deny(self, kind: str, sender: int, fl) -> None:
        """Attribute one admission denial to this table's tenant
        (no-op with tenancy off): the per-tenant counter feeds the
        done line's ``tenant`` block and the windowed ``shed:{table}``
        signal, and the ``tenant_shed``/``tenant_throttle`` flight
        events NAME the tenant — riding the caller's existing denial
        sampling so a storm can't rotate the black-box ring."""
        t = self.table
        sp = t._tenant
        if sp is None:
            return
        key = "shed" if kind == "tenant_shed" else "throttle"
        with t._serve_lock:
            t.tenant_counters[key] += 1
        if fl is not None:
            fl.ev(kind, {"tenant": sp.name, "tid": sp.tid,
                         "from": int(sender),
                         "shared": int(self.bucket is getattr(
                             self.plane, "shared_bucket", None))})

    def _staleness(self) -> float:
        return self.table._cache_staleness()

    def _stamp(self) -> int:
        """The snapshot freshness certificate: my gossip view's GLOBAL
        min (every worker included — see the module docstring's
        staleness argument; ``min_excluding`` would be unsound here
        because the future requester's identity is unknown at snapshot
        time, and its pushes reach the OWNER, not the replica)."""
        g = getattr(self.table._cons, "gossip", None)
        return int(g.global_min()) if g is not None else 0

    def _live_peers(self) -> list[int]:
        t = self.table
        return sorted(set(range(t.num_processes))
                      - t._excluded_ranks() - {t.rank})

    # ------------------------------------------------------------- owner
    def on_tick(self, *, tick_heat: bool) -> None:
        """Promotion / demotion / refresh, driven from the trainer's
        clock boundary on the PUSH-DRIVING thread (like rebalancer
        adoption — grant snapshots and revokes must not race this
        rank's own pushes or plan adoptions)."""
        t = self.table
        if t._heat is not None and tick_heat:
            t._heat.tick()
        if self._stopped or t.bus is None:
            return
        now = time.monotonic()
        if now - self._t_last_refresh < self.cfg.interval:
            return
        self._t_last_refresh = now
        changed = self._demote_cooled()
        changed |= self._promote_hot()
        self._refresh_granted()
        if changed:
            self._broadcast_map()

    def _owned_blocks(self) -> np.ndarray:
        t = self.table
        return np.nonzero(t.router.owner_of_blocks() == t.rank)[0]

    def _block_settled(self, b: int) -> bool:
        t = self.table
        with t._mig_cond:
            return b not in t._fenced and b not in t._pending_state

    def _demote_cooled(self) -> bool:
        t = self.table
        heat = t._heat.snapshot()
        owners = t.router.owner_of_blocks()
        dead = t._excluded_ranks()
        with self._ow_lock:
            granted = list(self._granted)
            # a grant naming a DEAD holder is demoted too: clients
            # filter excluded holders at route time, but the map must
            # shrink so the block can re-promote onto live ranks
            has_dead = {b for b in granted
                        if dead & set(self._granted[b])}
        cooled = [b for b in granted
                  if int(owners[b]) != t.rank
                  or heat[b] < self.cfg.min_heat * 0.5
                  or b in has_dead]
        if cooled:
            self._revoke_blocks(cooled)
        return bool(cooled)

    def _promote_hot(self) -> bool:
        t = self.table
        cfg = self.cfg
        rep = t._heat.report(self._owned_blocks(),
                             max(cfg.hot * 2, cfg.topk))
        hot = [int(b) for b, h in zip(rep["blocks"], rep["heat"])
               if h >= cfg.min_heat][: cfg.hot]
        live = self._live_peers()
        if not live:
            return False
        # ONE holder set per owner (not per block): every hot block this
        # owner grants goes to the same replica ranks, so a client pull
        # touching many hot blocks can ride ONE replica leg instead of
        # fragmenting per block — on loopback (and any frame-cost-bound
        # wire) leg count, not bytes, is what the storm pays for
        nrep = cfg.replicas
        tsp = getattr(t, "_tenant", None)
        if tsp is not None and tsp.replicas is not None:
            nrep = tsp.replicas  # per-tenant replica budget
        # SLO burn feeds the promotion budget (obs/slo.py): a burning
        # tenant's tables get ``boost`` extra replicas while the burn
        # lasts — the replica budget rides demand, not just rank count
        sl = getattr(getattr(self.plane, "trainer", None),
                     "slo_tracker", None)
        boost = sl.replica_boost(t.name) if sl is not None else 0
        budget = min(nrep + boost, len(live))
        holders = tuple(sorted(
            {live[(t.rank + j) % len(live)] for j in range(budget)}))
        if sl is not None:
            sl.note_budget(t.name, len(holders))
        with self._ow_lock:
            fresh = [b for b in hot if b not in self._granted]
            # budget up-flex: already-granted hot blocks whose holder
            # set is a strict subset of the boosted one re-grant (a
            # full snapshot to a holder that already has one is an
            # idempotent install); down-flex just shrinks the map —
            # dropped holders go dark via lease expiry, no revoke race
            grow = [b for b in hot if b in self._granted
                    and set(self._granted[b]) < set(holders)]
            shrank = [b for b in self._granted
                      if set(holders) < set(self._granted[b])]
            for b in shrank:
                self._granted[b] = holders
        fresh = [b for b in fresh if self._block_settled(b)]
        grow = [b for b in grow if self._block_settled(b)]
        if fresh or grow:  # mid-migration blocks retry next tick
            self._grant_blocks(fresh + grow, holders)
        return bool(fresh or grow or shrank)

    def _serve_wire(self) -> tuple[str, int]:
        """The grant/delta row codec this owner emits: the blockwise
        sub-8-bit codec when the table runs a compressed push wire
        (``blk8``/``blk4`` — the refresh stream gets the same byte win
        as the push leg, ops/quantized_comm blockwise codec at the
        table's block size), else the pull wire's per-row int8, else
        raw f32. Frames carry the tag + block, so replicas decode per
        frame like every other wire here."""
        t = self.table
        if t.push_comm in ("topk8", "topk4"):
            return ("blk8" if t.push_comm == "topk8" else "blk4",
                    t.topk_block)
        if t.pull_wire == "int8":
            return "int8", 0
        return "f32", 0

    def _encode_rows(self, rows: np.ndarray) -> tuple[str, bytes]:
        """Grant/delta row payload on :meth:`_serve_wire` — nearest
        rounding always (deterministic: every replica of one refresh
        decodes identical bytes, the pull-wire rule)."""
        wire, blk = self._serve_wire()
        if wire in ("blk8", "blk4"):
            from minips_tpu_torch.ops.quantized_comm import quantize_blockwise

            codes, scales = quantize_blockwise(
                rows, 8 if wire == "blk8" else 4, block=blk)
            return wire, scales.tobytes() + codes.tobytes()
        if wire == "int8":
            from minips_tpu_torch.ops.quantized_comm import quantize_rows_int8

            codes, scale = quantize_rows_int8(rows)
            return "int8", scale.tobytes() + codes.tobytes()
        return "f32", np.ascontiguousarray(rows, np.float32).tobytes()

    def _decode_rows(self, wire: str, blk: int, n: int,
                     blob: bytes) -> Optional[np.ndarray]:
        t = self.table
        if wire in ("blk8", "blk4"):
            from minips_tpu_torch.ops.quantized_comm import (
                blockwise_stream_bytes, dequantize_blockwise)

            bits = 8 if wire == "blk8" else 4
            if blk < 1:
                return None
            code_b, scale_b = blockwise_stream_bytes(n, t.dim, bits, blk)
            if len(blob) != scale_b + code_b:
                return None
            scales = np.frombuffer(blob[:scale_b], np.float32)
            return dequantize_blockwise(blob[scale_b:], scales, n,
                                        t.dim, bits, block=blk)
        if wire == "int8":
            if len(blob) != n * (4 + t.dim):
                return None
            from minips_tpu_torch.ops.quantized_comm import dequantize_rows_int8

            scale = np.frombuffer(blob[: 4 * n], np.float32)
            codes = np.frombuffer(blob[4 * n:], np.int8).reshape(n, t.dim)
            return dequantize_rows_int8(codes, scale)
        if len(blob) != n * 4 * t.dim:
            return None
        return np.frombuffer(blob, np.float32).reshape(n, t.dim).copy()

    def _send_updates(self, holder: int, entries: list, stamp: int,
                      *, renew: bool = False,
                      fts: "Optional[float]" = None) -> None:
        """Ship ONE multi-block ``svU`` frame to ``holder`` — grants
        and deltas batch into a single frame per (holder, refresh), so
        the refresh wire cost is O(holders) frames per tick, not
        O(blocks x holders) (frame count, not bytes, is what a
        loopback/oversubscribed host pays for). ``entries`` is
        ``[(block, full, keys|None, rows|None)]``. ``fts`` is the
        freshness stamp — the monotonic time of the oldest push this
        frame's rows contain (obs/freshness.py); renew-only frames
        carry none (nothing contained, nothing to be fresh about)."""
        t = self.table
        bs: list[int] = []
        fl: list[int] = []
        ns: list[int] = []
        parts: list[bytes] = []
        for b, full, keys, rows in entries:
            n = int(rows.shape[0]) if rows is not None else 0
            bs.append(int(b))
            fl.append(int(full))
            ns.append(n)
            if not full and n:
                parts.append(keys.tobytes())
            if n:
                parts.append(self._encode_rows(rows)[1])
        wire, blk = self._serve_wire()
        head = {"stamp": int(stamp), "lease": self.cfg.lease,
                "ep": t.router.epoch, "wire": wire, "blk": blk,
                "bs": bs, "fl": fl, "ns": ns, **t._cfg_header()}
        if renew:
            # renew the lease + stamp of EVERY block this holder holds
            # from me — constant-size, replaces per-block renewal
            # segments (the blob carries only dirty/granted blocks)
            head["renew"] = 1
        if fts is not None:
            head["fts"] = float(fts)
        self.fresh.note_shipped(fts is not None)
        t.bus.send(holder, f"svU:{t.name}", head,
                   blob=b"".join(parts))

    def _grant_blocks(self, bs: list[int],
                      holders: tuple[int, ...]) -> None:
        """Ship full-block snapshots to every holder — ONE batched
        frame per holder however many blocks promote this tick. The
        stamp is read BEFORE the rows (certificate = lower bound on
        content)."""
        t = self.table
        # register the grant BEFORE reading the snapshot: a push applied
        # between the state read and a later registration would be
        # noted into NEITHER the snapshot nor the dirty set — the
        # replica would silently miss it forever while renewals advance
        # its stamp past the pusher's clock (a value-level staleness
        # hole). Registered first, a concurrent push lands in the dirty
        # set and ships next refresh; pre-grant dirty keys merely
        # re-ship rows the snapshot already carries (redundant, sound).
        with self._ow_lock:
            for b in bs:
                self._granted[b] = holders
        stamp = self._stamp()
        # a snapshot's oldest contained push is unbounded; its freshness
        # stamp is the state-READ time, so the replica's lag reading is
        # pure ship+decode+install delay
        fts = time.monotonic()
        entries = []
        n_rows = 0
        for b in bs:
            lo, ln = t.router.block_span(b)
            keys = np.arange(lo, lo + ln, dtype=np.int64)
            with t._state_lock:
                rows = t._read_rows_locked(keys)
            entries.append((b, 1, None, rows))
            n_rows += int(ln)
        for h in holders:
            self._send_updates(h, entries, stamp, fts=fts)
        self._count("grants", len(bs))
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("serve", "sv_grant",
                       {"blocks": [int(b) for b in bs],
                        "holders": list(holders),
                        "rows": n_rows, "stamp": stamp})

    def _refresh_granted(self) -> None:
        """Delta refresh: ship the rows pushes dirtied since the last
        refresh, and renew EVERY grant's lease/stamp with a
        constant-size ``renew`` marker (per-block renewal entries made
        the per-tick frame O(granted) to build AND to decode under the
        replica's serve lock — with the whole warm working set
        promoted that stall showed up directly in the storm's read
        p99). Stamp read before dirty pop before state read — see the
        module docstring for why that order is the certificate."""
        t = self.table
        stamp = self._stamp()
        with self._ow_lock:
            dirty, self._dirty = self._dirty, {}
            t0s, self._dirty_t0 = self._dirty_t0, {}
            holders_of = {b: self._granted.get(b) for b in dirty}
            all_holders: set[int] = set()
            for hs in self._granted.values():
                all_holders.update(hs)
        per_holder: dict[int, list] = {h: [] for h in all_holders}
        fts_holder: dict[int, float] = {}
        for b, dk in dirty.items():
            holders = holders_of.get(b)
            if not holders or not dk:
                continue
            keys = np.fromiter(sorted(dk), np.int64, len(dk))
            with t._state_lock:
                rows = t._read_rows_locked(keys)
            for h in holders:
                per_holder.setdefault(h, []).append((b, 0, keys, rows))
                self._count("refresh_rows", int(keys.size))
                # oldest contained push across every block this
                # holder's frame ships (note_push stamps first-dirty)
                t0 = t0s.get(b)
                if t0 is not None:
                    fts_holder[h] = min(fts_holder.get(h, t0), t0)
        for h, entries in per_holder.items():
            self._send_updates(h, entries, stamp, renew=True,
                               fts=fts_holder.get(h))
            self._count("refresh_frames")

    def _revoke_blocks(self, bs: list[int]) -> None:
        """Revoke a BATCH of grants — one svR frame per holder however
        many blocks die (the svU batching argument again: frame count
        is what the migration fence's receive threads pay for)."""
        t = self.table
        per_holder: dict[int, list[int]] = {}
        revoked = 0
        with self._ow_lock:
            for b in bs:
                holders = self._granted.pop(b, ())
                self._dirty.pop(b, None)
                self._dirty_t0.pop(b, None)
                if holders:
                    revoked += 1
                    for h in holders:
                        per_holder.setdefault(h, []).append(int(b))
        for h, blocks in per_holder.items():
            t.bus.send(h, f"svR:{t.name}",
                       {"bs": blocks, "ep": t.router.epoch})
        if revoked:
            self._count("revokes", revoked)
            tr = _trc.TRACER
            if tr is not None:
                tr.instant("serve", "sv_revoke",
                           {"blocks": sorted(
                               {b for v in per_holder.values()
                                for b in v})})

    def _broadcast_map(self) -> None:
        t = self.table
        with self._ow_lock:
            bs = sorted(self._granted)
            hs = [list(self._granted[b]) for b in bs]
        t.bus.publish(f"svM:{t.name}",
                      {"bs": [int(b) for b in bs], "hs": hs,
                       "ep": t.router.epoch})

    def on_blocks_moved(self, moved) -> None:
        """The lease/epoch fence: called from ``adopt_table`` (the same
        epoch-fence point the rebalancer uses) with the plan's
        ``(block, src, dst)`` moves — every replica lease I granted on
        a block that just migrated away is revoked, and the shrunken
        map is re-broadcast so clients stop routing there."""
        t = self.table
        with self._ow_lock:
            gone = [int(b) for b, src, _dst in moved
                    if src == t.rank and b in self._granted]
        if gone:
            self._revoke_blocks(gone)
            self._broadcast_map()

    def note_push(self, keys: np.ndarray) -> None:
        """Dirty-row tracking on the push-apply path: keys that touched
        a granted block join its next delta. The no-grants fast path is
        one dict-truthiness check."""
        if not self._granted:  # fast path: dict truthiness, GIL-atomic
            return
        t = self.table
        blocks = t.router.blocks_of(keys)
        with self._ow_lock:  # the training thread grants/demotes
            gb = np.fromiter(self._granted, np.int64,
                             len(self._granted))
        m = np.isin(blocks, gb)
        if not m.any():
            return
        mk, mb = keys[m], blocks[m]
        now = time.monotonic()
        with self._ow_lock:
            for b in np.unique(mb):
                bb = int(b)
                if bb in self._granted:
                    self._dirty.setdefault(bb, set()).update(
                        int(k) for k in mk[mb == b])
                    # first dirtier since the last refresh wins: the
                    # freshness stamp is the OLDEST contained push
                    self._dirty_t0.setdefault(bb, now)

    def note_push_range(self, lo: int, hi: int) -> None:
        if not self._granted:
            return
        self.note_push(np.arange(lo, hi, dtype=np.int64))

    # --------------------------------------------------- owner admission
    def admit_request(self, sender: int, req: int, keys: np.ndarray,
                      payload: dict) -> bool:
        """Token-bucket admission on the wire pull path. True = serve
        normally. False = this request was SHED — an ``svS`` redirect
        (every key's block has a common replica holder ≠ sender) or an
        ``svB`` backpressure refusal already went out; either way the
        requester got an explicit answer, never silence. Retried legs
        (``rt >= 1``) are force-admitted: the retry budget is the
        liveness valve that bounds every shed/refuse loop."""
        if self._rate <= 0:
            return True
        if int(payload.get("rt", 0)) >= 1:
            self._count("forced_admits")
            return True
        if self.bucket.take():
            return True
        t = self.table
        blocks = np.unique(t.router.blocks_of(keys))
        dead = t._excluded_ranks()
        common: Optional[set] = None
        self_common = True  # sender holds every touched block itself
        with self._ow_lock:
            per_block = {}
            for b in blocks:
                hs = set(self._granted.get(int(b), ())) - dead
                self_common &= sender in hs
                # peers first: never shed at a dead holder, and the
                # requester itself only as the loopback fallback below
                per_block[int(b)] = hs - {sender}
        for hs in per_block.values():
            common = hs if common is None else (common & hs)
            if not common:
                break
        tr = _trc.TRACER
        if not common and self_common and getattr(
                t.bus, "supports_loopback", False):
            # no PEER covers the leg, but the REQUESTER holds every
            # touched block (a grant that raced its pull — per-link
            # FIFO means the svU preceded this svS on my link to it, so
            # by the time the redirect lands the snapshot is installed)
            # and its transport can deliver rank→self in process: shed
            # the leg back at the requester — it serves itself with
            # ZERO wire instead of riding the partial/backpressure
            # ladder at the very owner that is refusing load (an svN
            # still falls back here with rt=1, bounded as ever)
            common = {sender}
        # admission decisions into the black box, SAMPLED: during a
        # storm sheds fire at request rate, and one ring entry per
        # denial would rotate the decisions a post-mortem actually
        # needs (term advances, autoscaler actions) out of the bounded
        # ring while taxing the exact path that is already refusing
        # load — so record the first few and then every 64th denial,
        # with the bucket's cumulative denied count carrying the true
        # volume in each sampled entry
        fl = _fl.FLIGHT
        if fl is not None:
            denied = self.bucket.denied  # GIL-read, approximate is fine
            if denied > 4 and denied % 64:
                fl = None
        if common:
            self._count("shed_redirects")
            if tr is not None:
                tr.instant("serve", "sv_shed",
                           {"from": sender, "rid": req,
                            "holders": sorted(common)})
            if fl is not None:
                fl.ev("sv_shed", {"from": sender,
                                  "why": "bucket_empty",
                                  **self.bucket.snapshot()})
            self._tenant_deny("tenant_shed", sender, fl)
            t.bus.send(sender, f"svS:{t.name}",
                       {"req": int(req), "h": sorted(common)})
            return False
        # replica-aware PARTIAL shed (the plane's documented headroom): no
        # single holder covers every block, but one may cover some —
        # redirect that covered half (the client peels it onto an svP
        # leg) and backpressure only the REMAINDER (re-issued without
        # ``rt``, so the owner's admission re-judges it and the no-
        # holder blocks take the bounded svB → delayed-retry path)
        # instead of refusing the whole leg. Every round either peels
        # covered blocks off or ends in svB, so the loop is bounded by
        # the number of distinct holder sets.
        cover: dict[int, list[int]] = {}
        for b, hs in per_block.items():
            for h in hs:
                cover.setdefault(h, []).append(b)
        if cover:
            # the holder covering the most blocks takes its half
            # (rank-ascending tie-break keeps the choice deterministic)
            pick = max(sorted(cover), key=lambda h: len(cover[h]))
            covered = sorted(cover[pick])
            self._count("shed_redirects")
            self._count("shed_partial")
            if tr is not None:
                tr.instant("serve", "sv_shed_partial",
                           {"from": sender, "rid": req, "holder": pick,
                            "blocks": covered})
            if fl is not None:
                fl.ev("sv_shed", {"from": sender, "why": "partial",
                                  "holder": int(pick),
                                  **self.bucket.snapshot()})
            self._tenant_deny("tenant_shed", sender, fl)
            t.bus.send(sender, f"svS:{t.name}",
                       {"req": int(req), "h": [int(pick)],
                        "bs": covered})
        else:
            self._count("backpressure")
            if tr is not None:
                tr.instant("serve", "sv_backpressure",
                           {"from": sender, "rid": req})
            if fl is not None:
                fl.ev("sv_bp", {"from": sender,
                                "retry_ms": self.cfg.retry_ms,
                                **self.bucket.snapshot()})
            self._tenant_deny("tenant_throttle", sender, fl)
            t.bus.send(sender, f"svB:{t.name}",
                       {"req": int(req), "ms": self.cfg.retry_ms})
        return False

    # ------------------------------------------------------------ replica
    def _row_seg_bytes(self, wire: str, blk: int, n: int) -> int:
        t = self.table
        if wire in ("blk8", "blk4"):
            from minips_tpu_torch.ops.quantized_comm import \
                blockwise_stream_bytes

            code_b, scale_b = blockwise_stream_bytes(
                n, t.dim, 8 if wire == "blk8" else 4, max(blk, 1))
            return code_b + scale_b
        if wire == "int8":
            return n * (4 + t.dim)
        return n * 4 * t.dim

    def _on_update(self, sender: int, payload: dict) -> None:
        """Multi-block grant/delta frame: apply each segment to the
        held snapshot (grants install, deltas scatter dirty rows),
        renew the lease, and max-merge the stamp (per-link FIFO keeps
        frames ordered; max is belt-and-braces, like ClockGossip)."""
        t = self.table
        if not t._check_peer_config(sender, payload):
            return
        wire = payload.get("wire", "f32")
        blk = int(payload.get("blk", 0))
        blob = payload.get("__blob__") or b""
        now = time.monotonic()
        exp = now + float(payload.get("lease", self.cfg.lease))
        stamp = int(payload.get("stamp", 0))
        ep = int(payload.get("ep", 0))
        off = 0
        applied = False  # any segment actually installed/scattered
        for b, full, n in zip(payload.get("bs", ()),
                              payload.get("fl", ()),
                              payload.get("ns", ())):
            b, full, n = int(b), int(full), int(n)
            keys = rows = None
            if n:
                if not full:
                    if len(blob) < off + 8 * n:
                        t._drop("malformed", sender, "torn svU frame")
                        return
                    keys = np.frombuffer(blob[off: off + 8 * n],
                                         np.int64)
                    off += 8 * n
                seg = self._row_seg_bytes(wire, blk, n)
                if len(blob) < off + seg:
                    t._drop("malformed", sender, "torn svU frame")
                    return
                rows = self._decode_rows(wire, blk, n,
                                         blob[off: off + seg])
                off += seg
                if rows is None:
                    t._drop("malformed", sender, "bad svU rows")
                    return
            with self._rp_lock:
                if full:
                    lo, ln = t.router.block_span(b)
                    if n != ln or rows is None:
                        t._drop("malformed", sender, "bad svU grant")
                        return
                    self._held[b] = {"rows": rows, "stamp": stamp,
                                     "exp": exp, "ep": ep, "lo": lo,
                                     "src": sender}
                    applied = True
                    continue
                h = self._held.get(b)
                if h is None:
                    # delta for a block I no longer (or never) hold —
                    # a revoke crossed this refresh; benign
                    self._count("orphan_frames")
                    continue
                if n:
                    offs = keys - h["lo"]
                    if offs.size and (
                            offs.min() < 0
                            or offs.max() >= h["rows"].shape[0]):
                        t._drop("malformed", sender,
                                "svU delta out of span")
                        return
                    h["rows"][offs] = rows
                    applied = True
                h["stamp"] = max(h["stamp"], stamp)
                h["exp"] = exp
                h["ep"] = max(h["ep"], ep)
        if payload.get("renew"):
            # constant-size renewal: every block held from this owner
            # advances its lease + stamp (sound: every block the owner
            # saw dirtied since its last refresh ships its delta in
            # THIS frame, applied above before the stamp moves)
            with self._rp_lock:
                for h in self._held.values():
                    if h.get("src") == sender:
                        h["stamp"] = max(h["stamp"], stamp)
                        h["exp"] = exp
        fts = payload.get("fts")
        if fts is not None and applied:
            # push-visible-at-THIS-replica: the contained rows are
            # servable from here on. Measured AFTER the apply, on the
            # replica's monotonic clock (same-host comparability —
            # obs/freshness.py spells out the cross-host limit).
            self.fresh.note_lag(time.monotonic() - float(fts))

    def _on_revoke(self, sender: int, payload: dict) -> None:
        """Only the GRANTING owner may revoke its own grant: a delayed
        svR from a pre-migration owner must not pop the snapshot the
        post-migration owner has since granted (the new owner would
        never re-grant — the block is still in its granted map — and
        the replica would stay dark forever)."""
        with self._rp_lock:
            for b in payload.get("bs", ()):
                h = self._held.get(int(b))
                if h is not None and h.get("src") == sender:
                    self._held.pop(int(b))

    def _on_replica_pull(self, sender: int, payload: dict) -> None:
        """Serve a pull leg from held snapshots — or refuse (``svN``)
        when any touched block is absent/expired or the merged stamp
        cannot admit the requester's clock. No parking here: the owner
        is the one place requests wait."""
        t = self.table
        if not t._check_peer_config(sender, payload):
            return
        req = int(payload.get("req", -1))
        clk = int(payload.get("clk", 0))
        blob = payload.get("__blob__")
        if blob is None:
            t._drop("malformed", sender, "svP without key blob")
            return
        keys = np.frombuffer(blob, np.int64)
        t0 = time.monotonic()
        why = None
        stamp = None
        rows = None
        with self._rp_lock:
            blocks = t.router.blocks_of(keys)
            now = time.monotonic()
            for b in np.unique(blocks):
                h = self._held.get(int(b))
                if h is None:
                    why = "lease"
                    break
                if now > h["exp"]:
                    why = "expired"
                    break
                stamp = h["stamp"] if stamp is None \
                    else min(stamp, h["stamp"])
            if why is None and not admits(
                    stamp if stamp is not None else 0, clk,
                    self._staleness()):
                why = "stale"
            if why is None:
                rows = np.empty((keys.size, t.dim), np.float32)
                for b in np.unique(blocks):
                    h = self._held[int(b)]
                    m = blocks == b
                    rows[m] = h["rows"][keys[m] - h["lo"]]
        tr = _trc.TRACER
        if why is not None:
            self._count("stale_refused" if why == "stale"
                        else "lease_refused")
            if tr is not None:
                tr.instant("serve", "sv_refused",
                           {"from": sender, "rid": req, "why": why})
            t.bus.send(sender, f"svN:{t.name}",
                       {"req": req, "why": why})
            return
        head, rblob = t._reply_head_blob(req, rows)
        head["stamp"] = int(stamp)
        t.bus.send(sender, f"psr:{t.name}", head, blob=rblob)
        self._count("replica_served_requests")
        self._count("replica_served_rows", int(keys.size))
        self.hist_replica.record_s(time.monotonic() - t0)
        if tr is not None:
            tr.flow("f", _trc.flow_id(f"pull:{t.name}", sender, req),
                    "pull")
            tr.complete("serve", "serve_replica", t0,
                        {"from": sender, "rid": req,
                         "rows": int(keys.size), "stamp": int(stamp)})

    def serve_local(self, uniq: np.ndarray, out_u: np.ndarray,
                    need: np.ndarray, clk: int) -> int:
        """The zero-wire replica read: a rank that itself HOLDS a
        replica of a hot block serves those keys from its own snapshot
        — no leg, no frame, no queueing at anyone's receive thread.
        This is where replica fan-out actually converts to read
        throughput on a frame-cost-bound host (a wire leg to a peer
        replica merely moves the serve; a local hit deletes it). Same
        admission as the wire path: a key is served only when its
        block's lease is live and ``admits(stamp, clk, s)`` — refused
        keys simply stay in ``need`` and ride the wire to their owner.
        Mutates ``out_u``/``need`` in place; returns rows served."""
        if self._stopped or not self._held:
            return 0
        t = self.table
        s = self._staleness()
        blocks = t.router.blocks_of(uniq)
        served = 0
        with self._rp_lock:
            now = time.monotonic()
            for b in np.unique(blocks[need]):
                h = self._held.get(int(b))
                if h is None or now > h["exp"] \
                        or not admits(h["stamp"], clk, s):
                    continue
                mask = need & (blocks == b)
                out_u[mask] = h["rows"][uniq[mask] - h["lo"]]
                need[mask] = False
                served += int(mask.sum())
        if served:
            self._count("replica_local_rows", served)
        return served

    def held_blocks(self) -> int:
        with self._rp_lock:
            return len(self._held)

    # ------------------------------------------------------------- client
    def _on_map(self, sender: int, payload: dict) -> None:
        bs = payload.get("bs", ())
        hs = payload.get("hs", ())
        with self._cl_lock:
            self._maps[sender] = {
                int(b): tuple(int(x) for x in h)
                for b, h in zip(bs, hs)}
            merged: dict[int, tuple[int, ...]] = {}
            for per in self._maps.values():
                merged.update(per)
            self._merged = merged  # wholesale swap: lock-free readers

    def route_targets(self, uniq: np.ndarray, owners: np.ndarray,
                      need: np.ndarray) -> tuple[np.ndarray,
                                                 Optional[np.ndarray]]:
        """Client-side replica fan-out: keys in a replicated block may
        route to one of its holders instead of the owner, round-robin
        over ``{owner} ∪ holders`` so the owner keeps its share. Keys
        the local shard owns are never redirected (``need`` already
        excludes them). Returns ``(targets, replica_mask)``;
        ``replica_mask`` is None when nothing rerouted."""
        m = self._merged
        if not m:
            return owners, None
        t = self.table
        blocks = t.router.blocks_of(uniq)
        targets = owners
        rep: Optional[np.ndarray] = None
        # ONE pick per distinct holder set per pull (owners grant all
        # their hot blocks to one holder set, so this is usually one
        # pick total): every replicated key of that set rides the SAME
        # replica leg — per-block picks would fragment a pull into one
        # leg per block, and leg count is the loopback storm's real
        # cost. The owner keeps a 1/(1+holders) share of the rotation.
        by_holders: dict[tuple[int, ...], list[int]] = {}
        for b in np.unique(blocks[need]):
            holders = m.get(int(b))
            if holders:
                by_holders.setdefault(holders, []).append(int(b))
        dead = t._excluded_ranks()
        for holders, bs in by_holders.items():
            if t.rank in holders:
                # I hold these blocks myself: any key still in `need`
                # is one my OWN snapshot just declined (stale/expired)
                # — a sibling replica's stamp comes from the same owner
                # refresh, so wiring it there buys a guaranteed svN +
                # fallback (three hops); go straight to the owner
                continue
            # never route a read at a monitor-dead holder: the owner
            # can still serve; a dead-leg pull would ride the deadline
            cands = [h for h in holders if h not in dead]
            if not cands:
                continue
            self._rr += 1
            pick = ([None] + cands)[self._rr % (1 + len(cands))]
            if pick is None:
                continue  # the owner's round-robin share
            mask = need & np.isin(blocks, np.asarray(bs, np.int64)) \
                & (owners != pick)
            if not mask.any():
                continue
            if rep is None:
                targets = owners.copy()
                rep = np.zeros(uniq.size, bool)
            targets[mask] = pick
            rep[mask] = True
            self._count("replica_rows_routed", int(mask.sum()))
        return targets, rep

    def hedge_holder(self, keys: np.ndarray,
                     exclude: set[int]) -> Optional[int]:
        """A live replica holder covering EVERY block ``keys`` touch —
        the hedged pull leg's re-issue target (serve/hedge.py). The
        hedge re-sends one leg verbatim, so one holder must cover the
        whole slice (owners grant all their hot blocks to one holder
        set, so a slow owner's hot legs usually find one); ``exclude``
        carries the slow owner (hedging back at the sick rank buys
        nothing) and the requester itself (its own snapshot already
        declined these keys at issue — ``serve_local``). Monitor-dead
        ranks are excluded like every other read route. None = no
        second copy exists: the honest no-replica limit, counted by
        the caller."""
        m = self._merged
        if not m:
            return None
        t = self.table
        common: Optional[set] = None
        for b in np.unique(t.router.blocks_of(keys)):
            hs = set(m.get(int(b), ()))
            common = hs if common is None else (common & hs)
            if not common:
                return None
        if common is None:
            return None
        cands = sorted(common - set(exclude) - t._excluded_ranks())
        if not cands:
            return None
        self._rr += 1
        return cands[self._rr % len(cands)]

    def _plan_by_owner(self, keys: np.ndarray, rt: int) -> list:
        t = self.table
        owners = t._owners_of(keys)
        return [(int(o), "psG", {"rt": int(rt)}, owners == o)
                for o in np.unique(owners)]

    def _on_replica_refused(self, sender: int, payload: dict) -> None:
        """svN: the replica cannot serve this leg (lease gone, lease
        expired, or snapshot too stale for my clock) — fall back to the
        owner(s) with ``rt=1`` so the owner's admission cannot bounce
        it back into the same loop."""
        self._count("replica_fallbacks")
        self.table._resend_leg(
            int(payload.get("req", -1)),
            lambda keys: self._plan_by_owner(keys, 1))

    def _on_shed(self, sender: int, payload: dict) -> None:
        """svS: the owner shed my leg — re-issue it against one of the
        replica holders it named (falling back to the owner with
        ``rt=1`` if none is usable from here). A PARTIAL shed carries
        ``bs``, the blocks the named holder covers: only those keys
        ride the svP leg; the remainder re-issues to its owners
        WITHOUT ``rt`` — the admission bucket judges it again, so only
        the uncovered half feels the backpressure."""
        self._count("shed_redirected_legs")
        t = self.table
        named = [int(h) for h in payload.get("h", ())]
        cands = [h for h in named if h != t.rank]
        rid = int(payload.get("req", -1))
        if t.rank in named and getattr(t.bus, "supports_loopback",
                                       False):
            # the owner shed my leg at a holder set that includes ME:
            # on a loopback-capable transport (shm) the svP leg rides
            # rank→self in process — the replica serve costs zero wire
            # instead of a forced-admit fallback hop at the very owner
            # that just shed us (the local-replica transport win the
            # shm ring's loopback lane exists for; an svN still falls
            # back to the owner with rt=1, bounded as ever)
            self._count("shed_local_legs")
            pick = t.rank
        elif not cands:
            t._resend_leg(
                rid, lambda keys: self._plan_by_owner(keys, 1))
            return
        else:
            self._rr += 1
            pick = cands[self._rr % len(cands)]
        bs = payload.get("bs")
        if bs is None:  # full-coverage shed: the whole leg rides svP
            self.table._resend_leg(
                rid, lambda keys: [(pick, "svP", {},
                                    np.ones(keys.size, bool))])
            return
        t = self.table
        cov = np.asarray([int(b) for b in bs], np.int64)

        def plan(keys: np.ndarray) -> list:
            m = np.isin(t.router.blocks_of(keys), cov)
            entries: list = [(pick, "svP", {}, m)]
            rem = ~m
            if rem.any():
                owners = t._owners_of(keys)
                entries += [(int(o), "psG", {}, rem & (owners == o))
                            for o in np.unique(owners[rem])]
            return entries

        self.table._resend_leg(rid, plan)

    def _on_backpressure(self, sender: int, payload: dict) -> None:
        """svB: explicit refuse-with-retry — schedule the leg's re-issue
        after the owner's suggested backoff (a one-shot timer; the
        handler itself runs on the bus receive thread and must not
        sleep). The retried leg carries ``rt=1`` → force-admitted."""
        self._count("backpressure_waits")
        rid = int(payload.get("req", -1))
        delay = max(float(payload.get("ms", self.cfg.retry_ms)), 0.0) \
            / 1000.0

        def later() -> None:
            try:
                self.table._resend_leg(
                    rid, lambda keys: self._plan_by_owner(keys, 1))
            except Exception:  # noqa: BLE001 - post-close timer fire
                pass
        tm = threading.Timer(delay, later)
        tm.daemon = True
        tm.start()

    def check_reply_stamp(self, stamp: int, clk: int) -> None:
        """The SERVE-STALE observable: every consumed pull reply —
        owner- or replica-served — must satisfy the admission rule its
        serve claimed. A nonzero counter is a protocol bug, never load."""
        if not admits(stamp, clk, self._staleness()):
            self._count("stale_reads")
            t = self.table
            if t._tenant_tid:
                with t._serve_lock:
                    t.tenant_counters["stale_reads"] += 1

    def quiesce(self) -> None:
        """Finalize-time: stop granting/refreshing and stop ROUTING to
        replicas (post-finalize agreement is exact, not
        staleness-bounded — my own pulls must go to owners). Held
        snapshots stay but go dark via lease expiry; no revoke frames
        race the shutdown barrier."""
        self._stopped = True
        with self._cl_lock:
            self._maps.clear()
            self._merged = {}

    def load_signal(self) -> dict:
        """The autoscaler's per-rank load export (balance/autoscaler.py):
        CUMULATIVE admission-pressure counters, shipped to the lease
        holder inside the rbH heat report every clock. Cumulative on
        purpose — the reader diffs consecutive observations, so a
        report tick lost to scheduling never loses a shed; and sheds
        (not raw request counts) are the signal because a shed is the
        admission layer itself saying this owner is past capacity."""
        with self._cnt_lock:
            c = self.counters
            return {"shed": int(c["shed_redirects"] + c["shed_partial"]
                                + c["backpressure"]),
                    "bp": int(c["backpressure"]),
                    "redirects": int(c["shed_redirects"])}

    def stats(self) -> dict:
        with self._cnt_lock:
            out = dict(self.counters)
        with self._ow_lock:
            out["granted_blocks"] = len(self._granted)
        out["held_blocks"] = self.held_blocks()
        out["admission"] = self.bucket.snapshot() if self._rate > 0 \
            else None
        return out


class ServePlane:
    """Trainer-level driver: binds a ``TableServeState`` to every table,
    runs promotion/refresh at the clock boundary, and rolls the
    done-line ``serve.replica`` record up (counters + the SLO gate over
    the always-on pull-latency histograms)."""

    def __init__(self, trainer, cfg: ServeConfig):
        self.trainer = trainer
        self.cfg = cfg
        # tenancy ``shared=1`` (tenant/registry.py): ONE fleet-wide
        # admission bucket every table draws from — the deliberately
        # coupled contrast arm (a storming tenant drains the tokens a
        # quiet tenant's requests needed); None = per-table buckets,
        # the isolation default
        reg = getattr(trainer, "tenant_registry", None)
        self.shared_bucket = (TokenBucket(cfg.rate, cfg.burst)
                              if reg is not None and reg.shared
                              else None)
        for t in trainer.tables.values():
            t.attach_serve_plane(self, cfg)

    def on_tick(self) -> None:
        # the serve plane owns heat decay only when the rebalancer is
        # not also armed (Rebalancer.on_tick decays it otherwise —
        # double decay would halve every heat reading)
        tick_heat = self.trainer.rebalancer is None
        for t in self.trainer.tables.values():
            if t._sv is not None:
                t._sv.on_tick(tick_heat=tick_heat)

    def quiesce(self) -> None:
        for t in self.trainer.tables.values():
            if t._sv is not None:
                t._sv.quiesce()

    def slo_record(self) -> Optional[dict]:
        if self.cfg.slo_p99_ms <= 0:
            return None
        counts = merge_counts(
            [t.timers.snapshot()["hists"]["pull_latency"]
             for t in self.trainer.tables.values()])
        return slo_check(counts, self.cfg.slo_p99_ms)

    def stats_record(self) -> dict:
        """The ``serve.replica`` done-line block (None when the plane is
        off — the trainer handles that; all-zero counters = armed but
        idle, the obs convention)."""
        per = [t._sv.stats() for t in self.trainer.tables.values()
               if t._sv is not None]
        out = {k: sum(s[k] for s in per) for k in _COUNTERS}
        out["granted_blocks"] = sum(s["granted_blocks"] for s in per)
        out["held_blocks"] = sum(s["held_blocks"] for s in per)
        adm = [s["admission"] for s in per if s["admission"]]
        out["admission"] = ({"admitted": sum(a["admitted"] for a in adm),
                             "denied": sum(a["denied"] for a in adm)}
                            if adm else None)
        out["slo"] = self.slo_record()
        return out
