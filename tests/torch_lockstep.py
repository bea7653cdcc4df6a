"""The in-process lockstep drills on the port alone: copies of
``tests/test_chaos_reliable.py``'s ``run_bsp_lockstep`` (2 ranks, BSP,
any bus, armed-idle layers, or the mesh plane) and ``tests/test_hier.py``'s
``run_hier_lockstep`` (3 ranks, host groups {0, 1} | {2}).

``minips_tpu_torch/apps/sharded_ps_bench.py`` runs its bitwise drills
through these, so this file imports nothing of the JAX package (the
reference files import it at the top). ``tests/test_torch_mesh_plane.py``
holds each copy to the reference harness run on the port (``port_drills``):
the same final shard states.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from minips_tpu_torch.balance.hier import HierConfig
from minips_tpu_torch.comm.bus import make_bus
from minips_tpu_torch.consistency.gate import RETIRED_CLOCK
from minips_tpu_torch.launch import find_free_base_port
from minips_tpu_torch.train.sharded_ps import ShardedTable


def loopback_buses(n, backend="zmq", settle=0.25, **bus_kw):
    """``tests/conftest.py``'s ``mk_loopback_buses`` on the port's
    ``make_bus``: ``n`` started nodes on an OS-assigned port block."""
    base = find_free_base_port(n)
    addrs = [f"tcp://127.0.0.1:{base + i}" for i in range(n)]
    buses = [make_bus(addrs[i], [a for j, a in enumerate(addrs) if j != i],
                      my_id=i, backend=backend, **bus_kw)
             for i in range(n)]
    for b in buses:
        b.start()
    time.sleep(settle)  # PUB/SUB slow-joiner settle
    return buses


class _LockstepCons:
    """Shared lockstep clock vector (BSP: s = 0) for 2 or 3 ranks."""

    clocks = [0, 0]
    staleness = 0

    def __init__(self, rank):
        self.rank = rank

    @property
    def clock(self):
        return self.clocks[self.rank]

    def admit_pull(self, clk):
        return min(self.clocks) >= clk

    def serving_clock(self, requester):
        return min(self.clocks)


def run_bsp_lockstep(backend: str = "zmq", chaos: str = "",
                     reliable: str = "", hedge: str = "",
                     tenant: str = "", traffic: str = "",
                     stats: "dict | None" = None, mesh_devices=None):
    """2-rank in-proc BSP lockstep run -> (final weights per rank,
    frames_lost per rank). Identical frame streams must produce
    identical state whatever transport or fault layer carried them;
    ``backend="mesh"`` runs the same loop on the in-mesh collective
    plane (on ``mesh_devices``, else the plane's default devices) and
    returns the per-rank owner-shard views."""
    if backend == "mesh":
        return _run_bsp_lockstep_mesh(mesh_devices)
    buses = loopback_buses(2, backend=backend, chaos=chaos,
                           reliable=reliable)
    tables = [ShardedTable("t", 64, 2, buses[i], i, 2, updater="sgd",
                           lr=0.5, pull_timeout=20.0)
              for i in range(2)]
    _LockstepCons.clocks = [0, 0]
    if tenant:
        # TENANT-IDLE arm: the bare default registry stamps every frame
        # and overrides nothing
        from minips_tpu_torch.tenant.registry import TenantRegistry

        regs = [TenantRegistry.parse(tenant) for _ in range(2)]
        for i, t in enumerate(tables):
            regs[i].bind({"t": t})
            t.attach_tenant(regs[i].spec_for("t"))
    for i, t in enumerate(tables):
        t.bind_consistency(_LockstepCons(i))
        if hedge:
            # SLOW-IDLE arm: hedging armed with no slow link
            from minips_tpu_torch.serve.hedge import HedgeConfig

            t.attach_hedge(HedgeConfig.parse(hedge))
        t._w[...] = np.arange(32 * 2, dtype=np.float32
                              ).reshape(32, 2) / 7.0
    driver = None
    if traffic:
        # TRAFFIC-IDLE arm: the open-loop driver armed at rate 0 against
        # rank 0's serving read issues nothing
        from minips_tpu_torch.apps.traffic_driver import (TrafficConfig,
                                                          TrafficDriver)

        tcfg = TrafficConfig.parse(traffic)
        assert tcfg is not None, "TRAFFIC-IDLE arm needs an armed spec"
        driver = TrafficDriver(tcfg, tables[0].pull_serving, 64,
                               duration_s=5.0)
        driver.start()
    # disjoint cross-shard keys: each shard receives pushes from exactly
    # one peer, so per-link in-order delivery fixes the apply order
    keysets = [np.array([33, 40, 33, 47]), np.array([1, 8, 1, 15])]
    try:
        for _ in range(4):
            rows = [tables[r].pull(keysets[r]) for r in (0, 1)]
            for r in (0, 1):
                tables[r].push(keysets[r], 0.1 * rows[r] + 1.0)
            for r in (0, 1):  # read-your-own-writes, same frame
                tables[r].pull(keysets[r])
            _LockstepCons.clocks[0] += 1
            _LockstepCons.clocks[1] += 1
        lost = [b.frames_lost for b in buses]
        if driver is not None:
            driver.stop()
            if stats is not None:
                stats["traffic_requests"] = (
                    driver.counters["requests"]
                    + driver.counters["errors"])
                stats["traffic_scheduled"] = len(driver.arrivals)
        if stats is not None:
            stats["hedges_fired"] = sum(
                t.hedge_counters["fired"] for t in tables)
            stats["tenant_tids"] = [t._tenant_tid for t in tables]
            stats["tenant_counters"] = sum(
                sum(t.tenant_counters.values()) for t in tables)
        return [t._w.copy() for t in tables], lost
    finally:
        if driver is not None:
            driver.stop()
        for b in buses:
            b.close()


def _run_bsp_lockstep_mesh(devices=None):
    """The mesh half of the lockstep drill: the same workload, keysets,
    lr and initial table as the wire run, through the collective plane."""
    from minips_tpu_torch.train.mesh_plane import MeshPlane

    plane = MeshPlane(2, staleness=0, devices=devices)
    t = plane.add_table("t", 64, 2, updater="sgd", lr=0.5)
    w0 = (np.arange(32 * 2, dtype=np.float32) / 7.0).reshape(32, 2)
    # the wire drill initializes each rank's LOCAL shard to the same
    # pattern — the global table is that pattern twice
    t.load_dense(np.concatenate([w0, w0]))
    ranks = [plane.rank(0), plane.rank(1)]
    keysets = [np.array([33, 40, 33, 47]), np.array([1, 8, 1, 15])]
    for _ in range(4):
        rows = [ranks[r].tables["t"].pull(keysets[r]) for r in (0, 1)]
        for r in (0, 1):
            ranks[r].tables["t"].push(keysets[r], 0.1 * rows[r] + 1.0)
        for r in (0, 1):  # read-your-own-writes, same step
            ranks[r].tables["t"].pull(keysets[r])
        for r in (0, 1):  # single-threaded driver: gate at pull instead
            ranks[r].tick(wait=False)
    return [t.shard_slice(0), t.shard_slice(1)], [0, 0]


def _mk_tables(buses, name, hier_spec=""):
    _LockstepCons.clocks = [0, 0, 0]
    tables = [ShardedTable(name, 96, 2, buses[i], i, 3, updater="sgd",
                           lr=0.5, pull_timeout=20.0)
              for i in range(3)]
    for i, t in enumerate(tables):
        t.bind_consistency(_LockstepCons(i))
        if hier_spec:
            t.attach_hier(HierConfig.parse(hier_spec))
        t._w[...] = np.arange(32 * 2, dtype=np.float32
                              ).reshape(32, 2) / 7.0
    return tables


def run_hier_lockstep(hier_spec: str, stats: "dict | None" = None):
    """3-rank in-proc BSP lockstep with host groups {0,1} and {2}: ranks
    0 and 1 push disjoint key sets into rank 2's shard (the cross-group
    tree lane; rank 0 leads, rank 1 contributes over psH), rank 2 pushes
    flat into shards 0 and 1. Every shard's rows are touched by exactly
    one pusher, so apply order commutes bitwise. Returns (final weights
    per rank, frames_lost per rank)."""
    buses = loopback_buses(3)
    keysets = [np.array([65, 70, 65, 79]),   # rank0 -> owner2 rows
               np.array([72, 80, 72, 88]),   # rank1 -> owner2, disjoint
               np.array([1, 40, 1, 50])]     # rank2 -> owners 0 and 1
    try:
        tables = _mk_tables(buses, "t", hier_spec)
        for _ in range(4):
            rows = [tables[r].pull(keysets[r]) for r in range(3)]
            for r in range(3):
                tables[r].push(keysets[r], 0.1 * rows[r] + 1.0)
            for r in range(3):   # read-your-own-writes, same step
                tables[r].pull(keysets[r])
            for r in range(3):   # the trainer-tick boundary slot
                tables[r].hier_boundary()
            for r in range(3):
                _LockstepCons.clocks[r] += 1
        # quiesce the tree exactly like trainer finalize: member and
        # leader rendezvous, so run concurrently
        ths = [threading.Thread(target=tables[r].hier_finalize,
                                args=(15.0,)) for r in range(3)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30.0)
        assert not any(th.is_alive() for th in ths), "finalize wedged"
        if hier_spec and HierConfig.parse(hier_spec).group > 1 \
                and HierConfig.parse(hier_spec).agg:
            # settle: the owner's floors hit RETIRED only AFTER the
            # last aggregated frame applied (same handler, in order)
            deadline = time.monotonic() + 10.0
            while tables[2]._hier_floor_min() != RETIRED_CLOCK:
                assert time.monotonic() < deadline, \
                    tables[2]._hier_floor
                time.sleep(0.005)
        if stats is not None:
            for key in ("l1_tx_bytes", "l2_tx_bytes", "l1_frames",
                        "l2_frames", "agg_frames", "contribs",
                        "mesh_reduces", "mesh_agg_fallbacks",
                        "domain_demotions"):
                stats[key] = sum(t.hier_counters[key] for t in tables)
        lost = [b.frames_lost for b in buses]
        return [t._w.copy() for t in tables], lost
    finally:
        for b in buses:
            b.close()
