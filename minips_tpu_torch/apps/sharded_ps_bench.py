"""Sharded-PS throughput worker — measures the multi-process PS itself.
A port of ``minips_tpu/apps/sharded_ps_bench.py``: the same flags, arms,
drills and done lines, so one sweep driver can run either package's
worker.

The correctness smokes (tests/test_sharded_ps.py) prove the key-range-
sharded server's semantics; this worker measures its THROUGHPUT: rows/sec
and wire-bytes/sec of the pull→push cycle, per process, with the model
math stripped out so the number isolates routing + serialization + bus +
server-side updater (the reference's Mailbox/ServerThread hot path,
SURVEY.md §3.3 hot spots b+c). Driven by bench_sharded_ps.py across world
sizes and bus backends; one rank standalone (no launcher) measures the
pure in-process server apply as the zero-wire baseline.

Two paths, matching the table's two wire formats:
- ``sparse``: per-iter random key batch → ``pull(keys)`` + ``push(keys,
  grads)`` — per-owner key-slice frames (the W&D/Criteo pattern).
- ``dense``: ``pull_all()`` + ``push_dense(grad)`` — contiguous range
  frames, no key lists (the LR weight-vector pattern).

Consistency is ASP (never gates) so the measurement is the PS data path,
not the staleness rule. Emits ONE JSON line per rank (launcher protocol).

``--plane mesh`` measures the in-mesh collective plane
(``train/mesh_plane.py``) instead: one process, ``--mesh-ranks`` logical
ranks as threads over ``--mesh-devices`` (default: the visible cards, or
the CPU under ``MINIPS_FORCE_CPU``)::

    MINIPS_FORCE_CPU=1 python -m minips_tpu_torch.apps.sharded_ps_bench \
        --plane mesh
    python -m minips_tpu_torch.apps.sharded_ps_bench --plane mesh \
        --mesh-devices cuda:0        # 3 ranks on one card

``--compute jit`` keeps the reference's spelling: the two-layer
row-gradient step runs by autograd on the rank's device
(``apps/common.py:multiproc_device``), and the done line's ``compute``
names that device's type. The drills run the port-only copies of the
lockstep harnesses in ``tests/torch_lockstep.py`` (a source checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from typing import Optional

import numpy as np


def _arm_mesh_devices(n: int, spec: Optional[str] = None):
    """The mesh plane's device list: ``spec`` (``--mesh-devices``, a comma
    list; one entry stands for that device ``n`` times), else ``[cpu] *
    n`` under ``MINIPS_FORCE_CPU``, else None (the plane's default: the
    visible cards, refused when fewer than ``n``)."""
    if spec:
        devs = [d.strip() for d in spec.split(",") if d.strip()]
        return devs * n if len(devs) == 1 else devs
    if os.environ.get("MINIPS_FORCE_CPU", "").strip() not in ("", "0"):
        return ["cpu"] * n
    return None


def _lockstep():
    """``tests/torch_lockstep.py`` of the source checkout this package
    sits in, loaded from its path (another installed ``tests`` package
    can shadow the checkout's; a tests-less install reports the missing
    file through the drill's stamp)."""
    import importlib.util

    import minips_tpu_torch

    name = "minips_torch_lockstep"
    if name not in sys.modules:
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(minips_tpu_torch.__file__)))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(repo, "tests", "torch_lockstep.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def _run_mesh_drill(devices=None) -> int:
    """MESH-BITWISE: the BSP lockstep drill (tests/torch_lockstep.
    run_bsp_lockstep) on the zmq wire vs the mesh plane on ``devices`` —
    the bench artifact's bitwise stamp. Emits one JSON line; any failure
    reports ``bitwise_equal: false`` so the CI gate fails loudly instead
    of silently skipping the check."""
    out = {"event": "drill", "bitwise_equal": False, "rows_checked": 0}
    try:
        run_bsp_lockstep = _lockstep().run_bsp_lockstep
        w_wire, lost = run_bsp_lockstep(backend="zmq")
        w_mesh, _ = run_bsp_lockstep(backend="mesh", mesh_devices=devices)
        eq = all(np.array_equal(a, b) for a, b in zip(w_wire, w_mesh))
        out.update({
            "bitwise_equal": bool(eq) and lost == [0, 0],
            "rows_checked": int(sum(a.shape[0] for a in w_wire)),
        })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


def _run_fail_slow_idle_drill() -> int:
    """SLOW-IDLE: the BSP lockstep drill with the fail-slow hedge
    plane ARMED on a clean wire vs off — armed-but-idle must be
    BITWISE equal (no slow link → the min_ms floor keeps every leg
    unhedged → the armed bookkeeping perturbs nothing). Emits one JSON
    line; failures report ``bitwise_equal: false`` so the CI gate
    fails loudly instead of silently skipping."""
    out = {"event": "drill", "bitwise_equal": False, "rows_checked": 0,
           "hedges_fired": None}
    try:
        run_bsp_lockstep = _lockstep().run_bsp_lockstep

        w_off, lost_off = run_bsp_lockstep(backend="zmq")
        st: dict = {}
        w_on, lost_on = run_bsp_lockstep(backend="zmq", hedge="1",
                                         stats=st)
        eq = all(np.array_equal(a, b) for a, b in zip(w_off, w_on))
        out.update({
            "bitwise_equal": bool(eq) and lost_off == lost_on == [0, 0],
            "rows_checked": int(sum(a.shape[0] for a in w_off)),
            # armed-IDLE means zero hedges actually fired — stamp the
            # evidence, not just the bitwise verdict
            "hedges_fired": st.get("hedges_fired"),
        })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


def _run_tenant_idle_drill() -> int:
    """TENANT-IDLE: the BSP lockstep drill with the bare default
    tenant ARMED (``MINIPS_TENANT=1``) vs off — armed-but-idle must be
    BITWISE equal (the ``tb`` config stamp is the only armed cost;
    no override ⇒ no behavior change) with the stamp provably engaged
    (nonzero tenant ids) and zero attributed tenant counters. Emits
    one JSON stamp line; failures report ``bitwise_equal: false`` so
    the CI gate fails loudly instead of silently skipping."""
    out = {"event": "drill", "bitwise_equal": False, "rows_checked": 0,
           "tenant_tids": None, "tenant_counters": None}
    try:
        run_bsp_lockstep = _lockstep().run_bsp_lockstep

        w_off, lost_off = run_bsp_lockstep(backend="zmq")
        st: dict = {}
        w_on, lost_on = run_bsp_lockstep(backend="zmq", tenant="1",
                                         stats=st)
        eq = all(np.array_equal(a, b) for a, b in zip(w_off, w_on))
        out.update({
            "bitwise_equal": bool(eq) and lost_off == lost_on == [0, 0]
            and st.get("tenant_tids") == [1, 1]
            and st.get("tenant_counters") == 0,
            "rows_checked": int(sum(a.shape[0] for a in w_off)),
            # evidence the armed arm really armed (tids engaged) and
            # really idled (zero attributed counters) — the gate
            # checks the stamps, not just the verdict
            "tenant_tids": st.get("tenant_tids"),
            "tenant_counters": st.get("tenant_counters"),
        })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


def _run_traffic_idle_drill() -> int:
    """TRAFFIC-IDLE: the BSP lockstep drill with the open-loop traffic
    driver ARMED at rate=0 vs off — armed-but-idle must be BITWISE
    equal (an empty schedule issues nothing; the dispatcher threads
    start, find no arrivals, and exit) with the stamp provably engaged
    (driver constructed and started) and zero issued requests. Emits
    one JSON stamp line; failures report ``bitwise_equal: false`` so
    the CI gate fails loudly instead of silently skipping."""
    out = {"event": "drill", "bitwise_equal": False, "rows_checked": 0,
           "traffic_requests": None, "traffic_scheduled": None}
    try:
        run_bsp_lockstep = _lockstep().run_bsp_lockstep

        w_off, lost_off = run_bsp_lockstep(backend="zmq")
        st: dict = {}
        w_on, lost_on = run_bsp_lockstep(
            backend="zmq", traffic="rate=0,users=1000000", stats=st)
        eq = all(np.array_equal(a, b) for a, b in zip(w_off, w_on))
        out.update({
            "bitwise_equal": bool(eq) and lost_off == lost_on == [0, 0]
            and st.get("traffic_requests") == 0
            and st.get("traffic_scheduled") == 0,
            "rows_checked": int(sum(a.shape[0] for a in w_off)),
            # evidence the armed arm really armed (the driver ran) and
            # really idled (zero scheduled arrivals, zero issued) —
            # the gate checks the stamps, not just the verdict
            "traffic_requests": st.get("traffic_requests"),
            "traffic_scheduled": st.get("traffic_scheduled"),
        })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


def _run_reshard_mem_drill() -> int:
    """RESHARD-MEM: the streaming N->M checkpoint reshard (mover (c),
    ckpt/elastic.reshard_table_state) at a RAM-visible table size —
    the capped read must assemble BITWISE the same new shard as the
    uncapped read while its MEASURED peak transient staging stays
    under the cap, and the legacy whole-member read (what restore did
    before the planner: np.load materialises every leaf of every
    touched old shard at once) must provably EXCEED that cap at the
    same size. 2 old shards of ~12 MiB state each, cap 1 MiB, new
    world 3 ranks — the drilled shard is the middle one, straddling
    both sources. Emits one JSON stamp line; any failure reports
    ``bitwise_equal: false`` so the CI gate fails loudly instead of
    silently skipping."""
    import tempfile

    out = {"event": "drill", "bitwise_equal": False, "cap": 0,
           "peak_planned": None, "peak_p2p": None, "chunks": 0}
    try:
        from minips_tpu_torch.ckpt.elastic import (NpzSliceReader,
                                             _shard_path,
                                             reshard_table_state)

        rows, dim, old_n, new_n = 12288, 256, 2, 3
        cap = 1 << 20                    # 1 MiB staging budget
        rng = np.random.default_rng(20260807)
        with tempfile.TemporaryDirectory() as ck:
            old_sz = -(-rows // old_n)
            for r in range(old_n):
                path = _shard_path(ck, 1, r, "t")
                os.makedirs(os.path.dirname(path))
                np.savez(path,
                         w=rng.standard_normal(
                             (old_sz, dim)).astype(np.float32),
                         acc=rng.standard_normal(
                             (old_sz, dim)).astype(np.float32),
                         lo=np.asarray(r * old_sz))
            new_sz = -(-rows // new_n)
            lo = new_sz                  # shard 1 of 3: both sources
            full = reshard_table_state(ck, 1, old_n, "t", rows,
                                       lo, new_sz)
            st: dict = {}
            capped = reshard_table_state(ck, 1, old_n, "t", rows,
                                         lo, new_sz, cap_bytes=cap,
                                         stats=st)
            eq = set(full) == set(capped) and all(
                np.array_equal(full[k], capped[k]) for k in full)
            # the legacy baseline, MEASURED not modelled: whole-member
            # staging materialises every row-aligned leaf of an old
            # shard at once — its peak is one shard's full state bytes
            peak_p2p = 0
            for r in range(old_n):
                with NpzSliceReader(_shard_path(ck, 1, r, "t")) as rd:
                    peak_p2p = max(peak_p2p, sum(
                        int(rd.read(k).nbytes) for k in rd.keys()
                        if k != "lo"))
            out.update({
                "bitwise_equal": bool(eq),
                "cap": int(cap),
                "peak_planned": int(st.get("peak_stage_bytes", 0)),
                "peak_p2p": int(peak_p2p),
                "chunks": int(st.get("chunks", 0)),
                "rows": rows, "dim": dim,
                "old_n": old_n, "new_n": new_n,
            })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    ok = (out["bitwise_equal"]
          and out["peak_planned"] is not None
          and 0 < out["peak_planned"] <= out["cap"]
          and out["peak_p2p"] is not None
          and out["peak_p2p"] > out["cap"])
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def _run_hier_drill(hier_spec: str) -> int:
    """HIER-IDLE / HIER-WIN bitwise leg: the 3-rank hier lockstep drill
    (tests/torch_lockstep.run_hier_lockstep — host groups {0,1} | {2},
    disjoint keysets, exact f32 wire) with ``hier_spec`` armed vs off.
    Armed-idle (``"1"``) and the full tree (``"group=2"``) must BOTH be
    bitwise equal to off: the tree re-lanes identical exact
    contributions, it never changes the math. Emits one JSON stamp
    line; failures report ``bitwise_equal: false`` so the CI gate fails
    loudly instead of silently skipping."""
    out = {"event": "drill", "hier_spec": hier_spec,
           "bitwise_equal": False, "rows_checked": 0,
           "agg_frames": None, "l2_frames": None,
           "mesh_reduces": None, "mesh_agg_fallbacks": None,
           "domain_demotions": None}
    try:
        run_hier_lockstep = _lockstep().run_hier_lockstep

        w_off, lost_off = run_hier_lockstep("")
        st: dict = {}
        w_on, lost_on = run_hier_lockstep(hier_spec, stats=st)
        eq = all(np.array_equal(a, b) for a, b in zip(w_off, w_on))
        out.update({
            "bitwise_equal": bool(eq)
            and lost_off == lost_on == [0, 0, 0],
            "rows_checked": int(sum(a.shape[0] for a in w_off)),
            # evidence the armed lane really ran (or really idled):
            # the gate checks the counters, not just the verdict
            "agg_frames": st.get("agg_frames"),
            "l2_frames": st.get("l2_frames"),
            # the hybrid (agg=mesh) drills add the backend's counters:
            # the degenerate drill must show reduces with ZERO
            # fallbacks/demotions, the idle drill all-zero
            "mesh_reduces": st.get("mesh_reduces"),
            "mesh_agg_fallbacks": st.get("mesh_agg_fallbacks"),
            "domain_demotions": st.get("domain_demotions"),
        })
    except Exception as e:  # noqa: BLE001 - the gate reads the stamp
        out["error"] = repr(e)[:300]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


def _run_tenant_bench(args) -> int:
    """TENANT-ISO bench mode: TWO tables = two tenants in ONE job —
    ``trn`` (every rank runs the sparse pull→push training cycle at
    the ``--trn-step-ms`` deadline pace; its pace-kept rows/sec is
    THE protected number) and ``inf`` (per-rank
    storm reader threads free-run ``pull_serving`` with the shared
    zipf hot set — the noisy neighbor). The tenant spec decides the
    arm: per-tenant buckets (``trn:rate=0;inf:rate=...``) must keep
    trn's throughput within the solo arm's bound while inf sheds into
    its own budget; ``shared=1`` is the coupling contrast arm; storm
    off (``--storm 0``) is the solo arm. One done line carries trn's
    rate, inf's read rate, and the full wire_record (the ``tenant``
    block is the gate's attribution evidence)."""
    import threading

    from minips_tpu_torch.apps.common import init_multiproc, table_wire_kwargs
    from minips_tpu_torch.data.synthetic import make_zipf_sampler
    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                             ShardedTable)
    from minips_tpu_torch.utils.metrics import wire_record

    rank, nprocs, bus, monitor, _ = init_multiproc("asp", 0)
    if nprocs < 2:
        print(json.dumps({"rank": 0, "event": "error",
                          "err": "--tenant-bench needs the launcher "
                                 "(n >= 2): the serve plane needs "
                                 "peers"}), flush=True)
        return 2

    def mk(name: str) -> ShardedTable:
        return ShardedTable(name, args.rows, args.dim, bus, rank,
                            nprocs, updater=args.updater, lr=0.05,
                            pull_timeout=args.pull_timeout,
                            monitor=monitor, **table_wire_kwargs(args))

    tables = {"trn": mk("trn"), "inf": mk("inf")}
    trainer = ShardedPSTrainer(tables, bus, nprocs,
                               staleness=args.staleness,
                               gate_timeout=60.0, monitor=monitor,
                               serve=args.serve, tenant=args.tenant)
    bus.handshake(nprocs)

    rng = np.random.default_rng(rank)
    B, dim = args.batch, args.dim
    grads = rng.normal(size=(B, dim)).astype(np.float32)
    # the inf tenant's readers hammer the SAME hot rows on every rank
    # (spread_seed shared — real serving skew); trn trains uniform so
    # the protected tenant's traffic is not itself promotable-hot
    zipf_sample = make_zipf_sampler(args.rows, args.zipf_alpha,
                                    spread_seed=7,
                                    permute_hot=args.zipf_permute_hot)
    storm_stop = threading.Event()
    storm_errs: list = []
    storm_counts = [0] * max(args.storm, 1)
    storm_threads: list = []

    def _inf_reader(j: int) -> None:
        rrng = np.random.default_rng((rank, j, 1717))
        SB = args.storm_batch
        think = args.storm_think_ms / 1e3
        inf = tables["inf"]
        while not storm_stop.is_set():
            if think > 0:
                time.sleep(think)
            keys = zipf_sample(rrng, SB)
            try:
                inf.pull_serving(keys)
            except Exception as e:  # noqa: BLE001 - surfaced below
                if not storm_stop.is_set():
                    storm_errs.append(repr(e))
                return
            storm_counts[j] += SB

    for j in range(args.storm):
        th = threading.Thread(target=_inf_reader, args=(j,),
                              daemon=True, name=f"inf-reader-{j}")
        storm_threads.append(th)
        th.start()

    trn = tables["trn"]
    trn_rows = 0
    read0 = 0
    t0 = 0.0
    # deadline pacing: a real trainer has a step time (compute), so
    # the protected number is PACE-KEPT throughput — each step sleeps
    # to its deadline and an overrunning step slips it (never banks
    # debt), so missed deadlines surface as rows/sec below the paced
    # rate. Flat-out (pace=0) measures leftover CPU on the shared
    # box, which no admission split can protect; pace-kept rows/sec
    # is the SLO tenancy actually promises.
    pace = args.trn_step_ms / 1e3
    next_t = time.perf_counter()
    for i in range(args.iters):
        if i == args.warmup:
            trn_rows = 0
            read0 = sum(storm_counts)
            t0 = time.perf_counter()
            next_t = t0
        keys = rng.integers(0, args.rows, size=B)
        trn.pull(keys)
        trn.push(keys, grads)
        trn_rows += 2 * B
        trainer.tick()
        if pace > 0:
            next_t += pace
            slack = next_t - time.perf_counter()
            if slack > 0:
                time.sleep(slack)
            else:
                next_t = time.perf_counter()
    dt = time.perf_counter() - t0
    read_rows = sum(storm_counts) - read0
    storm_stop.set()
    for th in storm_threads:
        th.join(timeout=30.0)
    assert not any(th.is_alive() for th in storm_threads), \
        "inf reader wedged"
    assert not storm_errs, storm_errs
    trainer.finalize(timeout=60.0)
    assert trainer.frames_dropped == 0, trainer.drop_detail()
    trainer.shutdown_barrier(timeout=15.0)

    timed = args.iters - args.warmup
    print(json.dumps({
        "rank": rank, "event": "done", "mode": "tenant_bench",
        "nprocs": nprocs,
        "tenant_spec": (args.tenant
                        or os.environ.get("MINIPS_TENANT") or None),
        "serve_spec": (args.serve or os.environ.get("MINIPS_SERVE")
                       or None),
        "storm_readers": args.storm or None,
        "storm_batch": args.storm_batch if args.storm else None,
        "trn_step_ms": args.trn_step_ms or None,
        "read_rows": int(read_rows),
        "read_rows_per_sec": round(read_rows / dt, 1),
        "staleness": (None if args.staleness == float("inf")
                      else int(args.staleness)),
        "reliable_on": os.environ.get("MINIPS_RELIABLE", "")
        not in ("", "0"),
        **wire_record(trainer),
        "rows": args.rows, "dim": args.dim, "batch": B,
        "iters_timed": timed,
        # the protected number: the training tenant's pull+push rows
        "trn_rows_per_sec": round(trn_rows / dt, 1),
        "wall_s": round(dt, 4),
    }), flush=True)
    if monitor is not None:
        monitor.stop()
    bus.close()
    return 0


def _run_traffic_bench(args) -> int:
    """MINIPS_TRAFFIC bench mode (million_user_3proc): the open-loop
    driver (apps/traffic_driver.py) replays a precomputed zipf-user
    arrival schedule against the ``inf`` table's ``pull_serving``
    while every rank trains the ``trn`` table at the ``--trn-step-ms``
    deadline pace — serving load that arrives whether or not the fleet
    keeps up, measured from SCHEDULED arrival (coordinated-omission-
    free), with training running concurrently the whole time. The
    ``--traffic`` spec decides the arm (flat base, diurnal ramp, flash
    crowd); ``--slo`` arms burn-rate accounting so a crowd provably
    flexes the replica budget and an overload provably sheds into the
    tenant's own budget with a flight-recorder ``slo_burn`` box. One
    done line carries the driver's record (sched_ms is the honest
    number), trn's pace-kept rate, and the full wire_record (the
    ``freshness``/``slo`` blocks are the gate's evidence)."""
    from minips_tpu_torch.apps.common import init_multiproc, table_wire_kwargs
    from minips_tpu_torch.apps.traffic_driver import TrafficDriver
    from minips_tpu_torch.apps.traffic_driver import maybe_config as _traffic
    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                             ShardedTable)
    from minips_tpu_torch.utils.metrics import wire_record

    rank, nprocs, bus, monitor, _ = init_multiproc("asp", 0)
    if nprocs < 2:
        print(json.dumps({"rank": 0, "event": "error",
                          "err": "--traffic-bench needs the launcher "
                                 "(n >= 2): the serve plane needs "
                                 "peers"}), flush=True)
        return 2
    tcfg = _traffic(args.traffic)
    if tcfg is None:
        print(json.dumps({"rank": rank, "event": "error",
                          "err": "--traffic-bench needs an armed "
                                 "--traffic/MINIPS_TRAFFIC spec"}),
              flush=True)
        return 2

    def mk(name: str) -> ShardedTable:
        return ShardedTable(name, args.rows, args.dim, bus, rank,
                            nprocs, updater=args.updater, lr=0.05,
                            pull_timeout=args.pull_timeout,
                            monitor=monitor, **table_wire_kwargs(args))

    tables = {"trn": mk("trn"), "inf": mk("inf")}
    trainer = ShardedPSTrainer(tables, bus, nprocs,
                               staleness=args.staleness,
                               gate_timeout=60.0, monitor=monitor,
                               serve=args.serve, tenant=args.tenant,
                               slo=args.slo)
    bus.handshake(nprocs)

    rng = np.random.default_rng(rank)
    B, dim = args.batch, args.dim
    grads = rng.normal(size=(B, dim)).astype(np.float32)
    # deadline pacing defines the run's wall clock, so the driver's
    # schedule horizon is exactly the timed window — the crowd lands
    # at a knowable second of the measurement, not of the warmup
    pace = args.trn_step_ms / 1e3
    timed = args.iters - args.warmup
    duration = timed * pace
    driver = TrafficDriver(tcfg, tables["inf"].pull_serving,
                           args.rows, duration_s=duration)
    # trn trains a steady write load into the INF table too (small
    # batches) so the serving reads have fresh pushes to be stale
    # AGAINST — freshness lag is only measurable on a written table
    inf = tables["inf"]
    inf_keys = rng.integers(0, args.rows, size=max(B // 4, 1))
    inf_grads = rng.normal(size=(len(inf_keys), dim)
                           ).astype(np.float32)

    trn = tables["trn"]
    trn_rows = 0
    t0 = 0.0
    next_t = time.perf_counter()
    for i in range(args.iters):
        if i == args.warmup:
            trn_rows = 0
            t0 = time.perf_counter()
            next_t = t0
            driver.start()  # schedule t=0 is the warmup boundary
        keys = rng.integers(0, args.rows, size=B)
        trn.pull(keys)
        trn.push(keys, grads)
        inf.push(inf_keys, inf_grads)  # the freshness write stream
        trn_rows += 2 * B
        trainer.tick()
        if pace > 0:
            next_t += pace
            slack = next_t - time.perf_counter()
            if slack > 0:
                time.sleep(slack)
            else:
                next_t = time.perf_counter()
    dt = time.perf_counter() - t0
    # stop the driver BEFORE finalize (post-finalize agreement is
    # exact; a still-running dispatcher would race the quiesce)
    driver.stop()
    trainer.finalize(timeout=60.0)
    assert trainer.frames_dropped == 0, trainer.drop_detail()
    trainer.shutdown_barrier(timeout=15.0)

    print(json.dumps({
        "rank": rank, "event": "done", "mode": "traffic_bench",
        "nprocs": nprocs,
        "traffic_spec": (args.traffic
                         or os.environ.get("MINIPS_TRAFFIC") or None),
        "slo_spec": (args.slo or os.environ.get("MINIPS_SLO") or None),
        "tenant_spec": (args.tenant
                        or os.environ.get("MINIPS_TENANT") or None),
        "serve_spec": (args.serve or os.environ.get("MINIPS_SERVE")
                       or None),
        "trn_step_ms": args.trn_step_ms,
        # the driver's full open-loop record: scheduled/issued/late
        # counts, sched_ms (scheduled-arrival -> done — the honest
        # tail) next to svc_ms (issue -> done)
        "traffic": driver.record(),
        "staleness": (None if args.staleness == float("inf")
                      else int(args.staleness)),
        "reliable_on": os.environ.get("MINIPS_RELIABLE", "")
        not in ("", "0"),
        **wire_record(trainer),
        "rows": args.rows, "dim": args.dim, "batch": B,
        "iters_timed": timed,
        # the protected number: the training tenant's pace-kept rows
        "trn_rows_per_sec": round(trn_rows / dt, 1),
        "wall_s": round(dt, 4),
    }), flush=True)
    if monitor is not None:
        monitor.stop()
    bus.close()
    return 0


def _run_mesh(args) -> int:
    """The in-mesh collective data plane bench: one process, ``--mesh-
    ranks`` logical ranks as threads over as many devices, pushes/pulls
    riding reduce-scatter/all-gather (train/mesh_plane.py) instead of
    the host wire. Emits ONE JSON line shaped like a done line: its
    ``device_count`` is the plane's device list and ``jax_backend`` (the
    reference's key) the torch device type."""
    import threading

    from minips_tpu_torch.train.mesh_plane import MeshPlane

    n = args.mesh_ranks
    plane = MeshPlane(n, staleness=args.staleness, comm=args.mesh_comm,
                      deposit=args.mesh_deposit,
                      devices=_arm_mesh_devices(n, args.mesh_devices))
    table = plane.add_table("b", args.rows, args.dim,
                            updater=args.updater, lr=0.05)
    B, dim = args.batch, args.dim
    rates = [0.0] * n
    rows_counts = [0] * n
    cb_at_warmup = [0] * n  # collective-bytes snapshot at each rank's
    # warmup boundary: the B/row metric must cover the same timed
    # window as the wire arms' byte counters (which snapshot
    # bytes_pushed/pulled at warmup), not the compile-warmup waves
    errs: list = []

    def worker(r: int) -> None:
        try:
            rng = np.random.default_rng(r)
            grads = rng.normal(size=(B, dim)).astype(np.float32)
            dense_grad = rng.normal(size=(args.rows, dim)
                                    ).astype(np.float32)
            h = plane.rank(r)
            t = h.tables["b"]
            moved = 0
            t0 = time.perf_counter()
            for i in range(args.iters):
                if i == args.warmup:
                    moved = 0
                    cb_at_warmup[r] = table.collective_bytes
                    t0 = time.perf_counter()
                if args.path == "sparse":
                    keys = rng.integers(0, args.rows, size=B)
                    t.pull(keys)
                    t.push(keys, grads)
                    moved += 2 * B
                else:
                    t.pull_all()
                    t.push_dense(dense_grad)
                    moved += 2 * args.rows
                h.tick()
            h.finalize(timeout=60.0)
            dt = time.perf_counter() - t0
            rates[r] = moved / dt
            rows_counts[r] = moved
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append((r, repr(e)))

    ths = [threading.Thread(target=worker, args=(r,), name=f"mesh-{r}")
           for r in range(n)]
    t_all0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600.0)
    wall = time.perf_counter() - t_all0
    if any(th.is_alive() for th in ths) or errs:
        print(json.dumps({"event": "error", "plane": "mesh",
                          "errs": [repr(e)[:300] for e in errs]
                          or "wedged"}), flush=True)
        return 2
    stats = plane.stats()
    # timed-window collective bytes: everything after the LAST rank's
    # warmup boundary (ranks run near-lockstep under the BSP gate, so
    # the max snapshot is the tightest shared boundary)
    cb_timed = stats["collective_bytes"] - max(cb_at_warmup)
    print(json.dumps({
        "event": "done", "plane": "mesh",
        "mesh_ranks": n, "mesh_comm": args.mesh_comm,
        "device_count": plane.mesh.n,
        "jax_backend": plane.mesh.devices[0].type,
        "path": args.path, "updater": args.updater,
        "staleness": (None if plane.staleness == float("inf")
                      else int(plane.staleness)),
        "rows": args.rows, "dim": args.dim, "batch": B,
        "iters_timed": args.iters - args.warmup,
        "rows_per_sec_ranks": [round(x, 1) for x in rates],
        "rows_per_sec": round(sum(rates) / n, 1),
        "aggregate_rows_per_sec": round(sum(rates), 1),
        "waves": stats["waves"]["b"],
        "gate_waits": stats["gate_waits"],
        # deposit-stage accounting (the mesh_sparse arm's evidence):
        # dense = fixed pre-stacked [rows, dim] buffers, sparse = COO
        # staging + segment-sum densify on device — peak host bytes is
        # the number the arm's >=4x reduction gate reads
        "deposit": stats["deposit"],
        "peak_deposit_bytes": stats["peak_deposit_bytes"]["b"],
        "sparse_waves": stats["sparse_waves"],
        "collective_bytes": stats["collective_bytes"],
        "collective_bytes_per_row_moved": round(
            cb_timed / max(sum(rows_counts), 1), 3),
        "wall_s": round(wall, 4),
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=["sparse", "dense"], default="sparse")
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4096,
                    help="keys per pull/push cycle (sparse path)")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--updater", choices=["sgd", "adagrad", "adam"],
                    default="adagrad")
    ap.add_argument("--key-dist", choices=["uniform", "zipf"],
                    default="uniform",
                    help="sparse-path key distribution: uniform, or "
                         "seeded zipf(--zipf-alpha) with hot ranks "
                         "spread across shards "
                         "(data/synthetic.make_zipf_sampler) — the "
                         "workload where the client row cache and the "
                         "deduplicated pull wire earn their keep")
    ap.add_argument("--zipf-alpha", type=float, default=1.1)
    ap.add_argument("--no-zipf-permute-hot", dest="zipf_permute_hot",
                    action="store_false", default=True,
                    help="draw zipf keys WITHOUT the hot-rank "
                         "permutation: the whole head lands in shard "
                         "0's range — the static-partition pathology "
                         "the heat-aware rebalancer (MINIPS_REBALANCE) "
                         "exists to fix; the rebalance_3proc sweep's "
                         "arms run this")
    ap.add_argument("--staleness", type=float, default=float("inf"),
                    help="consistency bound for the run: inf = ASP "
                         "(the default; measures the bare data path), "
                         "finite s = SSP(s) — the cache_comparison "
                         "sweep runs s in {0,1,2} because the cache's "
                         "validity window IS the staleness budget")
    ap.add_argument("--pull-timeout", dest="pull_timeout", type=float,
                    default=60.0,
                    help="table pull/ack deadline — the chaos sweep "
                         "shortens it so the retransmit-off arms die "
                         "in seconds instead of the default minute "
                         "(the poison path is the measurement there)")
    ap.add_argument("--compute", choices=["none", "jit"], default="none",
                    help="jit: between pull and push, run a REAL "
                         "model-grad step (autograd) on the pulled rows, "
                         "on the rank's device (the card; the CPU under "
                         "MINIPS_FORCE_CPU). This measures the north-star "
                         "topology: PS wire + accelerator worker compute "
                         "overlapped, not the bare control plane")
    from minips_tpu_torch.apps.common import add_wire_flags

    add_wire_flags(ap)
    ap.add_argument("--hidden", type=int, default=256,
                    help="--compute jit: MLP hidden width over the "
                         "pulled rows (the MXU work per cycle)")
    ap.add_argument("--storm", type=int, default=0, metavar="N",
                    help="PULL-STORM mode: N read-only client threads "
                         "per process hammer pull() while only the "
                         "first --storm-pushers ranks push — the PS "
                         "measured as a SERVICE (read fan-out) instead "
                         "of a training gang. Requires --path sparse "
                         "and a launcher run (nprocs > 1); the done "
                         "line grows read_rows_per_sec")
    ap.add_argument("--storm-pushers", type=int, default=1,
                    help="storm mode: ranks below this push every "
                         "iteration (the 'few pushers'); every rank "
                         "still ticks so clocks advance fleet-wide")
    ap.add_argument("--storm-batch", type=int, default=16,
                    help="storm mode: keys per READ request — the "
                         "serving request shape (a user lookup reads a "
                         "handful of embedding rows, not a training "
                         "batch). Small requests are what replica "
                         "fan-out converts: a request whose keys are "
                         "all held locally (own shard + replica "
                         "snapshots) completes with ZERO wire legs")
    ap.add_argument("--storm-think-ms", type=float, default=1.0,
                    help="storm mode: per-request client think time — "
                         "serving clients are open-loop (a user isn't "
                         "a spin loop), and on an oversubscribed host "
                         "a zero-think closed loop burns the CPU the "
                         "serve path needs, drowning the latency tail "
                         "in scheduler noise for both arms")
    ap.add_argument("--storm-step-s", type=float, default=0.02,
                    help="storm mode: main-loop pacing per iteration — "
                         "the pusher cadence; readers free-run")
    ap.add_argument("--trn-step-ms", type=float, default=0.0,
                    help="tenant bench: the training tenant's step "
                         "deadline — each pull+push+tick sleeps to "
                         "this pace and an overrun slips the deadline "
                         "(never banks debt), so trn_rows_per_sec is "
                         "PACE-KEPT throughput: the SLO number "
                         "admission isolation can actually protect. "
                         "0 = flat out (measures leftover CPU on a "
                         "shared box, noisy-neighbor-sensitive by "
                         "construction)")
    ap.add_argument("--serve", default=None, metavar="SPEC",
                    help="arm the read-mostly serving plane "
                         "(minips_tpu_torch/serve/) with this MINIPS_SERVE "
                         "spec — the flag spelling of the env knob; "
                         "hot-block replicas, admission control, SLO "
                         "gate (docs/serving.md)")
    ap.add_argument("--plane", choices=["wire", "mesh"], default=None,
                    help="data plane: 'wire' (the multi-process host "
                         "bus, default) or 'mesh' — the in-mesh "
                         "collective plane (train/mesh_plane.py): one "
                         "process, --mesh-ranks logical ranks over as "
                         "many devices, push/pull as reduce-scatter/"
                         "all-gather. Env spelling: MINIPS_MESH=1 "
                         "(explicit flag wins)")
    ap.add_argument("--mesh-ranks", type=int, default=3,
                    help="mesh plane: logical ranks = mesh devices "
                         "(CPU runs force that many host devices)")
    ap.add_argument("--mesh-comm", choices=["float32", "blk8"],
                    default="float32",
                    help="mesh plane collective tier: f32 reduce-"
                         "scatter, or blk8 — blockwise absmax int8 "
                         "codes inside the collective (EQuARX-style; "
                         "the host-wire codec, second transport)")
    ap.add_argument("--mesh-deposit", choices=["dense", "sparse"],
                    default=None,
                    help="mesh plane deposit-buffer shape: 'dense' "
                         "pre-stacked [rows, dim] host buffers, or "
                         "'sparse' — COO staging + "
                         "on-device segment-sum densify, trading a "
                         "per-wave gather for peak host memory that "
                         "scales with TOUCHED rows instead of the "
                         "table (the embedding-shaped regime). Env "
                         "spelling: MINIPS_MESH_SPARSE=1 (explicit "
                         "flag wins); default dense")
    ap.add_argument("--mesh-devices", default=None, metavar="LIST",
                    help="mesh plane: the ranks' torch devices, a comma "
                         "list; one entry runs every rank on that device "
                         "(cuda:0: the whole plane on one card). Default: "
                         "the visible cards (MINIPS_FORCE_CPU: the CPU)")
    ap.add_argument("--mesh-bitwise-drill", action="store_true",
                    help="run the BSP zmq-vs-mesh bitwise lockstep "
                         "drill and emit its stamp instead of a bench "
                         "(the artifact's MESH-BITWISE input)")
    ap.add_argument("--fail-slow-idle-drill", action="store_true",
                    help="run the BSP lockstep drill hedge-armed vs "
                         "off on a clean wire and emit its bitwise "
                         "stamp (the artifact's SLOW-IDLE input: "
                         "armed-but-idle must equal off bit-for-bit)")
    ap.add_argument("--reshard-mem-drill", action="store_true",
                    help="run the streaming N->M checkpoint reshard "
                         "drill at a RAM-visible table size and emit "
                         "its stamp (the artifact's RESHARD-MEM "
                         "input: capped read bitwise-equal to the "
                         "uncapped read with measured peak staging "
                         "<= cap, legacy whole-member staging > cap)")
    ap.add_argument("--hier-idle-drill", action="store_true",
                    help="run the 3-rank hier lockstep drill armed-"
                         "idle (MINIPS_HIER=1, group=1 — no pair in "
                         "hier mode) vs off and emit its bitwise "
                         "stamp (the artifact's HIER-IDLE input)")
    ap.add_argument("--hier-bitwise-drill", action="store_true",
                    help="run the 3-rank hier lockstep drill with the "
                         "full tree (group=2, compression off) vs off "
                         "and emit its bitwise stamp (HIER-WIN's "
                         "exactness leg: aggregation re-lanes exact "
                         "contributions, bitwise equal by "
                         "construction)")
    ap.add_argument("--hybrid-idle-drill", action="store_true",
                    help="run the 3-rank hier lockstep drill with the "
                         "hybrid plane armed-idle (group=1,agg=mesh — "
                         "every group a singleton, no flush ever runs) "
                         "vs off and emit its bitwise stamp (the "
                         "artifact's HYBRID-IDLE input: armed "
                         "bookkeeping must perturb nothing)")
    ap.add_argument("--hybrid-degenerate-drill", action="store_true",
                    help="run the 3-rank hier lockstep drill with the "
                         "hybrid plane on a ONE-device mesh "
                         "(group=2,agg=mesh + MINIPS_HIER_MESH_DEVS=1) "
                         "vs off and emit its bitwise stamp: the "
                         "degenerate tier runs THE shared f64 dedup "
                         "kernel in deposit order, so off == agg=host "
                         "== one-device mesh bit-for-bit")
    ap.add_argument("--tenant", default=None, metavar="SPEC",
                    help="arm multi-tenant tables on this worker's "
                         "trainer (MINIPS_TENANT grammar, "
                         "tenant/registry.py) — the flag spelling; "
                         "the env works too (flag wins)")
    ap.add_argument("--tenant-bench", action="store_true",
                    help="two-tenant isolation mode: a 'trn' table "
                         "trains flat out (pull+push, the protected "
                         "trn_rows_per_sec) while --storm reader "
                         "threads free-run pull_serving against an "
                         "'inf' table on the shared zipf hot set; "
                         "--tenant decides the arm (per-tenant "
                         "buckets vs shared=1 vs storm-off solo). "
                         "The multi_tenant_3proc sweep's worker")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="arm SLO burn-rate accounting (MINIPS_SLO "
                         "grammar, obs/slo.py) on this worker's "
                         "trainer — the flag spelling; the env works "
                         "too (flag wins). Burning tenants flex the "
                         "serve plane's promotion budget and feed the "
                         "autoscaler's arming pressure")
    ap.add_argument("--traffic", default=None, metavar="SPEC",
                    help="open-loop traffic spec (MINIPS_TRAFFIC "
                         "grammar, apps/traffic_driver.py) for "
                         "--traffic-bench — zipf user population, "
                         "base rate, diurnal ramp, flash crowd; the "
                         "env spelling works too (flag wins)")
    ap.add_argument("--traffic-bench", action="store_true",
                    help="open-loop serving mode: the traffic driver "
                         "replays a precomputed arrival schedule "
                         "against an 'inf' table's pull_serving "
                         "(latency measured from SCHEDULED arrival — "
                         "coordinated-omission-free) while a 'trn' "
                         "table trains at the --trn-step-ms pace; "
                         "--traffic decides the arm (flat / ramp / "
                         "flash crowd), --slo arms burn accounting. "
                         "The million_user_3proc sweep's worker")
    ap.add_argument("--traffic-idle-drill", action="store_true",
                    help="run the BSP lockstep drill with the traffic "
                         "driver armed at rate=0 vs off and emit its "
                         "bitwise stamp + scheduled/issued evidence "
                         "(the artifact's TRAFFIC-IDLE input)")
    ap.add_argument("--tenant-idle-drill", action="store_true",
                    help="run the BSP lockstep drill with the bare "
                         "default tenant (MINIPS_TENANT=1) vs off "
                         "and emit its bitwise stamp + tenant-id/"
                         "counter evidence (the artifact's "
                         "TENANT-IDLE input)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write this rank's wire trace (Chrome-trace "
                         "JSON, obs/tracer.py) into DIR — the flag "
                         "spelling of MINIPS_TRACE; the bench driver's "
                         "trace arm uses it to drop per-rank traces "
                         "into the sweep artifact dir for "
                         "minips_tpu_torch.obs.merge")
    args = ap.parse_args(argv)
    from minips_tpu_torch.train.mesh_plane import resolve_plane

    plane_kind = resolve_plane(args.plane)
    if args.mesh_bitwise_drill:
        return _run_mesh_drill(_arm_mesh_devices(2, args.mesh_devices))
    if args.fail_slow_idle_drill:
        return _run_fail_slow_idle_drill()
    if args.tenant_idle_drill:
        return _run_tenant_idle_drill()
    if args.traffic_idle_drill:
        return _run_traffic_idle_drill()
    if args.traffic_bench:
        if args.path != "sparse" or args.compute != "none":
            ap.error("--traffic-bench measures the open-loop serve "
                     "path — drop --path dense/--compute")
        if args.trn_step_ms <= 0:
            ap.error("--traffic-bench needs --trn-step-ms > 0: the "
                     "paced training window defines the arrival "
                     "schedule's horizon")
        return _run_traffic_bench(args)
    if args.tenant_bench:
        if args.path != "sparse" or args.compute != "none":
            ap.error("--tenant-bench measures tenant isolation on the "
                     "sparse serve path — drop --path dense/--compute")
        return _run_tenant_bench(args)
    if args.reshard_mem_drill:
        return _run_reshard_mem_drill()
    if args.hier_idle_drill:
        return _run_hier_drill("1")
    if args.hier_bitwise_drill:
        return _run_hier_drill("group=2")
    if args.hybrid_idle_drill:
        return _run_hier_drill("group=1,agg=mesh")
    if args.hybrid_degenerate_drill:
        # pin the one-device tier BEFORE the lockstep builds its
        # aggregators — the driver may also set it; either spelling
        # lands on the same degenerate host-kernel path
        os.environ["MINIPS_HIER_MESH_DEVS"] = "1"
        return _run_hier_drill("group=2,agg=mesh")
    if plane_kind == "mesh":
        if args.storm or args.overlap or args.cache_bytes \
                or args.serve or args.compute != "none":
            ap.error("--plane mesh measures the collective data plane: "
                     "storm/overlap/cache/serve/compute are host-wire "
                     "levers (see docs/architecture.md 'device data "
                     "plane')")
        return _run_mesh(args)
    if args.compute == "jit" and args.path != "sparse":
        # the grad step runs on pulled ROWS; the dense path never calls
        # it — a dense rate must not get labeled as compute-overlapped
        ap.error("--compute jit requires --path sparse")
    if args.warmup >= args.iters:
        ap.error(f"--warmup {args.warmup} must be < --iters {args.iters} "
                 "(otherwise the timer never starts and every rate is "
                 "garbage)")
    if args.storm:
        if args.path != "sparse":
            ap.error("--storm requires --path sparse")
        if args.compute != "none":
            ap.error("--storm measures the serve path, not worker "
                     "compute — drop --compute")
        if args.storm_pushers < 1:
            ap.error("--storm-pushers must be >= 1 (clocks must advance)")

    from minips_tpu_torch.train.sharded_ps import ShardedPSTrainer, ShardedTable

    rank = int(os.environ.get("MINIPS_PROC_ID", "0"))
    nprocs = int(os.environ.get("MINIPS_NUM_PROCS", "1"))

    from minips_tpu_torch.obs import tracer as _trc

    if args.trace:  # flag spelling of MINIPS_TRACE (env works too)
        _trc.init(args.trace, rank)

    grad_step = None
    backend = "none"
    if args.compute == "jit":
        # the two-layer row-gradient step by autograd on this rank's
        # device: the card (one per colocated rank), the CPU under
        # MINIPS_FORCE_CPU
        import torch

        from minips_tpu_torch.apps.common import multiproc_device

        dev = multiproc_device(
            "cpu" if os.environ.get("MINIPS_FORCE_CPU") else None)
        backend = dev.type
        W1 = torch.tensor(np.random.default_rng(7).normal(
            scale=0.05, size=(args.dim, args.hidden)), dtype=torch.float32,
            device=dev)
        W2 = torch.tensor(np.random.default_rng(8).normal(
            scale=0.05, size=(args.hidden,)), dtype=torch.float32,
            device=dev)

        def grad_step(rows, y):
            # host->device, forward + backward, device->host: the honest
            # per-cycle cost of accelerator workers against a host PS
            r = torch.as_tensor(rows, dtype=torch.float32).to(
                dev).requires_grad_(True)
            yy = torch.as_tensor(y, dtype=torch.float32).to(dev)
            logit = torch.relu(r @ W1) @ W2
            loss = torch.mean(torch.clamp(logit, min=0) - logit * yy
                              + torch.log1p(torch.exp(-torch.abs(logit))))
            (g,) = torch.autograd.grad(loss, r)
            return g.detach().cpu().numpy()
    if nprocs > 1:
        from minips_tpu_torch.apps.common import init_multiproc

        rank, nprocs, bus, monitor, _ = init_multiproc("asp", 0)
    else:  # standalone: zero-wire baseline, pure server-side apply
        bus = monitor = None

    from minips_tpu_torch.apps.common import table_wire_kwargs

    table = ShardedTable("b", args.rows, args.dim, bus, rank, nprocs,
                         updater=args.updater, lr=0.05,
                         pull_timeout=args.pull_timeout, monitor=monitor,
                         async_push=(args.overlap and
                                     args.overlap_legs != "pull"),
                         **table_wire_kwargs(args))
    if args.storm and bus is None:
        print(json.dumps({"rank": 0, "event": "error",
                          "err": "--storm needs the launcher (n >= 2): "
                                 "a standalone rank has no peers to "
                                 "read from"}), flush=True)
        return 2
    trainer = None
    if bus is not None:
        trainer = ShardedPSTrainer({"b": table}, bus, nprocs,
                                   staleness=args.staleness,
                                   gate_timeout=60.0, monitor=monitor,
                                   serve=args.serve,
                                   tenant=args.tenant)
        bus.handshake(nprocs)

    rng = np.random.default_rng(rank)
    B, dim = args.batch, args.dim
    grads = rng.normal(size=(B, dim)).astype(np.float32)
    dense_grad = rng.normal(size=(args.rows, dim)).astype(np.float32)
    zipf_sample = None
    if args.key_dist == "zipf":
        from minips_tpu_torch.data.synthetic import make_zipf_sampler

        # spread_seed shared across ranks: every process sees the SAME
        # hot rows (a real workload's skew), scattered across shards
        zipf_sample = make_zipf_sampler(args.rows, args.zipf_alpha,
                                        spread_seed=7,
                                        permute_hot=args.zipf_permute_hot)

    y_lab = (rng.random(B) > 0.5).astype(np.float32)

    # Overlapped pipeline (--overlap): batch t+1's pull is ISSUED before
    # batch t's compute/push, stamped one clock ahead (owners admit it
    # under exactly the rule the consuming step would face — a no-op
    # here under ASP), and pushes drain on the sender thread until the
    # tick's hard drain. The synchronous cycle is the off-arm of the
    # overlap_on_off_3proc sweep.
    pending: list = [None, None]  # [keys, PullFuture]

    def draw_keys():
        if zipf_sample is not None:
            return zipf_sample(rng, B)
        return rng.integers(0, args.rows, size=B)

    # ---- pull-storm mode: N read-only client THREADS per process
    # free-run pull() against the fleet while the main thread paces
    # pushes (pusher ranks only) + ticks. Reader counts are snapshotted
    # at the warmup boundary so read_rows_per_sec covers exactly the
    # timed window. Concurrent reader pulls are safe on the table (leg
    # bookkeeping is per-group and locked; adoption stays on the
    # push-driving thread — balance/rebalancer.py adopt_now guard).
    import threading

    storm_stop = threading.Event()
    storm_errs: list = []
    storm_counts = [0] * max(args.storm, 1)
    storm_threads: list = []
    # coordinated-omission fix: each reader keeps an INTENDED-arrival
    # schedule (next_t += think, never reset from completion) and
    # records completion - intended next to bare service time. The old
    # accounting slept AFTER each completion, so a slow read silently
    # pushed every later request's start — the classic closed-loop
    # self-throttle that under-reports the tail exactly under load.
    # Both hists ride the done line (read_intended_ms / read_svc_ms).
    from minips_tpu_torch.obs.hist import (Log2Histogram,
                                     summarize_counts as _sum_counts)

    storm_hist_intended = Log2Histogram()
    storm_hist_svc = Log2Histogram()

    def _storm_reader(j: int) -> None:
        rrng = np.random.default_rng((rank, j, 1717))
        SB = args.storm_batch
        think = args.storm_think_ms / 1e3
        next_t = time.perf_counter()
        while not storm_stop.is_set():
            if think > 0:
                next_t += think
                slack = next_t - time.perf_counter()
                if slack > 0 and storm_stop.wait(slack):
                    return
            else:
                next_t = time.perf_counter()
            keys = (zipf_sample(rrng, SB) if zipf_sample is not None
                    else rrng.integers(0, args.rows, size=SB))
            t1 = time.perf_counter()
            try:
                # the serving read clock: admission already proven
                # fleet-wide, so reads never park on the in-flight step
                table.pull_serving(keys)
            except Exception as e:  # noqa: BLE001 - surfaced below
                if not storm_stop.is_set():
                    storm_errs.append(repr(e))
                return
            t2 = time.perf_counter()
            storm_hist_intended.record_s(t2 - next_t)
            storm_hist_svc.record_s(t2 - t1)
            storm_counts[j] += SB

    if args.storm:
        for j in range(args.storm):
            th = threading.Thread(target=_storm_reader, args=(j,),
                                  daemon=True, name=f"storm-reader-{j}")
            storm_threads.append(th)
            th.start()

    def cycle():
        if args.storm:
            time.sleep(args.storm_step_s)  # pusher cadence
            if rank < args.storm_pushers:
                keys = draw_keys()
                table.push(keys, grads)
                return B
            return 0
        if args.path == "sparse":
            if args.overlap and args.overlap_legs != "push":
                if pending[1] is None:  # first iteration: nothing ahead
                    pending[0] = draw_keys()
                    pending[1] = table.prefetch_pull(pending[0],
                                                     clock_ahead=0)
                keys, fut = pending
                nxt = draw_keys()
                pending[0] = nxt
                pending[1] = table.prefetch_pull(nxt)  # overlaps below
                rows = fut.wait()
            else:
                keys = draw_keys()
                rows = table.pull(keys)
            g = (grad_step(rows, y_lab) if grad_step is not None
                 else grads)
            table.push(keys, g)
            return 2 * B  # rows moved (pulled + pushed)
        table.pull_all()
        table.push_dense(dense_grad)
        return 2 * args.rows

    rows_moved = 0
    b_push0 = b_pull0 = 0.0
    read0 = 0
    t0 = 0.0
    for i in range(args.iters):
        if i == args.warmup:
            rows_moved = 0
            b_push0, b_pull0 = table.bytes_pushed, table.bytes_pulled
            read0 = sum(storm_counts)
            t0 = time.perf_counter()
        rows_moved += cycle()
        if trainer is not None:
            trainer.tick()  # ASP: publishes clock, never waits
    table.flush_pushes()  # standalone/async tail: count only drained work
    dt = time.perf_counter() - t0
    read_rows = sum(storm_counts) - read0
    if args.storm:
        # stop the readers BEFORE finalize (post-finalize agreement is
        # exact; a still-running reader would race the quiesce)
        storm_stop.set()
        for th in storm_threads:
            th.join(timeout=30.0)
        assert not any(th.is_alive() for th in storm_threads), \
            "storm reader wedged"
        assert not storm_errs, storm_errs
    b_push1, b_pull1 = table.bytes_pushed, table.bytes_pulled
    if pending[1] is not None:
        pending[1].cancel()  # dangling last prefetch: never consumed
    if trainer is not None:
        trainer.finalize(timeout=60.0)
        assert trainer.frames_dropped == 0, trainer.drop_detail()
        trainer.shutdown_barrier(timeout=15.0)

    timed = args.iters - args.warmup
    # the full wire_record layout rides the done line (the schema test
    # pins it, scrapers rely on it); the standalone path builds the
    # SAME record through a view so the layout is defined exactly once
    from types import SimpleNamespace

    from minips_tpu_torch.train.sharded_ps import tables_hist_stats
    from minips_tpu_torch.utils.metrics import wire_record

    solo = SimpleNamespace(
        bytes_pushed=table.bytes_pushed,
        bytes_pulled=table.bytes_pulled,
        frames_dropped=table.frames_dropped,
        wire_frames_lost=0, wire_frames_malformed=0,
        comm_timing=table.timers.summary,
        hist_stats=lambda: tables_hist_stats([table]),
        cache_stats=table.cache_stats,
        ef_stats=table.ef_stats,
        reliable_stats=lambda: None, chaos_stats=lambda: None,
        # the standalone path has no trainer, hence no serve plane:
        # the replica sub-block is None (off) like the other layers —
        # and no clock boundary, hence no windowed layer or heartbeat
        # monitor (None = off, the same convention)
        serve_stats=lambda: {**table.serve, "replica": None},
        rebalance_stats=lambda: None,
        window_stats=lambda: None,
        heartbeat_stats=lambda: None)
    trace_file = _trc.dump_now()  # standalone has no finalize dump
    print(json.dumps({
        "rank": rank, "event": "done",
        "path": args.path, "nprocs": nprocs,
        "push_comm": table.push_comm,  # resolved (None defers to env)
        "pull_wire": args.pull_wire,   # echo: bench asserts negotiation
        "overlap": bool(args.overlap),
        "overlap_legs": args.overlap_legs if args.overlap else None,
        # cache/key-dist echo: the sweep asserts these so a flag-
        # plumbing regression can't publish a mislabeled arm
        "key_dist": args.key_dist,
        "zipf_alpha": args.zipf_alpha if args.key_dist == "zipf" else None,
        "zipf_permute_hot": (bool(args.zipf_permute_hot)
                             if args.key_dist == "zipf" else None),
        # rebalancer/chaos/reliable/trace echoes (env- or flag-
        # configured): the sweep asserts the arm config
        "rebalance_spec": os.environ.get("MINIPS_REBALANCE") or None,
        "serve_spec": (args.serve or os.environ.get("MINIPS_SERVE")
                       or None),
        "storm_readers": args.storm or None,
        "storm_pushers": args.storm_pushers if args.storm else None,
        "read_rows": int(read_rows) if args.storm else None,
        "read_rows_per_sec": (round(read_rows / dt, 1) if args.storm
                              else None),
        # storm read latency, TWO ways (schema note): read_intended_ms
        # measures from each request's INTENDED arrival (think-paced
        # schedule, coordinated-omission-free — the honest tail);
        # read_svc_ms is bare service time (issue -> completion, the
        # only number the old accounting kept). intended >= svc always;
        # a large gap means the closed loop was self-throttling.
        "read_intended_ms": (_sum_counts(storm_hist_intended.snapshot())
                             if args.storm else None),
        "read_svc_ms": (_sum_counts(storm_hist_svc.snapshot())
                        if args.storm else None),
        "staleness": (None if args.staleness == float("inf")
                      else int(args.staleness)),
        "cache_bytes": args.cache_bytes,
        "pull_dedup": bool(args.pull_dedup),
        "push_dedup": bool(args.push_dedup),
        "chaos_spec": os.environ.get("MINIPS_CHAOS") or None,
        "reliable_on": os.environ.get("MINIPS_RELIABLE", "")
        not in ("", "0"),
        "trace_file": trace_file,
        # bytes/drops/loss/timing/hist/cache/reliable/chaos/serve/
        # rebalance — the one wire-health layout (utils/metrics.py)
        **wire_record(trainer if trainer is not None else solo),
        "compute": (f"jit({backend})" if args.compute == "jit"
                    else "none"),
        "bus": os.environ.get("MINIPS_BUS", "zmq") if bus else "none",
        "wire_fmt": ((os.environ.get("MINIPS_WIRE_FMT") or "bin")
                     if bus else None),
        "rows": args.rows, "dim": args.dim, "batch": B,
        "iters_timed": timed,
        "rows_per_sec": round(rows_moved / dt, 1),
        "cycles_per_sec": round(timed / dt, 2),
        "wire_push_bytes_per_sec": round((b_push1 - b_push0) / dt, 1),
        "wire_pull_bytes_per_sec": round((b_pull1 - b_pull0) / dt, 1),
        "wire_bytes_per_row_moved": round(
            (b_push1 - b_push0 + b_pull1 - b_pull0)
            / max(rows_moved, 1), 3),
        "wall_s": round(dt, 4),
    }), flush=True)
    if monitor is not None:
        monitor.stop()
    if bus is not None:
        bus.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
