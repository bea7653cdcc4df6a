"""The port's key-range-sharded multi-process PS (``train/sharded_ps.py``),
held against the JAX package's in process.

Both packages' servers are numpy on the host, so the same frames in the
same order must leave bit-identical shard state (``assert_array_equal``,
no tolerance): the updaters applied directly, a 3-shard fleet of port
nodes against a fleet of reference nodes, and mixed fleets (reference and
port nodes on one loopback mesh) on every push wire against the
all-reference fleet. Pushes are serialized across senders (each pusher's
pull after its push rides the same links, so it returns once the push is
applied), which fixes the order in which an owner applies frames; under a
live BSP/SSP job two senders' frames to one owner race, and adagrad and
adam do not commute. Buses take OS-assigned ports
(``tests/torch_comm_util.py``).

The launched jobs (``apps/sharded_ps_example.py`` under the port's
launcher, ranks pinned to the CPU) hold the JAX package's multiproc
contracts: replica agreement, 1/N memory, the skew bound, falling loss,
and the kill -> exit 42 -> resume drill.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from minips_tpu.train import sharded_ps as jsp
from minips_tpu_torch import launch
from minips_tpu_torch.train import sharded_ps as sp
from tests.torch_comm_util import close_all, mixed_buses, module

APP = "minips_tpu_torch.apps.sharded_ps_example"
UPDATERS = ["sgd", "adagrad", "adam"]
# launched ranks on the CPU, one intra-op thread each (their steps are
# small, and the test run shares the host with other jobs)
CPU_RANK = {"MINIPS_FORCE_CPU": "1", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _quiet_obs(monkeypatch):
    """Trainers arm both packages' flight recorders by default; keep them
    off here (nothing in these tests reads a dump)."""
    monkeypatch.setenv("MINIPS_FLIGHT", "0")
    yield
    for pkg in ("port", "ref"):
        module(pkg, "obs.flight").reset_for_tests()


def _solo(mod, **kw):
    """The server shard alone (one process, no bus): the updater math."""
    return mod.ShardedTable("t", kw.pop("num_rows", 64), kw.pop("dim", 4),
                            None, 0, 1, **kw)


def _assert_state_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ----------------------------------------------------------- the updaters
@pytest.mark.parametrize("updater", UPDATERS)
def test_apply_rows_bit_identical_to_reference(updater):
    kw = dict(updater=updater, lr=0.3, init_scale=0.1, seed=7)
    t, j = _solo(sp, **kw), _solo(jsp, **kw)
    _assert_state_equal(t.shard_state_dict(), j.shard_state_dict())
    rng = np.random.default_rng(1)
    for _ in range(4):  # duplicates summed, optimizer state tracked
        keys = rng.integers(0, 64, size=12)
        grads = rng.normal(size=(12, 4)).astype(np.float32)
        t._apply_rows(keys, grads)
        j._apply_rows(keys, grads)
    _assert_state_equal(t.shard_state_dict(), j.shard_state_dict())


@pytest.mark.parametrize("updater", UPDATERS)
def test_apply_range_bit_identical_to_reference(updater):
    kw = dict(updater=updater, lr=0.05, num_rows=16, dim=2)
    t, j = _solo(sp, **kw), _solo(jsp, **kw)
    rng = np.random.default_rng(2)
    for lo in (0, 5, 11):
        g = rng.normal(size=(16 - lo, 2)).astype(np.float32)
        t._apply_range(lo, g)
        j._apply_range(lo, g)
    _assert_state_equal(t.shard_state_dict(), j.shard_state_dict())


@pytest.mark.parametrize("updater", UPDATERS)
def test_shard_state_round_trips_across_packages(updater):
    """Each package loads the other's shard state (the rank-local
    checkpoint files), and the rank guard refuses another rank's."""
    t = _solo(sp, updater=updater, num_rows=32, dim=2)
    t._apply_rows(np.array([1, 2, 2]), np.ones((3, 2), np.float32))
    st = t.shard_state_dict()
    j = _solo(jsp, updater=updater, num_rows=32, dim=2)
    j.load_shard_state_dict(st)
    _assert_state_equal(j.shard_state_dict(), st)
    t2 = _solo(sp, updater=updater, num_rows=32, dim=2)
    t2.load_shard_state_dict(j.shard_state_dict())
    _assert_state_equal(t2.shard_state_dict(), st)
    st["lo"] = np.asarray(999)
    with pytest.raises(ValueError, match="different rank"):
        t2.load_shard_state_dict(st)
    if updater == "adam":
        with pytest.raises(ValueError, match="adam moments"):
            t2.load_shard_state_dict({"w": st["w"], "lo": np.asarray(0)})


def test_helpers_match_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 20, size=50)
    grads = rng.normal(size=(50, 3)).astype(np.float32)
    for a, b in zip(sp.sum_duplicate_keys(keys, grads, 3),
                    jsp.sum_duplicate_keys(keys, grads, 3)):
        np.testing.assert_array_equal(a, b)
    codes, scale = sp.quantize_rows_int8(grads, np.random.default_rng(4))
    jcodes, jscale = jsp.quantize_rows_int8(grads,
                                            np.random.default_rng(4))
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(scale, jscale)
    np.testing.assert_array_equal(sp.dequantize_rows_int8(codes, scale),
                                  jsp.dequantize_rows_int8(codes, scale))
    for upd in UPDATERS:
        assert sp.table_state_bytes(64, 4, upd) \
            == jsp.table_state_bytes(64, 4, upd) \
            == _solo(sp, updater=upd).local_bytes()


def test_row_cache_matches_reference():
    """The clock-versioned LRU cache: one seeded sequence of inserts,
    lookups, write-throughs, invalidations and ageing gives the same rows,
    misses and counters in both packages."""
    caches = [m.RowCache(4, 10 * 16) for m in (sp, jsp)]  # 10 rows
    rng = np.random.default_rng(5)
    for step in range(40):
        op = int(rng.integers(0, 4))
        keys = np.unique(rng.integers(0, 24, size=int(rng.integers(1, 8))))
        rows = rng.normal(size=(keys.size, 4)).astype(np.float32)
        clk = step // 4
        outs = []
        for c in caches:
            if op == 0:
                c.insert(keys, rows, clk)
            elif op == 1:
                outs.append(c.lookup(keys, clk, 1))
            elif op == 2:
                c.write_through(keys, rows)
            else:
                c.invalidate(keys[:2])
                c.age(clk, 2)
        if outs:
            (r0, m0), (r1, m1) = outs
            np.testing.assert_array_equal(m0, m1)
            np.testing.assert_array_equal(r0[~m0], r1[~m1])
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].stats()["evictions"] > 0


# --------------------------------------------------------- wire hygiene
def test_malformed_and_misrouted_frames_are_counted():
    """Malformed and mis-routed push frames bump the same per-reason
    counters in both packages and leave the weights untouched."""
    for mod in (sp, jsp):
        t = _solo(mod, updater="sgd", num_rows=64, dim=4)
        w0 = t._w.copy()
        t._on_push(1, {"n": 2, "__blob__": b"\x00" * 7})  # wrong size
        t._on_push(1, {"n": 1, "__blob__": np.int64(99).tobytes()
                       + np.ones(4, np.float32).tobytes()})
        t._on_push_range(1, {"lo": 60, "__blob__":
                             np.ones(8 * 4, np.float32).tobytes()})
        assert t.drops["malformed"] == 1
        assert t.drops["misrouted"] == 2
        assert t.frames_dropped == 3
        np.testing.assert_array_equal(t._w, w0)
        t.check_fatal()


def test_world_size_mismatch_fails_loudly():
    """A peer at another world size poisons the port's table: the frame is
    dropped, pulls are not served, and the next tick raises."""
    buses = mixed_buses(["port", "ref"])
    try:
        t0 = sp.ShardedTable("t", 64, 2, buses[0], 0, 2, updater="sgd",
                             lr=1.0)
        t1 = jsp.ShardedTable("t", 64, 2, buses[1], 1, 2, updater="sgd",
                              lr=1.0)
        tr0 = sp.ShardedPSTrainer({"t": t0}, buses[0], 2,
                                  staleness=float("inf"))
        jsp.ShardedPSTrainer({"t": t1}, buses[1], 2,
                             staleness=float("inf"))
        buses[1].send(0, "psP:t", {"n": 1, "ws": 4, "nr": 128},
                      blob=np.int64(3).tobytes()
                      + np.ones(2, np.float32).tobytes())
        deadline = time.time() + 5
        while not t0.drops["config"] and time.time() < deadline:
            time.sleep(0.02)
        assert t0.drops["config"] == 1
        assert (t0._w == 0).all()
        t0._on_pull(1, {"req": 7, "ws": 4, "nr": 128,
                        "__blob__": np.int64(3).tobytes()})
        t0._on_pull_all(1, {"req": 8, "ws": 4, "nr": 128})
        t0._on_push(1, {"n": 1, "ws": 2, "nr": 64, "dm": 5,
                        "__blob__": b""})
        assert t0.drops["config"] == 4
        with pytest.raises(RuntimeError, match="world_size=4"):
            tr0.tick()
    finally:
        close_all(buses)


# ------------------------------------------------------------ the fleets
def _run_all(n, fn, timeout=30.0):
    """``fn(r)`` for every rank at once (barrier calls), results by rank."""
    out, errs = [None] * n, []

    def go(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a barrier call hung"
    if errs:
        raise errs[0]
    return out


def _drive(kinds, *, updater="adagrad", push_comm="float32", steps=3,
           trainers=False):
    """One serialized workload on a fleet whose node ``i`` is built by
    package ``kinds[i]``: every rank in turn pushes a batch of rows (with
    duplicate keys) and a dense range gradient, then pulls; with
    ``trainers``, every rank also ticks, flushes its residuals, and the
    fleet finalizes, assembles the table and leaves through the shutdown
    barrier, under heartbeat monitors. Returns each rank's shard states,
    every pull in order, and the wire counters."""
    n = len(kinds)
    mods = [module(k, "train.sharded_ps") for k in kinds]
    buses = mixed_buses(kinds)
    monitors = []
    try:
        if trainers:
            monitors = [module(k, "comm.heartbeat").HeartbeatMonitor(
                buses[i], list(range(n)), interval=0.05, timeout=10.0)
                .start() for i, k in enumerate(kinds)]
        mon = (lambda i: monitors[i]) if trainers else (lambda i: None)
        emb = [m.ShardedTable("emb", 96, 8, buses[i], i, n, updater=updater,
                              lr=0.1, init_scale=0.05, seed=5,
                              push_comm=push_comm, pull_timeout=10.0,
                              monitor=mon(i))
               for i, m in enumerate(mods)]
        deep = [m.ShardedTable("deep", 40, 1, buses[i], i, n,
                               updater=updater, lr=0.05, pull_timeout=10.0,
                               async_push=trainers, monitor=mon(i))
                for i, m in enumerate(mods)]
        trs = [m.ShardedPSTrainer({"emb": emb[i], "deep": deep[i]},
                                  buses[i], n, staleness=float("inf"),
                                  gate_timeout=20.0, monitor=mon(i))
               for i, m in enumerate(mods)] if trainers else None
        rng = np.random.default_rng(0)
        pulls = []
        for _ in range(steps):
            for r in range(n):
                keys = rng.integers(0, 96, size=24)
                emb[r].push(keys, rng.normal(size=(24, 8))
                            .astype(np.float32))
                deep[r].push_dense(rng.normal(size=(40, 1))
                                   .astype(np.float32))
                if trainers:
                    deep[r].flush_pushes(timeout=10.0)  # acked = applied
                pulls.append(emb[r].pull(keys))
                pulls.append(deep[r].pull_all())
            for r in range(n if trainers else 0):
                trs[r].tick()
                pulls.append(emb[r].pull_all())  # fence the tick's frames
        finals = None
        if trainers:
            for r in range(n):
                emb[r].residual_flush()
                pulls.append(emb[r].pull_all())
            _run_all(n, lambda r: trs[r].finalize(timeout=20.0))
            finals = _run_all(n, lambda r: (emb[r].pull_all(),
                                            deep[r].pull_all()))
            _run_all(n, lambda r: trs[r].shutdown_barrier(timeout=10.0))
        states = [(emb[r].shard_state_dict(), deep[r].shard_state_dict())
                  for r in range(n)]
        wire = [{"malformed": (trs[r].wire_frames_malformed
                               if trainers else 0),
                 "dropped": emb[r].frames_dropped + deep[r].frames_dropped,
                 "dead": sorted(monitors[r].dead) if trainers else [],
                 "ef": trs[r].ef_stats() if trainers else None}
                for r in range(n)]
        return states, pulls, finals, wire
    finally:
        for m in monitors:
            m.stop()
        close_all(buses)


def _assert_fleets_equal(a, b):
    (sa, pa, fa, _), (sb, pb, fb, _) = a, b
    for (ea, da), (eb, db) in zip(sa, sb):
        _assert_state_equal(ea, eb)
        _assert_state_equal(da, db)
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    if fa is not None:
        for (xe, xd), (ye, yd) in zip(fa, fb):
            np.testing.assert_array_equal(xe, ye)
            np.testing.assert_array_equal(xd, yd)


@pytest.mark.parametrize("updater", UPDATERS)
def test_three_shard_port_fleet_bit_identical_to_reference(updater):
    port = _drive(["port"] * 3, updater=updater)
    ref = _drive(["ref"] * 3, updater=updater)
    _assert_fleets_equal(port, ref)
    # 1/N memory: every shard holds 32 of the 96 rows
    assert port[0][0][0]["w"].shape == (32, 8)


@pytest.mark.parametrize("push_comm", ["float32", "int8", "topk8", "topk4"])
def test_mixed_fleet_equals_reference_fleet(push_comm):
    """Reference and port nodes on one mesh exchange every frame kind of
    the slice (row and range pushes, async-push acks, pulls and pull_all
    and their replies, clocks, the residual flush, finalize's flush and
    ack, the shutdown barrier, heartbeats) and end bit-identical to an
    all-reference fleet, with no frame malformed or dropped and no peer
    taken for dead."""
    ref = _drive(["ref"] * 3, push_comm=push_comm, trainers=True)
    for kinds in (["ref", "port", "ref"], ["port", "ref", "port"]):
        mixed = _drive(kinds, push_comm=push_comm, trainers=True)
        _assert_fleets_equal(mixed, ref)
        for w, wr in zip(mixed[3], ref[3]):
            assert w["malformed"] == w["dropped"] == 0, w
            assert w["dead"] == []
            assert w["ef"] == wr["ef"]
    if push_comm.startswith("topk"):
        assert ref[3][0]["ef"] is not None


def test_pull_times_out_when_owner_is_gone():
    buses = mixed_buses(["port", "port"], handshake=False)
    try:
        t0 = sp.ShardedTable("t", 64, 2, buses[0], 0, 2, pull_timeout=1.5)
        sp.ShardedTable("t", 64, 2, buses[1], 1, 2, pull_timeout=1.5)
        buses[1].close()  # the owner of rows [32, 64) goes away
        with pytest.raises(TimeoutError, match="never replied"):
            t0.pull(np.array([40]))
    finally:
        buses[0].close()


@pytest.mark.parametrize("kinds", [["port", "port"], ["ref", "port"]])
def test_owner_side_admission_parks_and_unparks(kinds):
    """A pull stamped with a too-new clock is parked at the port's owner,
    not served, until the owner's own view admits it."""
    class Cons:
        clock = 5

        def __init__(self):
            self.ok = False

        def admit_pull(self, clk):
            return self.ok or clk <= 0

    buses = mixed_buses(kinds, handshake=False)
    try:
        t0 = module(kinds[0], "train.sharded_ps").ShardedTable(
            "t", 64, 2, buses[0], 0, 2, pull_timeout=10.0)
        t1 = sp.ShardedTable("t", 64, 2, buses[1], 1, 2, updater="sgd",
                             lr=1.0, pull_timeout=10.0)
        c0, c1 = Cons(), Cons()
        c0.ok = True
        t0.bind_consistency(c0)
        t1.bind_consistency(c1)
        t1._apply_rows(np.array([8]), np.ones((1, 2), np.float32))
        got = {}
        th = threading.Thread(
            target=lambda: got.setdefault("rows", t0.pull(np.array([40]))))
        th.start()
        deadline = time.time() + 5
        while not t1._parked and time.time() < deadline:
            time.sleep(0.02)
        assert t1._parked, "pull was served despite denied admission"
        assert th.is_alive()
        c1.ok = True
        t1.serve_parked()
        th.join(timeout=5)
        assert not th.is_alive()
        np.testing.assert_allclose(got["rows"], [[-1.0, -1.0]])
    finally:
        close_all(buses)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("env,kw,match", [
    ({"MINIPS_HIER": "group=2,agg=mesh"}, {}, "item 15"),
    ({}, {"hier": "group=1,agg=mesh"}, "item 15"),
])
def test_unported_layers_refuse_before_any_traffic(env, kw, match,
                                                   monkeypatch):
    """The layer these cases once refused until its ROADMAP item
    (``match``) was done, the hierarchical push tree's mesh aggregator
    (``MINIPS_HIER`` ``agg=mesh``), is ported: arming it builds the
    trainer with the layer armed and still sends no frame before the
    first step."""
    for k in ("MINIPS_REBALANCE", "MINIPS_ELASTIC", "MINIPS_SERVE",
              "MINIPS_AUTOSCALE", "MINIPS_HIER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (bus,) = mixed_buses(["port"], handshake=False)
    sent = []
    bus.publish = lambda *a, **k: sent.append(a)
    bus.send = lambda *a, **k: sent.append(a)
    try:
        t = sp.ShardedTable("t", 16, 2, bus, 0, 1)
        tr = sp.ShardedPSTrainer({"t": t}, bus, 1, **kw)
        assert tr.hier_cfg is not None and tr.hier_cfg.agg == "mesh"
        assert tr.hybrid_stats()["mesh_agg_fallbacks"] == 0
        assert sent == []
    finally:
        bus.close()


def test_mesh_plane_keeps_its_refusal(monkeypatch):
    monkeypatch.setenv("MINIPS_MESH", "1")
    (bus,) = mixed_buses(["port"], handshake=False)
    try:
        with pytest.raises(ValueError, match="plane='mesh'"):
            sp.ShardedPSTrainer({}, bus, 1)
    finally:
        bus.close()


# ------------------------------------------------------ launched jobs
def _job(n, extra, iters=30, **kw):
    return launch.run_local_job(
        n, [sys.executable, "-m", APP, "--iters", str(iters)] + extra,
        env_extra=CPU_RANK, timeout=240.0, **kw)


def test_dense_bsp_replicas_agree():
    res = _job(3, ["--model", "dense", "--mode", "bsp", "--dim", "96",
                   "--updater", "adam", "--lr", "0.05"])
    for r in res:
        assert r["event"] == "done" and r["device"] == "cpu"
        assert r["frames_dropped"] == 0 and r["wire_frames_lost"] == 0, r
        assert r["wire_frames_malformed"] == 0, r
        assert r["loss_last"] < r["loss_first"], r
        assert r["max_skew_seen"] <= 1  # BSP lockstep
        assert r["local_bytes"] * 3 <= r["table_bytes"] * 1.01 + 64
        assert r["clock"] == 30
    sums = [r["param_sum"] for r in res]
    assert max(sums) - min(sums) < 1e-4, sums


def test_sparse_ssp_straggler_bounds_skew():
    res = _job(3, ["--model", "sparse", "--mode", "ssp", "--staleness",
                   "2", "--slow-rank", "1", "--slow-ms", "30"])
    for r in res:
        assert r["event"] == "done"
        assert r["frames_dropped"] == 0 and r["wire_frames_lost"] == 0, r
        assert r["loss_last"] < r["loss_first"], r
        assert r["max_skew_seen"] <= 3  # s + 1
        assert r["local_bytes"] * 3 <= r["table_bytes"] * 1.01 + 64
        # per-key slices on the wire, never a table-sized relay
        assert r["bytes_pushed"] < r["clock"] * (1 << 14) * 4 * 2 / 3
    assert any(r["gate_waits"] > 0 for r in res if r["rank"] != 1)
    sums = [r["param_sum"] for r in res]
    norms = [r["param_norm"] for r in res]
    assert max(sums) - min(sums) < 1e-4, sums
    assert max(norms) - min(norms) < 1e-4, norms


def test_kill_exits_42_then_resumes_from_the_newest_step(tmp_path):
    """Rank 1 dies at step 10: the survivor's heartbeat monitor flags it,
    and rank 0 leaves with the peer_failure event and exit 42. A relaunch
    negotiates the newest step both ranks saved and trains to the end."""
    import os

    ck = str(tmp_path / "ck")
    base = ["--model", "sparse", "--mode", "ssp", "--staleness", "1",
            "--checkpoint-dir", ck, "--checkpoint-every", "4"]
    rcs, events = launch.run_local_job_raw(
        2, [sys.executable, "-m", APP, "--iters", "40", "--kill-at", "10",
            "--kill-rank", "1"] + base,
        env_extra=CPU_RANK, timeout=240.0, per_rank=True)
    last = events[0][-1]
    assert rcs == [42, 137], rcs
    assert last["event"] == "peer_failure" and last["dead"] == [1], last
    assert sorted(os.listdir(os.path.join(ck, "rank1"))) \
        == ["step_0000000004", "step_0000000008"]
    res = _job(2, base, iters=16)
    for r in res:
        assert r["event"] == "done"
        assert r["resumed_from"] == 8, r  # the newest step both saved
        assert r["clock"] == 16
    assert abs(res[0]["param_sum"] - res[1]["param_sum"]) < 1e-4
