"""The port's transport (``minips_tpu_torch/comm``) and SSP gate
(``consistency/gate.py``) against the reference's.

The wire is the contract between the two packages, so the parity that
matters most is a mixed fleet: port buses and reference buses on one
loopback mesh, over zmq, shm and the native mailbox, exchanging
broadcast, directed and blob frames both ways in order, losing none, and
agreeing on ``ClockGossip.global_min``. Around it: the head codec gives
byte-identical frames in both formats, the loss tracker counts alike,
heartbeats and the gate decide alike, and the loud refusals stay loud.
Everything is exact unless a test says otherwise.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from minips_tpu.comm import bus as rbus
from minips_tpu.comm import framing as rframing
from minips_tpu.consistency import gate as rgate
from minips_tpu_torch.comm import bus as pbus
from minips_tpu_torch.comm import framing as pframing
from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor
from minips_tpu_torch.consistency import gate as pgate
from tests.torch_comm_util import (arm_obs, close_all, disarm_obs,
                                   mixed_buses, module, shm_in,
                                   wait_for)

# node i of the mixed meshes: port, reference, port, reference
FLEET = ("port", "ref", "port", "ref")


def _seeded_head(rng: np.random.Generator, i: int) -> dict:
    """A control head of the shapes the stack sends: ints past 2^63,
    floats, nested lists and dicts, bytes, None, bools, unicode."""
    ints = [int(x) for x in rng.integers(-(1 << 40), 1 << 40,
                                         size=int(rng.integers(0, 40)))]
    payload = {
        "clocks": ints[:4], "acks": ints, "req": int(rng.integers(1 << 30)),
        "big": (1 << 70) + i, "ms": float(rng.standard_normal()),
        "why": "stale" if i % 2 else "épocha", "ok": bool(i % 3),
        "none": None, "nested": {"ep": i, "bs": [ints[:3], [i, -i]]},
        "m2": bytes(rng.integers(0, 256, size=i % 7, dtype=np.uint8)),
    }
    if i % 4 == 0:
        del payload["m2"]  # JSON cannot carry bytes: keep some heads plain
    head = {"kind": f"ps{'PGRA'[i % 4]}:t{i % 3}", "sender": i % 5,
            "payload": payload}
    if i % 3 == 1:
        head["bs"] = i
    elif i % 3 == 2:
        head["ds"] = 1000 + i
    return head


@pytest.mark.parametrize("fmt", ["bin", "json"])
def test_framing_byte_identical_and_cross_decodes(fmt):
    rng = np.random.default_rng(1234)
    for i in range(64):
        head = _seeded_head(rng, i)
        if fmt == "json":
            head["payload"].pop("m2", None)
        a = pframing.encode_head(head, fmt)
        b = rframing.encode_head(head, fmt)
        assert a == b, i
        assert pframing.decode_head(b) == rframing.decode_head(a)
        assert pframing.decode_head(a) == rframing.decode_head(b)
        assert pframing.rt_wrap(a) == rframing.rt_wrap(a)
        dec = pframing.decode_head(a)
        assert pframing.dup_msg(dec) == rframing.dup_msg(dec)
    # torn frames decode to None in both
    good = pframing.encode_head(_seeded_head(rng, 5), "bin")
    for cut in (1, 5, len(good) // 2, len(good) - 1):
        assert pframing.decode_head(good[:cut]) is None
        assert rframing.decode_head(good[:cut]) is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frame_loss_tracker_counts_alike(seed):
    """Seeded seq streams with gaps, reorders and duplicates on several
    (sender, stream) pairs, one big jump past the gap cap: the same
    ``lost``, ``dups`` and outstanding gaps in both."""
    rng = np.random.default_rng(seed)
    events = []
    for sender in range(3):
        for stream in "bd":
            seqs = list(range(int(rng.integers(50, 300))))
            seqs = [s for s in seqs if rng.random() > 0.1]       # gaps
            for _ in range(len(seqs) // 8):                       # swaps
                j = int(rng.integers(0, len(seqs) - 1))
                seqs[j], seqs[j + 1] = seqs[j + 1], seqs[j]
            seqs += [int(s) for s in rng.choice(seqs, size=10)]  # dups
            events += [(sender, stream, s) for s in seqs]
    events.append((0, "b", 10_000))  # a jump wider than GAP_CAP's share
    rng.shuffle(events[: len(events) // 2])
    p, r = pbus.FrameLossTracker(), rbus.FrameLossTracker()
    for ev in events:
        p.observe(*ev)
        r.observe(*ev)
    p.note_malformed()
    r.note_malformed()
    assert (p.lost, p.dups, p.malformed) == (r.lost, r.dups, r.malformed)
    assert {k: list(v) for k, v in p._gaps.items()} == \
        {k: list(v) for k, v in r._gaps.items()}
    assert p._next == r._next


def _exchange(buses, n_frames: int = 40, blob_every: int = 3):
    """Every node broadcasts and sends one directed frame to every other
    node, ``n_frames`` rounds, blobs on some; returns what each node got
    as ``{receiver: {sender: [(kind, i, blob)]}}`` once all landed."""
    n = len(buses)
    got = {r: {s: [] for s in range(n) if s != r} for r in range(n)}
    lock = threading.Lock()

    def handler(r, kind):
        def on(sender, payload):
            with lock:
                got[r][sender].append((kind, payload["i"],
                                       payload.get("__blob__")))
        return on

    for r, b in enumerate(buses):
        b.on("bc", handler(r, "bc"))
        b.on("dm", handler(r, "dm"))
    for i in range(n_frames):
        for s, b in enumerate(buses):
            blob = bytes([s, i % 256]) * (i + 1) if i % blob_every == 0 \
                else None
            b.publish("bc", {"i": i}, blob=blob)
            for d in range(n):
                if d != s:
                    b.send(d, "dm", {"i": i, "to": d})
    want = 2 * n_frames
    assert wait_for(lambda: all(len(v) >= want for g in got.values()
                                for v in g.values()), timeout=30.0), \
        {r: {s: len(v) for s, v in g.items()} for r, g in got.items()}
    return got


@pytest.mark.parametrize("layers", ["plain", "chaos+reliable"])
@pytest.mark.parametrize("backend", ["zmq", "shm", "native"])
def test_mixed_fleet_exchanges_in_order(backend, layers, monkeypatch,
                                        tmp_path):
    """Port and reference nodes on one mesh: every (sender, receiver)
    stream arrives whole and in order, broadcast and directed frames in
    their send order, blobs intact, ``frames_lost == 0`` on every node,
    and ``ClockGossip.global_min`` equal on every node; under seeded
    chaos with reliable delivery too (exactly once, in order)."""
    monkeypatch.setenv("MINIPS_RUN_ID", f"tcomm{backend}{layers[0]}")
    shm_in(monkeypatch, tmp_path)
    kw = {"chaos": "77:drop=0.05,dup=0.02", "reliable": "1"} \
        if layers != "plain" else {"chaos": "", "reliable": ""}
    buses = mixed_buses(FLEET, backend, **kw)
    try:
        assert [type(b).__module__.split(".")[0] for b in buses] == \
            ["minips_tpu_torch", "minips_tpu"] * 2
        n_frames = 40
        got = _exchange(buses, n_frames)
        for r, by_sender in got.items():
            for s, frames in by_sender.items():
                assert len(frames) == 2 * n_frames, (r, s)
                assert [i for k, i, _ in frames if k == "bc"] == \
                    list(range(n_frames))
                assert [i for k, i, _ in frames if k == "dm"] == \
                    list(range(n_frames))
                if layers == "plain":
                    # one link: a round's broadcast precedes its directed
                    # frame (under reliable delivery each stream is in
                    # order on its own; a repaired gap in one lets the
                    # other run ahead)
                    order = [(i, k) for k, i, _ in frames]
                    assert order == sorted(order)
                for k, i, blob in frames:
                    if k == "bc":
                        want = bytes([s, i % 256]) * (i + 1) \
                            if i % 3 == 0 else None
                        assert blob == want
        gossips = [module(pkg, "comm.bus").ClockGossip(b, len(buses), 2)
                   for pkg, b in zip(FLEET, buses)]
        clocks = [[5, 6], [3, 9], [7, 7], [4, 8]]
        for g, c in zip(gossips, clocks):
            g.publish_local(c)
        assert wait_for(lambda: [g.global_min() for g in gossips]
                        == [3] * 4, timeout=15.0), \
            [g.snapshot() for g in gossips]
        assert len({str(sorted(g.snapshot().items()))
                    for g in gossips}) == 1
        if layers != "plain":
            assert wait_for(lambda: all(b.reliable.outstanding_gaps() == 0
                                        for b in buses), timeout=15.0)
            assert sum(b.chaos.snapshot()["dropped"] for b in buses) > 0
            assert sum(b.reliable.snapshot()["retransmits_got"]
                       for b in buses) > 0
        assert [b.frames_lost for b in buses] == [0] * 4
        assert [b.frames_malformed for b in buses] == [0] * 4
    finally:
        close_all(buses)


@pytest.mark.parametrize("wire_fmt", ["bin", "json"])
def test_mixed_fleet_blob_exchange_and_wire_formats(wire_fmt):
    """``BlobExchange.allgather`` across port and reference nodes (every
    node holds every node's array, by rank), with the nodes emitting
    either head format (receivers sniff per frame)."""
    buses = mixed_buses(FLEET, "zmq", wire_fmt=wire_fmt)
    try:
        xs = [module(pkg, "comm.bus").BlobExchange(b, len(buses))
              for pkg, b in zip(FLEET, buses)]
        rng = np.random.default_rng(5)
        arrays = [rng.integers(0, 1 << 20, size=int(rng.integers(0, 50)))
                  .astype(np.int64) for _ in buses]
        out = [None] * len(buses)

        def run(i):
            out[i] = xs[i].allgather(1, "keys", arrays[i], timeout=30.0)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(buses))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40.0)
        for got in out:
            assert got is not None
            assert len(got) == len(arrays)
            for a, b in zip(got, arrays):
                np.testing.assert_array_equal(a, b)
        assert [b.wire_fmt for b in buses] == [wire_fmt] * 4
        assert [b.frames_lost for b in buses] == [0] * 4
    finally:
        close_all(buses)


def test_blob_exchange_early_arrival_and_four_round_retention():
    """A port node and a reference node: a round-r+1 array that arrives
    before round r is consumed parks until its round; and each node
    keeps its own frames of the last FOUR rounds per tag for peers that
    ask again (the retention the JAX package widened from two), so a
    request for round r-3 is answered and one for r-4 is not."""
    buses = mixed_buses(("port", "ref"))
    try:
        ex = [module(pkg, "comm.bus").BlobExchange(b, 2)
              for pkg, b in zip(("port", "ref"), buses)]
        arrays = {(r, rnd): np.arange(rnd + r + 1, dtype=np.int64)
                  for r in (0, 1) for rnd in range(6)}
        res1 = {}

        def side1():  # the reference node runs ahead by one round
            for rnd in range(6):
                res1[rnd] = ex[1].allgather(rnd, "emb", arrays[(1, rnd)],
                                            timeout=30)

        th = threading.Thread(target=side1)
        th.start()
        assert wait_for(lambda: 0 in ex[1]._sent.get("emb", {}), timeout=15.0)
        for rnd in range(6):
            got = ex[0].allgather(rnd, "emb", arrays[(0, rnd)], timeout=30)
            for r in (0, 1):
                np.testing.assert_array_equal(got[r], arrays[(r, rnd)])
        th.join(timeout=30)
        for rnd in range(6):
            np.testing.assert_array_equal(res1[rnd][0], arrays[(0, rnd)])
        assert sorted(ex[0]._sent["emb"]) == sorted(ex[1]._sent["emb"]) \
            == [2, 3, 4, 5]
        sent = []
        buses[0].publish = lambda kind, head, blob=None: sent.append(
            (kind, head["round"]))
        ex[0]._on_req(1, {"round": 2, "tag": "emb"})
        ex[0]._on_req(1, {"round": 1, "tag": "emb"})
        assert wait_for(lambda: sent == [("blobx", 2)], timeout=5.0)
        time.sleep(0.1)
        assert sent == [("blobx", 2)]
    finally:
        close_all(buses)


def test_heartbeat_detects_dead_peer():
    """The reference's own drill on port buses, against the same fake
    clock: a silent peer is convicted once, a beating one is not."""
    buses = mixed_buses(("port", "port"), handshake=False)
    try:
        failures = []
        t = [0.0]
        mon = HeartbeatMonitor(buses[0], peer_ids=[0, 1], interval=0.05,
                               timeout=1.0, on_failure=failures.append,
                               clock=lambda: t[0])
        t[0] = 0.5
        mon._on_beat(1, {})
        assert mon.check() == set()
        t[0] = 2.0
        assert mon.check() == {1}
        t[0] = 3.0
        mon.check()
        assert failures == [1]
        assert mon.stats()["dead"] == [1]
    finally:
        close_all(buses)


def test_heartbeat_live_peers_not_flagged_across_packages():
    """Port and reference monitors beating over one mixed mesh for
    several intervals flag nobody."""
    from minips_tpu.comm.heartbeat import HeartbeatMonitor as RMonitor

    buses = mixed_buses(("port", "ref", "port"), handshake=False)
    try:
        mons = [(HeartbeatMonitor if pkg == "port" else RMonitor)(
            b, peer_ids=[0, 1, 2], interval=0.05, timeout=2.0)
            for pkg, b in zip(("port", "ref", "port"), buses)]
        t0 = time.monotonic()
        for m in mons:
            m.start()
        # several intervals: every monitor has heard every peer beat at
        # least five intervals after the start
        assert wait_for(lambda: all(seen >= t0 + 0.25 for m in mons
                                    for seen in m._last_seen.values()),
                        timeout=15.0)
        dead = [m.dead for m in mons]
        for m in mons:
            m.stop()
        assert dead == [set(), set(), set()]
    finally:
        close_all(buses)


def test_heartbeat_spec_knobs_alike(monkeypatch):
    from minips_tpu.comm import heartbeat as rhb
    from minips_tpu_torch.comm import heartbeat as phb

    for spec in ("", "1", "interval=0.1,timeout=0.8",
                 "interval=0.2,timeout=3,stall=1.5"):
        monkeypatch.setenv("MINIPS_HEARTBEAT", spec)
        assert phb.liveness_knobs(1.0, 5.0) == rhb.liveness_knobs(1.0, 5.0)
        assert phb.stall_knob() == rhb.stall_knob()
    for bad in ("interval", "speed=1", "timeout=-1", "interval=2,timeout=1",
                "timeout=x"):
        monkeypatch.setenv("MINIPS_HEARTBEAT", bad)
        with pytest.raises(ValueError) as ep:
            phb.liveness_knobs(1.0, 5.0)
        with pytest.raises(ValueError) as er:
            rhb.liveness_knobs(1.0, 5.0)
        assert str(ep.value) == str(er.value)


def test_admits_agrees_on_a_seeded_grid():
    rng = np.random.default_rng(9)
    grid = [(int(g), int(c), s) for g, c in rng.integers(-5, 60, (400, 2))
            for s in (0, 1, 2, 3, 7, float("inf"))]
    assert [pgate.admits(*x) for x in grid] == \
        [rgate.admits(*x) for x in grid]
    assert pgate.RETIRED_CLOCK == rgate.RETIRED_CLOCK

    class G:
        def __init__(self):
            self.got = []

        def publish_local(self, c):
            self.got.append(c)

    a, b = G(), G()
    for clock, retired in ((3, False), (4, True), (9, False)):
        pgate.publish_clock(a, clock, retired)
        rgate.publish_clock(b, clock, retired)
    assert a.got == b.got


class _Gossip:
    """A ClockGossip stand-in the test moves by hand: ``wait_global_min``
    returns once the scripted view admits, else times out at once."""

    def __init__(self, clocks: dict):
        self.clocks = dict(clocks)
        self.excluded_set: set = set()
        self.timeouts = 0
        self.script: list = []  # views installed one per timed-out wait

    def _min(self):
        vals = [v for p, v in self.clocks.items()
                if p not in self.excluded_set]
        return min(vals) if vals else 0

    def global_min(self):
        return self._min()

    def wait_global_min(self, threshold, timeout=None):
        if self._min() >= threshold:
            return True
        self.timeouts += 1
        if self.script:
            self.clocks.update(self.script.pop(0))
        return self._min() >= threshold

    def snapshot(self):
        return {p: [v] for p, v in self.clocks.items()}

    @property
    def excluded(self):
        return set(self.excluded_set)

    def exclude(self, p):
        self.excluded_set.add(p)


class _Monitor:
    def __init__(self, dead_after: int):
        self.calls = 0
        self.dead_after = dead_after

    def check(self):
        self.calls += 1
        return {2} if self.calls >= self.dead_after else set()


def _run_gate(mod, staleness, steps):
    """Drive a gate through scripted gossip states; returns what a caller
    observes: per step (admitted?, waits, timeouts consumed), then the
    counters."""
    g = _Gossip({0: 0, 1: 0, 2: 0})
    gate = mod.StalenessGate(g, staleness, timeout=60.0)
    seen = []
    for clock, view, script in steps:
        g.clocks.update(view)
        g.script = list(script)
        before = g.timeouts
        gate.wait(clock)
        seen.append((clock, g.timeouts - before, g.global_min()))
    return seen, gate.gate_waits, gate.max_skew_seen


@pytest.mark.parametrize("staleness", [0, 1, 2, float("inf")])
def test_staleness_gate_blocks_and_releases_alike(staleness):
    rng = np.random.default_rng(int(min(staleness, 9)))
    steps, peers = [], {1: 0, 2: 0}
    for clock in range(1, 40):
        # peers trail by 0..3 clocks, and catch up over 0..2 timed waits
        for p in peers:
            peers[p] = max(peers[p], clock - int(rng.integers(0, 4)))
        script = [{p: v + k for p, v in peers.items()}
                  for k in range(1, int(rng.integers(0, 3)) + 1)]
        script.append({p: clock for p in peers})
        steps.append((clock, {0: clock, **peers}, script))
    assert _run_gate(pgate, staleness, steps) == \
        _run_gate(rgate, staleness, steps)


def test_gate_peer_failure_raises_same_dead_set_into_port_flight(
        monkeypatch, tmp_path):
    """A gate blocked on a peer the monitor convicts raises
    ``PeerFailureError`` naming the same dead set in both packages, and
    the port's ``gate_peer_failure`` lands in the port's flight recorder,
    not the reference's."""
    recs = arm_obs(monkeypatch, tmp_path, trace=True)
    try:
        errors = {}
        for name, mod in (("port", pgate), ("ref", rgate)):
            g = _Gossip({0: 10, 1: 10, 2: 3})
            g.script = [{}] * 10
            gate = mod.StalenessGate(g, 2, timeout=60.0,
                                     monitor=_Monitor(dead_after=3))
            with pytest.raises(mod.PeerFailureError) as e:
                gate.wait(10)
            errors[name] = (e.value.dead, str(e.value), g.excluded)
            assert isinstance(e.value, RuntimeError)
        assert errors["port"] == errors["ref"] == \
            ({2}, "peer process(es) [2] failed", {2})
        for pkg, (flight, tracer) in recs.items():
            kinds = [k for _, k, _ in flight._reasons]
            assert kinds == ["gate_peer_failure"], (pkg, kinds)
            assert flight._reasons[0][2] == {"clock": 10, "dead": [2]}
            spans = [e for e in tracer.events_snapshot()
                     if e[4] == "gate_wait"]
            assert len(spans) == 1 and spans[0][7]["behind"] == [2]
        port_flight = recs["port"][0]
        import json
        with open(port_flight.out_path) as f:
            box = json.load(f)
        assert [r["kind"] for r in box["reasons"]] == ["gate_peer_failure"]
        assert str(tmp_path / "port") in port_flight.out_path
        # FencedOutError is a PeerFailureError naming the fenced rank
        f = pgate.FencedOutError(3, 7)
        assert isinstance(f, pgate.PeerFailureError) and f.dead == {3}
        assert str(f) == str(rgate.FencedOutError(3, 7))
    finally:
        disarm_obs()


def test_gate_deadline_poisons_port_flight(monkeypatch, tmp_path):
    recs = arm_obs(monkeypatch, tmp_path)
    try:
        g = _Gossip({0: 5, 1: 0})
        gate = pgate.StalenessGate(g, 1, timeout=0.05)
        with pytest.raises(TimeoutError, match="SSP gate timed out"):
            gate.wait(5)
        assert [k for _, k, _ in recs["port"][0]._reasons] == \
            ["gate_deadline"]
        assert recs["ref"][0]._reasons == []
    finally:
        disarm_obs()


def test_make_bus_refuses_loudly_and_never_falls_back(monkeypatch):
    """The zmq default without pyzmq, a native mailbox that cannot load,
    an unknown backend and shm on a weakly ordered host each raise the
    reference's error; none turns into another backend."""
    from minips_tpu_torch.comm import native_bus, shm_bus

    monkeypatch.delenv("MINIPS_BUS", raising=False)
    addr, peers = "tcp://127.0.0.1:1", ["tcp://127.0.0.1:2"]
    monkeypatch.setattr(pbus, "_HAS_ZMQ", False)
    with pytest.raises(RuntimeError, match="pyzmq not available"):
        pbus.make_bus(addr, peers)
    monkeypatch.setattr(native_bus.NativeControlBus, "available",
                        staticmethod(lambda: False))
    with pytest.raises(RuntimeError, match="MINIPS_BUS=native requested"):
        pbus.make_bus(addr, peers, backend="native")
    with pytest.raises(ValueError, match="unknown bus backend"):
        pbus.make_bus(addr, peers, backend="tcp")
    monkeypatch.setattr(shm_bus.platform, "machine", lambda: "aarch64")
    with pytest.raises(RuntimeError, match="requires a 64-bit x86"):
        pbus.make_bus(addr, peers, backend="shm")


def test_port_layers_record_into_port_singletons(monkeypatch, tmp_path):
    """The port's bus layers, heartbeat and gate consult the port's
    tracer and flight recorder: armed only on the port side, a chaos
    drop, a retransmit and a heartbeat sample show up there; armed only
    on the reference side, nothing from a port bus shows up there."""
    from minips_tpu.obs import flight as rflight
    from minips_tpu.obs import tracer as rtracer

    recs = arm_obs(monkeypatch, tmp_path, trace=True)
    rflight.reset_for_tests()
    rtracer.reset_for_tests()
    try:
        buses = mixed_buses(("port", "port"), chaos="3:drop=0.2",
                            reliable="1")
        try:
            mons = [HeartbeatMonitor(b, [0, 1], interval=0.05, timeout=5.0)
                    for b in buses]
            for m in mons:
                m.start()
            got = []
            buses[1].on("x", lambda s, p: got.append(p["i"]))
            for i in range(60):
                buses[0].send(1, "x", {"i": i})
            assert wait_for(lambda: got == list(range(60)), timeout=20.0)
            assert wait_for(lambda: recs["port"][0]._hb and any(
                e[4] == "hb" for e in recs["port"][1].events_snapshot()),
                timeout=15.0)
            for m in mons:
                m.stop()
        finally:
            close_all(buses)
        names = {e[4] for e in recs["port"][1].events_snapshot()}
        assert {"drop", "retransmit", "hb"} <= names, names
        assert recs["port"][0]._hb  # min-filtered heartbeat delays
        assert rflight.FLIGHT is None and rtracer.TRACER is None
    finally:
        disarm_obs()
