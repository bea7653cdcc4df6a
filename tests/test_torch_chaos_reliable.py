"""The port's fault injector and reliable delivery (``comm/chaos.py``,
``comm/reliable.py``) against the reference's.

Both are pure functions of their inputs where it matters: a chaos spec
parses to the same schedule, each frame identity draws the same fate,
and one loss pattern through either package's ``ReliableChannel``
(driven by hand against fake buses and one fake clock, no threads)
delivers the same sequence, exactly once and in order, with the same
NACK and retransmit counts. Then the layers on real port buses, and the
seeded kill schedule. Exact unless a test says otherwise.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from minips_tpu.comm import bus as rbus
from minips_tpu.comm import chaos as rchaos
from minips_tpu.comm import reliable as rrel
from minips_tpu_torch.comm import bus as pbus
from minips_tpu_torch.comm import chaos as pchaos
from minips_tpu_torch.comm import reliable as prel
from tests.torch_comm_util import (close_all, flush_link, mixed_buses, shm_in,
                                   wait_for)

SPECS = [
    "123:drop=0.01,dup=0.005,delay=0.1,delay_ms=7,reorder=0.02,"
    "reorder_ms=33",
    "99",
    "7:drop=0.01,drop@psr=0.5,drop#2=0.2,drop@psr#2=0.9",
    "7:drop@ps=0.1,drop@psr=0.4",
    "11:part=1,links=0-1+0>2,at=8,for=3s",
    "5:part=1,links=0-1,at=2-6,for=4-9,part=2,links=1>2,at=1.5s,for=2s",
    "3:slow#0>1=100",
    "11:slow#1>0=40,slow#1>2=40~8,drop=0.01",
    "1337:drop=0.01,dup=0.005,reorder=0.01",
]

GARBAGE = [
    "notanint:drop=0.1", "1:explode=0.5", "1:drop=1.5", "1:drop=-0.1",
    "1:drop", "1:drop#x=0.1", "1:drop=abc", "1:links=0-1",
    "1:part=1", "1:part=x,links=0-1", "1:part=1,links=0-0",
    "1:part=1,links=a-b", "1:part=1,links=0-1,at=5-2",
    "1:part=1,links=0-1,for=xs", "1:slow#0>1=0", "1:slow#0>1=5~-1",
    "1:slow#0-0=5", "1:slow#0>1=fast", "1:at=3",
]


def _spec_view(spec) -> dict:
    return {"seed": spec.seed, "rates": spec.rates,
            "delay_ms": spec.delay_ms, "reorder_ms": spec.reorder_ms,
            "slow": spec.slow, "active": spec.active(),
            "parts": [([getattr(p, k) for k in p.__slots__],
                       p.resolve(spec.seed),
                       [p.cuts(a, b) for a in range(3) for b in range(3)])
                      for p in spec.partitions]}


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_alike(spec):
    p, r = pchaos.ChaosSpec.parse(spec), rchaos.ChaosSpec.parse(spec)
    assert _spec_view(p) == _spec_view(r)
    for op in ("drop", "dup", "delay", "reorder"):
        for kind in ("psr:t", "psP:t", "clock", "heartbeat"):
            for sender in range(4):
                assert p.rate(op, kind, sender) == r.rate(op, kind, sender)


def test_chaos_spec_rejects_the_same_garbage():
    for spec in GARBAGE:
        with pytest.raises(ValueError) as ep:
            pchaos.ChaosSpec.parse(spec)
        with pytest.raises(ValueError) as er:
            rchaos.ChaosSpec.parse(spec)
        assert str(ep.value) == str(er.value), spec


class _WireBus:
    """A receiver bus for ChaosBus: the survivors land in ``got`` through
    the package's own ``deliver_post_wire`` (no reliable layer)."""

    def __init__(self, mod, my_id: int):
        self.my_id = my_id
        self._handlers: dict = {}
        self.loss = mod.FrameLossTracker()
        self.got: list = []
        self._handlers["x"] = lambda s, p: self.got.append(
            (s, p["stream"], p["seq"]))


def _wire_frames(rng, n: int) -> list[dict]:
    frames, seqs = [], {}
    for _ in range(n):
        sender = int(rng.integers(0, 3))
        stream = "bs" if rng.random() < 0.5 else "ds"
        seq = seqs.get((sender, stream), 0)
        seqs[(sender, stream)] = seq + 1
        frames.append({"kind": "x", "sender": sender, stream: seq,
                       "payload": {"stream": stream[0], "seq": seq}})
    return frames


def _run_chaos(mchaos, mbus, spec: str, frames, my_id: int = 3):
    bus = _WireBus(mbus, my_id)
    cb = mchaos.ChaosBus(bus, spec)
    try:
        draws = [cb._u(op, f["sender"], "b" if "bs" in f else "d",
                       f.get("bs", f.get("ds")))
                 for f in frames for op in ("drop", "dup", "delay")]
        for f in frames:
            cb.on_wire(json.loads(json.dumps(f)), None)
        n = len(frames) - cb.snapshot()["dropped"] \
            + cb.snapshot()["duplicated"]
        assert wait_for(lambda: len(bus.got) >= n, timeout=10.0)
        return draws, cb.snapshot(), bus.got
    finally:
        cb.stop()


def _first_seen(got: list) -> list:
    return list(dict.fromkeys(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_fates_identical_per_frame(seed):
    """Each frame identity draws the same uniform and the same fate in
    both packages: with drop and dup only, the same frames arrive the
    same number of times, the survivors in the same order (a duplicate
    comes later, from the scheduler thread, whose timing is the host's);
    with delay and reorder the same frames arrive with the same
    counters."""
    rng = np.random.default_rng(seed)
    frames = _wire_frames(rng, 400)
    spec = f"{40 + seed}:drop=0.1,dup=0.05"
    dp, sp, gp = _run_chaos(pchaos, pbus, spec, frames)
    dr, sr, gr = _run_chaos(rchaos, rbus, spec, frames)
    assert dp == dr and sp == sr and sorted(gp) == sorted(gr)
    assert _first_seen(gp) == _first_seen(gr)
    assert sp["dropped"] > 0 and sp["duplicated"] > 0
    spec = f"{40 + seed}:drop=0.05,delay=0.05,delay_ms=3,reorder=0.05," \
           f"reorder_ms=5"
    dp, sp, gp = _run_chaos(pchaos, pbus, spec, frames)
    dr, sr, gr = _run_chaos(rchaos, rbus, spec, frames)
    assert dp == dr and sp == sr and sorted(gp) == sorted(gr)
    assert sp["delayed"] > 0 and sp["reordered"] > 0


def test_kill_spec_resolves_alike(monkeypatch):
    for spec in ("7:rank=2,step=12", "7:rank=0,step=12,rank=1,step=20",
                 "9:rank=-1,step=5-30", "3:rank=1,step=30"):
        p, r = pchaos.KillSpec.parse(spec), rchaos.KillSpec.parse(spec)
        for n in (2, 3, 4):
            assert p.resolve_all(n) == r.resolve_all(n)
    for bad in ("7:rank=2", "7:step=3", "7:rank=1,speed=2", "x:rank=1,step=1"):
        with pytest.raises(ValueError) as ep:
            pchaos.KillSpec.parse(bad)
        with pytest.raises(ValueError) as er:
            rchaos.KillSpec.parse(bad)
        assert str(ep.value) == str(er.value)
    monkeypatch.setenv("MINIPS_CHAOS_KILL", "3:rank=1,step=30")
    assert pchaos.install_chaos_kill(0, 2) is None  # aimed elsewhere
    assert callable(pchaos.install_chaos_kill(1, 2))
    monkeypatch.setenv("MINIPS_CHAOS_KILL", "")
    assert pchaos.install_chaos_kill(1, 2) is None


# ------------------------------------------ reliable delivery, by hand
class _FakeBus:
    """Just enough bus for ReliableChannel: handlers, the package's loss
    tracker, and a log of sent frames the test routes by hand."""

    def __init__(self, mbus, my_id: int):
        self.my_id = my_id
        self._handlers: dict = {}
        self.loss = mbus.FrameLossTracker()
        self.sent: list = []
        self._bseq = 0
        self._dseq = ()

    def on(self, kind, handler):
        self._handlers[kind] = handler

    def send(self, dest, kind, payload, blob=None):
        self.sent.append((dest, kind, payload, blob))

    def publish(self, kind, payload, blob=None):
        self.sent.append((-1, kind, payload, blob))


def _schedule(seed: int):
    """A seeded wire: frames 0..n-1 of one directed stream, some lost,
    some duplicated, some arriving out of order, the tail possibly lost
    (then only the sender's top advert reveals it)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 120))
    arrivals = []
    for i in range(n):
        u = rng.random()
        if u < 0.15:
            continue                       # the wire ate it
        arrivals.append(i)
        if u > 0.93:
            arrivals.append(i)             # duplicated
    for _ in range(n // 10):               # adjacent swaps
        j = int(rng.integers(0, len(arrivals) - 1))
        arrivals[j], arrivals[j + 1] = arrivals[j + 1], arrivals[j]
    journal = int(rng.integers(8, 200))    # small rings evict: GONE
    budget = int(rng.integers(2, 12))
    return n, arrivals, journal, budget


def _run_reliable(mrel, mbus, seed: int) -> dict:
    n, arrivals, journal, budget = _schedule(seed)
    clk = [0.0]
    tx_bus, rx_bus = _FakeBus(mbus, 0), _FakeBus(mbus, 1)
    kw = dict(clock=lambda: clk[0], start_thread=False,
              journal_frames=journal, retry_budget=budget)
    tx = mrel.ReliableChannel(tx_bus, **kw)
    rx = mrel.ReliableChannel(rx_bus, **kw)
    got = []
    rx_bus.on("x", lambda s, p: got.append(p["i"]))
    heads = []
    for i in range(n):
        head = {"kind": "x", "sender": 0, "payload": {"i": i}, "ds": i}
        heads.append(head)
        tx.journal_stamped("d", 1, i, json.dumps(head).encode(), None)
    for i in arrivals:
        rx.on_stamped(json.loads(json.dumps(heads[i])), None)
    rx._on_top(0, {"b": 0, "d": {"1": n}})   # the sender's stream top
    for _ in range(400):
        clk[0] += 0.1
        rx.pump(clk[0])
        for _dest, kind, payload, _blob in rx_bus.sent:
            if kind == mrel.NACK_KIND:
                tx._on_nack(1, payload)
        rx_bus.sent.clear()
        for _dest, kind, payload, blob in tx_bus.sent:
            if kind == mrel.RT_KIND:
                rx._on_rt(0, dict(payload))
            elif kind == mrel.GONE_KIND:
                rx._on_gone(0, payload)
        tx_bus.sent.clear()
        if rx.outstanding_gaps() == 0:
            break
    return {"got": got, "tx": dict(tx.stats), "rx": dict(rx.stats),
            "lost": rx_bus.loss.lost, "dups": rx_bus.loss.dups,
            "gaps": rx.outstanding_gaps()}


@pytest.mark.parametrize("seed", range(6))
def test_reliable_channel_delivers_alike(seed):
    p = _run_reliable(prel, pbus, seed)
    r = _run_reliable(rrel, rbus, seed)
    assert p == r
    got = p["got"]
    assert got == sorted(set(got))               # once each, in order
    n = _schedule(seed)[0]
    assert len(got) + p["lost"] == n             # the rest counted lost
    assert p["gaps"] == 0
    assert p["rx"]["nacks_sent"] > 0 and p["tx"]["retransmits_sent"] > 0


def test_reliable_install_knobs_alike():
    for spec in ("1", "journal=2048,budget=10,backoff_ms=25,advert_ms=200",
                 "journal_bytes=4096,settle_ms=2,idle_tick_ms=50"):
        chans = []
        for mrel, mbus in ((prel, pbus), (rrel, rbus)):
            fb = _FakeBus(mbus, 0)
            ch = mrel.ReliableChannel.install(fb, spec)
            ch.stop()
            chans.append({k: getattr(ch, k) for k in (
                "journal_frames", "journal_bytes", "retry_budget",
                "backoff_s", "backoff_max_s", "advert_s", "settle_s",
                "idle_tick_s", "buffer_cap")})
        assert chans[0] == chans[1]
    for mrel, mbus in ((prel, pbus), (rrel, rbus)):
        with pytest.raises(ValueError, match="unknown reliable knob"):
            mrel.ReliableChannel.install(_FakeBus(mbus, 0), "retries=3")


# ------------------------------------------------- on real port buses
@pytest.mark.parametrize("backend", ["zmq", "shm"])
def test_port_buses_chaos_reliable_exactly_once(backend, monkeypatch,
                                                tmp_path):
    """Seeded drop, dup and reorder on port buses under reliable
    delivery: a directed flood and a broadcast flood arrive exactly once
    and in order, nothing unrecovered, and the layers provably worked."""
    monkeypatch.setenv("MINIPS_RUN_ID", f"tchaos{backend}")
    shm_in(monkeypatch, tmp_path)
    buses = mixed_buses(("port", "port"), backend,
                        chaos="4242:drop=0.08,dup=0.03,reorder=0.04",
                        reliable="1")
    try:
        got_d, got_b = [], []
        buses[1].on("d", lambda s, p: got_d.append(p["i"]))
        buses[1].on("b", lambda s, p: got_b.append(p["i"]))
        n = 300
        for i in range(n):
            buses[0].send(1, "d", {"i": i})
            buses[0].publish("b", {"i": i}, blob=bytes(i % 7))
        assert wait_for(lambda: len(got_d) >= n and len(got_b) >= n,
                        timeout=30.0), (len(got_d), len(got_b))
        time.sleep(0.1)
        assert got_d == list(range(n)) and got_b == list(range(n))
        assert buses[1].frames_lost == 0
        assert buses[1].chaos.snapshot()["dropped"] > 0
        assert buses[1].reliable.snapshot()["retransmits_got"] > 0
    finally:
        close_all(buses)


def test_port_buses_chaos_without_reliable_loses_loudly(monkeypatch):
    """The same drops with retransmit off are counted, never silent."""
    buses = mixed_buses(("port", "port"), "zmq", chaos="4242:drop=0.08",
                        reliable="")
    try:
        got = []
        buses[1].on("d", lambda s, p: got.append(p["i"]))
        flush_link(buses[0], buses[1])  # the handshake's frames land first
        before = buses[1].chaos.snapshot()
        for i in range(300):
            buses[0].send(1, "d", {"i": i})

        def dropped():
            return buses[1].chaos.snapshot()["dropped"] - before["dropped"]

        assert wait_for(lambda: buses[1].chaos.snapshot()["frames"]
                        - before["frames"] >= 300
                        and len(got) + dropped() == 300, timeout=30.0)
        assert dropped() > 0
        assert got == sorted(got)
        assert getattr(buses[1], "reliable", None) is None
        # the first frame seen syncs the stream and a lost tail has no
        # successor to expose it: every hole in between is counted
        assert buses[1].frames_lost == got[-1] - got[0] + 1 - len(got) > 0
    finally:
        close_all(buses)
