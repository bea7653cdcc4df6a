"""The port's observability layer (``minips_tpu_torch/obs``) against the
reference's, on the same seeded inputs.

Flow ids, the tracer's Chrome-trace dump (apart from timestamps), the
cross-rank merge and the blocked-time report are identical; the windowed
metrics, SLO burn tracking, fail-slow detection and freshness give the
same quantiles, rates, verdicts and records under one injected clock;
each package's flight dumps load and merge with the other's loader; and
the port's checkpointer records ``ckpt_skip_torn``. Exact throughout.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from minips_tpu.obs import flight as rflight
from minips_tpu.obs import freshness as rfresh
from minips_tpu.obs import hist as rhist
from minips_tpu.obs import merge as rmerge
from minips_tpu.obs import report as rreport
from minips_tpu.obs import slo as rslo
from minips_tpu.obs import slowness as rslow
from minips_tpu.obs import tracer as rtracer
from minips_tpu.obs import window as rwindow
from minips_tpu_torch.obs import flight as pflight
from minips_tpu_torch.obs import freshness as pfresh
from minips_tpu_torch.obs import hist as phist
from minips_tpu_torch.obs import merge as pmerge
from minips_tpu_torch.obs import report as preport
from minips_tpu_torch.obs import slo as pslo
from minips_tpu_torch.obs import slowness as pslow
from minips_tpu_torch.obs import tracer as ptracer
from minips_tpu_torch.obs import window as pwindow
from tests.torch_comm_util import arm_obs, disarm_obs

PKGS = {"port": (ptracer, pflight, pmerge, preport, pwindow, pslo, pslow,
                 pfresh, phist),
        "ref": (rtracer, rflight, rmerge, rreport, rwindow, rslo, rslow,
                rfresh, rhist)}


def test_flow_id_equal():
    rng = np.random.default_rng(0)
    for kind in ("pull:emb", "pull:wide", "push:emb", "ping"):
        for rank, seq in rng.integers(0, 1 << 40, size=(50, 2)):
            assert ptracer.flow_id(kind, int(rank), int(seq)) == \
                rtracer.flow_id(kind, int(rank), int(seq))


def _record_stream(tr, rng) -> None:
    t = 100.0
    for i in range(200):
        u = rng.random()
        t += float(rng.random())
        if u < 0.3:
            tr.complete("pull", "pull_leg", t, {"owner": int(i % 3),
                                                "rid": i}, t1=t + 0.002)
        elif u < 0.5:
            tr.instant("hb", "hb", {"from": int(i % 3), "t_sent": t})
        elif u < 0.7:
            tr.flow("s" if i % 2 else "f", tr_flow(i), "pull",
                    {"rid": i})
        elif u < 0.9:
            tr.complete("clock", "gate_wait", t, {"clock": i,
                                                  "behind": [1]},
                        t1=t + 0.01)
        else:
            tr.instant("chaos", "drop", {"kind": "x", "sender": 1,
                                         "seq": i})


def tr_flow(i):
    return ptracer.flow_id("pull:t", 1, i)


def _strip_ts(doc: dict) -> dict:
    return {**doc, "traceEvents": [{k: v for k, v in e.items() if k != "ts"}
                                   for e in doc["traceEvents"]]}


def test_tracer_dumps_equal_chrome_json(tmp_path):
    """A seeded event stream recorded by both tracers dumps the same
    Chrome-trace JSON apart from the instants' timestamps."""
    docs = {}
    for pkg, mods in PKGS.items():
        tr = mods[0].Tracer(2, str(tmp_path / pkg), cap=150)
        _record_stream(tr, np.random.default_rng(11))
        with open(tr.dump()) as f:
            docs[pkg] = json.load(f)
        assert tr.out_path.endswith("trace-rank2.json")
    assert _strip_ts(docs["port"]) == _strip_ts(docs["ref"])
    assert docs["port"]["otherData"]["events"] == 150  # the ring's cap
    spans = [e for e in docs["port"]["traceEvents"] if e["ph"] == "X"]
    assert spans and all(e["dur"] in (2000.0, 10000.0) for e in spans)
    for e in spans:  # spans carry the caller's own start, exactly
        twin = next(x for x in docs["ref"]["traceEvents"]
                    if x["ph"] == "X" and x.get("args") == e["args"])
        assert twin["ts"] == e["ts"]


def _synthetic_rank_traces(directory, seed: int, ranks=(0, 1, 2)):
    """Per-rank Chrome traces with skewed clocks: heartbeat instants in
    both directions (the offset estimate's input), pull flows between
    ranks, gate waits naming stragglers and pull waits naming owners."""
    rng = np.random.default_rng(seed)
    skew = {r: float(rng.integers(-5000, 5000)) for r in ranks}
    os.makedirs(directory, exist_ok=True)
    for r in ranks:
        ev = [{"ph": "M", "pid": r, "tid": 0, "name": "process_name",
               "args": {"name": f"rank {r}"}}]
        t = 1e6
        for i in range(120):
            t += float(rng.integers(100, 3000))
            local = t + skew[r]
            peer = int(rng.choice([p for p in ranks if p != r]))
            delay = float(rng.integers(50, 400))
            ev.append({"ph": "i", "ts": local, "cat": "hb", "name": "hb",
                       "pid": r, "tid": 1, "s": "t",
                       "args": {"from": peer, "t_sent":
                                (t - delay + skew[peer]) / 1e6}})
            fid = rtracer.flow_id("pull:t", r, i)
            ev.append({"ph": "s", "ts": local, "cat": "flow",
                       "name": "pull", "pid": r, "tid": 1, "id": fid})
            if rng.random() < 0.8:  # the owner's end, under its pid
                ev.append({"ph": "f", "ts": local + 20, "cat": "flow",
                           "name": "pull", "pid": peer, "tid": 2,
                           "id": fid, "bp": "e"})
            ev.append({"ph": "X", "ts": local, "dur": delay, "cat": "pull",
                       "name": "pull_leg", "pid": r, "tid": 1,
                       "args": {"owner": peer, "rid": i}})
            ev.append({"ph": "X", "ts": local - 10, "dur": delay + 30,
                       "cat": "pull", "name": "pull_wait", "pid": r,
                       "tid": 1, "args": {"owners": [peer]}})
            if rng.random() < 0.3:
                ev.append({"ph": "X", "ts": local + 500,
                           "dur": float(rng.integers(10, 900)),
                           "cat": "clock", "name": "gate_wait", "pid": r,
                           "tid": 1, "args": {"clock": i,
                                              "behind": [peer]}})
            if rng.random() < 0.1:
                ev.append({"ph": "X", "ts": local + 900, "dur": 55.0,
                           "cat": "rebalance", "name": "fence_wait",
                           "pid": r, "tid": 1})
        with open(os.path.join(directory, f"trace-rank{r}.json"), "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                       "otherData": {"rank": r}}, f)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_and_report_identical(tmp_path, seed):
    _synthetic_rank_traces(tmp_path / "t", seed)
    p_doc, p_sum = pmerge.merge_traces([str(tmp_path / "t")])
    r_doc, r_sum = rmerge.merge_traces([str(tmp_path / "t")])
    assert p_doc == r_doc and p_sum == r_sum
    assert p_sum["flows_linked"] > 0 and p_sum["unaligned_ranks"] == []
    assert set(p_sum["clock_offsets_us"]) == {"0", "1", "2"}
    p_att, r_att = preport.attribute(p_doc), rreport.attribute(r_doc)
    assert p_att == r_att
    assert any(k.startswith("gate ") for a in p_att.values() for k in a["by"])
    assert preport.format_table(p_att) == rreport.format_table(r_att)
    # the CLIs write the same merged file
    outs = {}
    for pkg, mod in (("port", pmerge), ("ref", rmerge)):
        out = str(tmp_path / f"merged-{pkg}.json")
        assert mod.main([str(tmp_path / "t"), "-o", out]) == 0
        with open(out) as f:
            outs[pkg] = json.load(f)
    assert outs["port"] == outs["ref"]
    assert preport.main([str(tmp_path / "merged-port.json"), "--json"]) == 0


def test_merge_xla_refuses_until_ported(tmp_path):
    _synthetic_rank_traces(tmp_path / "t", 3, ranks=(0, 1))
    with pytest.raises(NotImplementedError, match="item 17"):
        pmerge.merge_traces([str(tmp_path / "t")], xla_logdir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 17"):
        pmerge.main([str(tmp_path / "t"), "--xla", str(tmp_path)])
    assert pmerge.main([str(tmp_path / "empty")]) == 1
    assert pmerge.XLA_PID_BASE == rmerge.XLA_PID_BASE


def _feed_window(pkg: str, seed: int):
    """One WindowedMetrics per package under an injected clock, fed the
    same seeded latencies, counters and gauges; returns every read."""
    _, _, _, _, mwin, _, _, _, mhist = PKGS[pkg]
    rng = np.random.default_rng(seed)
    t = [0.0]
    ow = mwin.WindowedMetrics(window=4, ring=16, clock=lambda: t[0])
    h = mhist.Log2Histogram()
    ctr = [0.0]
    gauge = [0.0]
    ow.register_hist("pull_latency", lambda: h.counts)
    ow.register_counter("shed", lambda: ctr[0])
    ow.register_gauge("gap_age", lambda: gauge[0])
    reads = []
    for roll in range(24):
        scale = 10.0 ** rng.uniform(1, 5)
        for us in rng.exponential(scale, size=int(rng.integers(0, 60))):
            h.record_us(float(us))
        ctr[0] += float(rng.integers(0, 40))
        gauge[0] = float(rng.random())
        t[0] += float(rng.uniform(0.5, 2.0))
        ow.roll()
        reads.append((
            [ow.quantile_ms("pull_latency", q) for q in (0.5, 0.95, 0.99)],
            ow.quantile_ms("pull_latency", 0.99, window=2),
            ow.rate("shed"), ow.rate("shed", window=1),
            ow.delta_sum("shed"), ow.gauge("gap_age"),
            ow.gauge("gap_age", agg="max"),
            ow.window_counts("pull_latency"),
            ow.summarize("pull_latency"), ow.record()))
    return reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_identical_under_injected_clock(seed):
    assert _feed_window("port", seed) == _feed_window("ref", seed)


def test_window_and_slo_and_slowness_specs_parse_alike():
    cases = {
        "window": (pwindow.ObsWindowConfig.parse,
                   rwindow.ObsWindowConfig.parse,
                   ["", "1", "0", "window=4,ring=16", "window=2"],
                   ["cap=9", "window", "window=16,ring=4", "window=x"]),
        "slo": (pslo.SloConfig.parse, rslo.SloConfig.parse,
                ["", "0", "1", "fresh_ms=50,read_ms=20,shed_rate=5,fast=3,"
                 "slow=12", "read_ms=5,shed_rate=2,fast=2,slow=4,boost=1"],
                ["fast=5,slow=2", "read_ms=nan", "speed=3", "read_ms"]),
        "slow": (pslow.SlownessConfig.parse, rslow.SlownessConfig.parse,
                 ["", "0", "1", "factor=2.5,windows=4,window=6,min_ms=5",
                  "factor=3,windows=2,window=5,min_ms=15,min_samples=2,"
                  "demote=4"],
                 ["factor=1", "windows=0", "speed=3", "windows"]),
    }
    for name, (pp, rp, good, bad) in cases.items():
        for spec in good:
            a, b = pp(spec), rp(spec)
            assert (a is None) == (b is None), (name, spec)
            if a is not None:
                assert {k: v for k, v in vars(a).items()} == \
                    {k: v for k, v in vars(b).items()}, (name, spec)
        for spec in bad:
            with pytest.raises(ValueError) as ep:
                pp(spec)
            with pytest.raises(ValueError) as er:
                rp(spec)
            assert str(ep.value) == str(er.value), (name, spec)


def _run_slo(pkg: str, seed: int):
    _, _, _, _, mwin, mslo, _, _, mhist = PKGS[pkg]
    rng = np.random.default_rng(seed)
    t = [0.0]
    ow = mwin.WindowedMetrics(window=4, ring=16, clock=lambda: t[0])
    hists = {n: mhist.Log2Histogram() for n in ("a", "b")}
    sheds = {n: [0] for n in ("a", "b")}
    for n in ("a", "b"):
        ow.register_hist(f"pull_latency:{n}", lambda h=hists[n]: h.counts)
        ow.register_counter(f"shed:{n}", lambda s=sheds[n]: s[0])
    sl = mslo.SloTracker(mslo.SloConfig.parse(
        "read_ms=1,shed_rate=5,fast=2,slow=4,boost=2"), ow, ["a", "b"])
    out = []
    for roll in range(30):
        bad = (roll // 6) % 2 == 0  # tenant a alternates storms and calm
        for _ in range(20):
            hists["a"].record_us(float(rng.uniform(5e3, 2e4) if bad
                                       else rng.uniform(50, 300)))
            hists["b"].record_us(float(rng.uniform(50, 300)))
        sheds["b"][0] += int(rng.integers(0, 12))
        t[0] += 1.0
        ow.roll()
        sl.on_roll()
        sl.note_budget("a", int(rng.integers(0, 4)))
        out.append((sl.burning_tenants(), sl.replica_boost("a"),
                    sl.pressure_quanta(), sl.record()))
    return out


def test_slo_tracker_identical():
    p, r = _run_slo("port", 4), _run_slo("ref", 4)
    assert p == r
    assert any(b for b, *_ in p) and p[-1][3]["burns"] > 1


def _run_slowness(pkg: str, seed: int):
    mslow = PKGS[pkg][6]
    rng = np.random.default_rng(seed)
    t = [0.0]
    cfg = mslow.SlownessConfig(factor=3.0, windows=2, window=2,
                               min_ms=5.0, min_samples=2)
    sm = mslow.SlownessMonitor(0, 4, cfg, clock=lambda: t[0])
    log = []
    sm.on_slow = lambda p, s: log.append((p, s))
    out = []
    for roll in range(24):
        sick = 1 if roll < 12 else 3
        for _ in range(int(rng.integers(1, 6))):
            for peer in (1, 2, 3):
                base = 0.2 if peer == sick else 0.001
                sm.note(peer, float(base * rng.uniform(0.5, 1.5)))
        if roll % 5 == 0:
            sm.note_behind([sick])
        t[0] += 0.5
        sm.roll()
        out.append((sorted(sm.suspects), [sm.peer_p99_ms(p)
                                          for p in (1, 2, 3)],
                    sm.stats(), [sm.peer_summary(p) for p in (1, 2, 3)]))
    return out, log


def test_slowness_monitor_identical():
    (p, plog), (r, rlog) = _run_slowness("port", 8), _run_slowness("ref", 8)
    assert p == r and plog == rlog
    assert (1, True) in plog and (1, False) in plog and (3, True) in plog


def test_freshness_identical():
    rng = np.random.default_rng(6)
    trackers = {pkg: [PKGS[pkg][7].FreshnessTracker() for _ in range(3)]
                for pkg in PKGS}
    for i in range(300):
        k = int(rng.integers(0, 3))
        stamped = bool(rng.random() < 0.8)
        lag = float(rng.normal(0.02, 0.03))  # some negative: skew clamps
        for pkg in PKGS:
            tr = trackers[pkg][k]
            tr.note_shipped(stamped)
            if stamped:
                tr.note_lag(lag)
    for pkg in PKGS:
        assert [t.record() for t in trackers[pkg]] == \
            [t.record() for t in trackers["ref"]]
    assert pfresh.merge_freshness(trackers["port"]) == \
        rfresh.merge_freshness(trackers["ref"])
    assert pfresh.merge_freshness([]) == rfresh.merge_freshness([])
    assert trackers["port"][0].record()["clock_skew_clamped"] > 0


def test_flight_dumps_load_and_merge_across_packages(tmp_path):
    """Two ranks' boxes from each package, with heartbeat samples both
    ways and a poison: each package's loader reads the other's files,
    and both merges agree on every dump set."""
    for pkg in PKGS:
        mfl = PKGS[pkg][1]
        recs = [mfl.FlightRecorder(r, str(tmp_path / pkg)) for r in (0, 1)]
        rng = np.random.default_rng(2)
        for i in range(40):
            r = int(rng.integers(0, 2))
            recs[r].ev("hb_death" if i == 30 else "lease_fenced",
                       {"i": i})
            recs[r].hb_sample(1 - r, 10.0 + i, 10.0 + i + 0.0004 + 0.001 * r)
        recs[1].poison("gate_peer_failure", {"clock": 9, "dead": [0]})
        for rec in recs:
            rec.dump()
    for files in ("port", "ref"):
        d = str(tmp_path / files)
        p_dumps = pflight.load_dumps([d])
        r_dumps = rflight.load_dumps([d])
        assert p_dumps == r_dumps and sorted(p_dumps) == [0, 1]
        assert pflight.merge_dumps(p_dumps) == rflight.merge_dumps(r_dumps)
        doc, summary = pflight.merge_dumps(p_dumps)
        assert summary["reasons"][1] == ["gate_peer_failure"]
        assert summary["unaligned_ranks"] == []
    # a torn box is skipped and reported by both
    with open(tmp_path / "port" / "flight-rank2.json", "w") as f:
        f.write('{"rank": 2, "ev')
    for mod in (pflight, rflight):
        skipped: list = []
        assert sorted(mod.load_dumps([str(tmp_path / "port")],
                                     skipped)) == [0, 1]
        assert len(skipped) == 1 and skipped[0][0].endswith("rank2.json")
    assert pflight.main([str(tmp_path / "port")]) == 0


def test_flight_knob_and_default_dir_alike(monkeypatch):
    monkeypatch.setenv("MINIPS_RUN_ID", "4242")
    assert pflight.default_dir() == rflight.default_dir()
    for spec in ("", "/x/y", "/x/y:cap=64"):
        assert pflight._parse_spec(spec) == rflight._parse_spec(spec)
        assert ptracer._parse_spec(spec or "/d") == \
            rtracer._parse_spec(spec or "/d")
    with pytest.raises(ValueError, match="MINIPS_FLIGHT"):
        pflight._parse_spec("/x:speed=2")
    monkeypatch.setenv("MINIPS_FLIGHT", "0")
    pflight.reset_for_tests()
    assert pflight.maybe_init(0) is None and pflight.FLIGHT is None


def test_checkpoint_walk_back_records_ckpt_skip_torn(monkeypatch, tmp_path,
                                                     capsys):
    from minips_tpu_torch.ckpt.checkpoint import Checkpointer
    from minips_tpu_torch.tables.dense import DenseTable

    recs = arm_obs(monkeypatch, tmp_path)
    try:
        d = DenseTable({"w": torch.zeros(8)}, updater="sgd", lr=0.1,
                       device="cpu")
        ck = Checkpointer(str(tmp_path / "ck"), {"d": d}, keep=5)
        for step in (1, 2):
            d.push({"w": torch.full((8,), float(step))})
            ck.save(step=step)
        path = tmp_path / "ck" / "step_0000000002" / "d.npz"
        path.write_bytes(path.read_bytes()[:40])
        assert Checkpointer(str(tmp_path / "ck"), {"d": d}).restore() == 1
        assert "skipping torn checkpoint" in capsys.readouterr().err
        events = [(k, a) for _, k, a in recs["port"][0]._ring]
        assert [k for k, _ in events] == ["ckpt_skip_torn"]
        assert events[0][1]["step"] == 2
        assert events[0][1]["dir"] == str(tmp_path / "ck")
        assert list(recs["ref"][0]._ring) == []
    finally:
        disarm_obs()
