"""The port's control plane (``balance/control_plane.py``,
``balance/autoscaler.py``), held against the JAX package's.

- Every non-slow drill of ``tests/test_control_plane.py`` runs on the
  port (``port_drills``), and the closed loop stays slow as the
  reference marks it.
- Pure logic through both packages: the succession rule, the lease's
  succession, transfer and term fencing, the suspicion quorum, the
  ``MINIPS_AUTOSCALE`` parser, and the autoscaler's hysteresis fed the
  same seeded shed counters (the same admits, drains and evidence).
- Mixed fleets: the stale ex-coordinator's plan is fenced by term
  whichever package sent or received it, and the autoscaler armed but
  idle leaves every shard bit for bit as an all-reference fleet does.
- Launched: the coordinator-kill drill runs under the port's launcher
  with the reference's asserts, and the JAX example's job runs beside it
  under the same flags and env; the membership outcome (the corpse, the
  live set, the lease's new term and holder, the blocks restored) must
  be the same. The kill lands at a clock the SSP race decides, so the
  weights are held equal across each job's survivors, not across jobs.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.balance import autoscaler as jas
from minips_tpu.balance import control_plane as jcp
from minips_tpu_torch.balance import autoscaler as asc
from minips_tpu_torch.balance import control_plane as cp
from tests.torch_ref_drills import (assert_mixed_equals_reference,
                                    drill_beside_jax, fleet, parse_alike,
                                    port_drills)

LAUNCHED = "test_coordinator_kill_drill_successor_completes"
PORT = port_drills("test_control_plane.py")
globals().update({k: v for k, v in PORT.items() if k != LAUNCHED})

REF = "test_control_plane.py"


def test_succession_and_quorum_match_reference():
    rng = np.random.default_rng(15)
    for _ in range(300):
        live = set(int(r) for r in rng.choice(
            9, size=int(rng.integers(0, 9)), replace=False))
        assert cp.successor_of(live) == jcp.successor_of(live)
        suspect = int(rng.integers(0, 9))
        if live:
            assert cp.quorum_needed(live, suspect) \
                == jcp.quorum_needed(live, suspect)
    qs = [cp.SuspicionQuorum(0), jcp.SuspicionQuorum(0)]
    for _ in range(200):
        op = int(rng.integers(0, 4))
        a = int(rng.integers(0, 6))
        sus = [int(x) for x in rng.choice(6, size=int(rng.integers(0, 3)),
                                          replace=False)]
        live = set(int(r) for r in rng.choice(6, size=4, replace=False))
        flag = bool(rng.integers(0, 2))
        outs = []
        for q in qs:
            if op == 0:
                outs.append(q.mark_local(a, flag))
            elif op == 1:
                q.vote(a, sus)
            elif op == 2:
                q.drop_voter(a)
            outs.append((q.my_suspects(), q.convictable(live),
                         q.voters_for(a, live)))
        half = len(outs) // 2
        assert outs[:half] == outs[half:]
    assert qs[0].stats() == qs[1].stats()


def test_lease_matches_reference():
    rng = np.random.default_rng(16)
    leases = [cp.CoordinatorLease(0), jcp.CoordinatorLease(0)]
    live = {0, 1, 2, 3, 4}
    for _ in range(300):
        op = int(rng.integers(0, 5))
        stamp = {"lt": int(rng.integers(0, 6)), "lh": int(rng.integers(0, 5))}
        if rng.integers(0, 4) == 0:
            stamp.pop("lh")
        to = int(rng.integers(0, 5))
        outs = []
        for le in leases:
            if op == 0:
                outs.append(le.admit(dict(stamp)))
            elif op == 1:
                outs.append(le.observe(dict(stamp)))
            elif op == 2:
                holder = le.current()[1]
                outs.append(le.succeed(holder, live - {holder}))
            elif op == 3:
                outs.append(le.transfer(to))
            outs.append((le.current(), le.stamp()))
        half = len(outs) // 2
        assert outs[:half] == outs[half:]
    assert leases[0].stats() == leases[1].stats()


@pytest.mark.parametrize("spec", [
    "", "1", "up_shed=5,up_after=2,down_after=3,cool=1",
    "up_p99_ms=20,imb=1.5,max_live=6", "explode=1", "up_shed",
    "up_after=0", "up_shed=abc", "cool=-1", "max_live=x"])
def test_autoscale_config_parses_alike(spec):
    parse_alike(asc.AutoscaleConfig.parse, jas.AutoscaleConfig.parse, spec)


def test_autoscaler_hysteresis_matches_reference():
    """One seeded shed-counter stream through both packages' autoscalers
    on the reference drill's fakes: every tick's decisions, counters and
    evidence are the same, and the stream drives admits and drains."""
    rng = np.random.default_rng(17)
    spec = "up_shed=5,up_after=2,down_after=3,cool=1"
    runs = []
    for mod in (asc, jas):
        tr, mb = PORT["_FakeTrainer"](), PORT["_FakeMB"]({0, 1, 2})
        a = mod.Autoscaler(tr, mb, mod.AutoscaleConfig.parse(spec))
        runs.append((tr, mb, a))
    shed = 0.0
    for tick in range(120):
        hot = (tick // 15) % 2 == 0
        shed += float(rng.integers(4, 12)) if hot else 0.0
        trace = []
        for tr, mb, a in runs:
            PORT["_feed"](tr, shed)
            a.on_tick()
            if mb.credits and len(mb._live) < 3 + mb.credits:
                mb._live.add(2 + mb.credits)  # the plane admits it
            trace.append((mb.credits, list(tr.bus.sent), a.stats()))
        assert trace[0] == trace[1], tick
    stats = runs[0][2].stats()
    assert stats["admits"] >= 2 and stats["drains"] >= 1, stats


@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]])
def test_mixed_fleet_fences_the_stale_coordinator(kinds):
    fleet(REF, kinds)["test_stale_ex_coordinator_plan_is_fenced_by_lease_term"]()


def test_mixed_fleet_autoscale_idle_equals_reference_fleet():
    drill = "test_autoscale_armed_idle_is_bitwise_equal_to_off"
    assert assert_mixed_equals_reference(REF, drill) == 4  # off, armed


def test_coordinator_kill_drill_matches_the_jax_job(tmp_path, monkeypatch):
    port, _ = drill_beside_jax(PORT, LAUNCHED, tmp_path, monkeypatch)
    assert port["ranks"][1]["lease"] == (1, 1)
    assert port["ranks"][1]["dead"] == [0]
    assert port["blocks_restored"] > 0
