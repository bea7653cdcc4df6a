"""The port's elastic membership (``balance/membership.py``), held against
the JAX package's.

- Every non-slow drill of ``tests/test_membership.py`` runs on the port
  (``port_drills``), and its slow drills (drain, SIGTERM, the gang
  restart) stay slow as the reference marks them.
- Pure logic through both packages: ``MembershipConfig`` parses and
  refuses alike, and ``plan_evacuation`` and ``plan_admission`` (with and
  without heat reports) give the same overlays for the same seeded
  router states.
- Mixed fleet: elastic armed but idle on a BSP lockstep run leaves every
  shard bit for bit as an all-reference fleet does, armed and off.
- Launched: the death and join drills run under the port's launcher with
  the reference's asserts, and the JAX example's job runs beside each
  under the same flags and env. The membership outcome (``live``,
  ``standby``, ``dead``, ``left``, ``coord``, the lease's term and
  holder, the blocks restored fleet-wide) must be the same. Both jobs
  are SSP runs whose ranks race one another, and the kill or the join
  lands at a clock the race decides, so the final weights are not a
  function of the flags: ``param_sum`` is held equal across each job's
  own survivors (bitwise), never across the two jobs.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from minips_tpu.balance import membership as jmb
from minips_tpu.parallel import partition as jpart
from minips_tpu_torch.balance import membership as mb
from minips_tpu_torch.parallel import partition as part
from tests.torch_ref_drills import (CPU_RANK, assert_mixed_equals_reference,
                                    drill_beside_jax, parse_alike,
                                    port_drills)

LAUNCHED = ("test_death_drill_seeded_sigkill_survivors_complete",
            "test_join_drill_standby_admitted_mid_run")
PORT = port_drills("test_membership.py")
globals().update({k: v for k, v in PORT.items() if k not in LAUNCHED})

REF = "test_membership.py"


@pytest.mark.parametrize("spec", [
    "", "1", "live=0-2,grace=20", "live=0+3", "live=1", "explode=1",
    "live", "grace=abc", "live=x", "live=3-1", " , "])
def test_membership_config_parses_alike(spec):
    parse_alike(mb.MembershipConfig.parse, jmb.MembershipConfig.parse,
                spec)


def _routers(rng):
    rows = int(rng.integers(16, 200))
    shards = int(rng.integers(2, 7))
    block = int(rng.integers(1, 9))
    rs = [m.BlockRouter(m.RangePartitioner(rows, shards), block)
          for m in (part, jpart)]
    ov = {}
    for b in rng.choice(rs[0].num_blocks,
                        size=int(rng.integers(0, rs[0].num_blocks)),
                        replace=False):
        o = int(rng.integers(0, shards))
        if o != rs[0].home_of(int(b)):
            ov[int(b)] = o
    for r in rs:
        r.apply(1, dict(ov))
    return rs, shards


def test_planners_give_the_reference_overlays():
    rng = np.random.default_rng(14)
    heat_moves = 0
    for _ in range(200):
        (rp, rj), shards = _routers(rng)
        ranks = list(range(shards))
        victims = set(int(v) for v in rng.choice(
            shards, size=int(rng.integers(1, shards)), replace=False))
        targets = [r for r in ranks if r not in victims]
        assert mb.plan_evacuation(rp, victims, targets) \
            == jmb.plan_evacuation(rj, victims, targets)
        joiner = int(rng.integers(0, shards))
        live = set(ranks) - {joiner}
        reports = {}
        for r in sorted(live):
            owned = np.nonzero(rp.owner_of_blocks() == r)[0]
            pick = rng.choice(owned, size=min(owned.size, 4),
                              replace=False) if owned.size else []
            heat = rng.uniform(0.0, 500.0, size=len(pick))
            reports[r] = {"total": float(heat.sum() + rng.uniform(0, 50)),
                          "blocks": [int(b) for b in pick],
                          "heat": [float(h) for h in heat]}
        kw = dict(reports=reports, live=live,
                  max_blocks=int(rng.integers(1, 9)))
        got = mb.plan_admission(rp, joiner, **kw)
        assert got == jmb.plan_admission(rj, joiner, **kw)
        assert mb.plan_admission(rp, joiner) \
            == jmb.plan_admission(rj, joiner)
        heat_moves += got != mb.plan_admission(rp, joiner)
    assert heat_moves > 20  # the heat-aware half planned real moves


def test_mixed_fleet_elastic_idle_equals_reference_fleet():
    drill = "test_elastic_armed_idle_is_bitwise_equal_to_off"
    assert assert_mixed_equals_reference(REF, drill) == 4  # off, armed


def test_death_drill_matches_the_jax_job(tmp_path, monkeypatch):
    port, _ = drill_beside_jax(PORT, LAUNCHED[0], tmp_path, monkeypatch)
    assert port["ranks"][0]["dead"] == [2]
    assert port["blocks_restored"] > 0


def test_join_drill_matches_the_jax_job(tmp_path, monkeypatch):
    port, _ = drill_beside_jax(PORT, LAUNCHED[1], tmp_path, monkeypatch)
    assert port["ranks"][3]["live"] == [0, 1, 2, 3]


def test_elastic_standby_refuses_the_dense_model():
    """A standby's home range is covered only once the bootstrap plan
    lands, and the dense loop reads the whole vector before that: both
    packages' apps refuse ``MINIPS_ELASTIC`` with a standby under
    ``--model dense``, every rank with the same error line and exit 2,
    before any step."""
    from minips_tpu import launch as jlaunch
    from minips_tpu_torch import launch

    runs = []
    for mod, pkg in ((launch, "minips_tpu_torch"), (jlaunch, "minips_tpu")):
        runs.append(mod.run_local_job_raw(
            2, [sys.executable, "-m", f"{pkg}.apps.sharded_ps_example",
                "--model", "dense", "--iters", "5"],
            env_extra={**CPU_RANK, "JAX_PLATFORMS": "cpu",
                       "MINIPS_ELASTIC": "live=0"},
            timeout=120.0))
    (rc, events), (jrc, jevents) = runs
    assert rc == jrc == 2, (rc, jrc)
    assert events == jevents and len(events) == 2
    assert events[1][-1]["event"] == "error"
    assert "requires --model sparse" in events[1][-1]["err"]
