"""The port's heat rebalancer (``balance/heat.py``,
``balance/rebalancer.py`` and the epoch-fenced migration of
``train/sharded_ps.py``), held against the JAX package's.

- Every non-slow drill of ``tests/test_rebalance.py`` runs on the port
  (``port_drills``): spec parsing, the planner's invariants, the heat
  accountant, migration of rows with Adagrad and Adam state, the stale
  push forwarded and the stale pull refused and retried, checkpoints of
  the overlay, the mid-migration staleness property, the BSP bitwise pin
  and the chaos composition.
- Pure logic on the same seeded inputs through both packages: the
  parsers accept and refuse alike, ``plan_assignment`` gives the same
  plans and ``HeatAccountant`` the same decayed counters and reports.
- The deterministic drills run on mixed fleets (reference and port nodes
  on one loopback mesh) and leave every shard bit for bit as an
  all-reference fleet does.

The slow 3-process zipf drill launches the port's
``apps/sharded_ps_bench`` and stays slow.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.balance import heat as jheat
from minips_tpu.balance import rebalancer as jrb
from minips_tpu_torch.balance import heat
from minips_tpu_torch.balance import rebalancer as rb
from tests.torch_ref_drills import (assert_equal_tree,
                                    assert_mixed_equals_reference, fleet,
                                    parse_alike, port_drills)

globals().update(port_drills("test_rebalance.py"))

REF = "test_rebalance.py"


@pytest.mark.parametrize("spec", [
    "", "1", "on", "interval=0.5,threshold=1.25,max_blocks=4,block=16,"
    "decay=0.9,topk=8,min_heat=2", "explode=1", "interval", "interval=abc",
    "threshold=0.5", "max_blocks=0", "block=-1", "interval=-1", " , ,"])
def test_rebalance_config_parses_alike(spec):
    parse_alike(rb.RebalanceConfig.parse, jrb.RebalanceConfig.parse, spec)


def test_plan_assignment_gives_the_reference_plans():
    rng = np.random.default_rng(11)
    fired = 0
    for _ in range(300):
        n = int(rng.integers(2, 9))
        loads = rng.uniform(0.0, 1000.0, size=n)
        cands = {int(b): (int(rng.integers(0, n)),
                          float(rng.uniform(0.0, 300.0)))
                 for b in rng.choice(128, size=int(rng.integers(0, 33)),
                                     replace=False)}
        th = float(rng.uniform(1.0, 3.0))
        mb = int(rng.integers(1, 12))
        got = rb.plan_assignment(loads, cands, th, mb)
        assert got == jrb.plan_assignment(loads, cands, th, mb)
        fired += bool(got)
    assert fired > 30  # the sweep exercised the packer, not just hysteresis


def test_heat_accountant_matches_reference():
    rng = np.random.default_rng(12)
    hs = [m.HeatAccountant(32, decay=0.7, table_id=3)
          for m in (heat, jheat)]
    for step in range(25):
        blocks = rng.integers(-3, 36, size=int(rng.integers(0, 40)))
        rows = int(rng.integers(1, 5))
        for h in hs:
            h.touch(blocks, rows=rows)
            if step % 3 == 2:
                h.tick()
        np.testing.assert_array_equal(hs[0].snapshot(), hs[1].snapshot())
        assert hs[0].total == hs[1].total
        owned = np.sort(rng.choice(32, size=12, replace=False))
        assert_equal_tree(hs[0].report(owned, topk=5),
                          hs[1].report(owned, topk=5))
    assert hs[0].global_key(3) == hs[1].global_key(3)


# the drills whose result is a pure function of their frames: the mixed
# fleet must leave every shard as the all-reference fleet does
BITWISE = ["test_migration_moves_rows_and_optimizer_state",
           "test_migration_moves_adam_moments_and_steps",
           "test_stale_push_is_forwarded_to_the_current_owner",
           "test_stale_pull_is_refused_and_transparently_retried",
           "test_row_cache_drops_migrated_blocks_on_adoption",
           "test_all_blocks_home_checkpoint_stays_elastic_reshardable",
           "test_bsp_uniform_is_bitwise_equal_with_rebalancer_on_and_off"]


@pytest.mark.parametrize("drill", BITWISE)
def test_mixed_fleet_equals_reference_fleet(drill):
    assert_mixed_equals_reference(REF, drill)


def test_mixed_fleet_keeps_the_bound_mid_migration():
    """The free-running staleness property on a mixed fleet: its own
    asserts (the bound, at least one migration, replicas equal)."""
    fleet(REF, ["port", "ref"])[
        "test_pulls_mid_migration_respect_the_staleness_bound"](1, 23)


def test_finalize_adopts_a_plan_issued_after_it_began():
    """A plan the coordinator issues after a peer entered ``finalize``
    (past its one ``adopt_now``) is adopted in the finalize wait: the
    peer's rbA releases the old owner's fence, and a pull routed to the
    peer by the new epoch is served instead of parked on the peer's
    stale epoch until the pull deadline."""
    import threading
    import time

    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                                   ShardedTable)
    from tests.torch_ref_drills import port_loopback_buses

    n, rows = 2, 64
    buses = port_loopback_buses(n)
    tables = [ShardedTable("t", rows, 1, buses[i], i, n, updater="sgd",
                           lr=1.0, pull_timeout=5.0) for i in range(n)]
    trainers = [ShardedPSTrainer({"t": tables[i]}, buses[i], n,
                                 staleness=1, gate_timeout=30.0,
                                 rebalance="block=4,min_heat=1e18")
                for i in range(n)]
    errs: list = []
    keys = np.arange(4, dtype=np.int64)  # block 0, home rank 0
    try:
        for r in range(n):
            tables[r].push(keys, np.full((4, 1), r + 1.0, np.float32))
        trainers[0].tick()

        def run1():
            try:
                trainers[1].tick()
                trainers[1].finalize(timeout=20.0)
            except Exception as e:  # noqa: BLE001 - surfaced via errs
                errs.append(repr(e))

        rank1 = threading.Thread(target=run1)
        rank1.start()
        deadline = time.monotonic() + 10.0
        while not trainers[1].rebalancer._stopped:
            assert time.monotonic() < deadline, "rank 1 never finalized"
            time.sleep(0.01)
        time.sleep(0.3)  # rank 1 is past finalize's first adopt_now
        trainers[0].rebalancer.issue_plan("t", 1, {0: 1})
        got = tables[0].pull(keys)
        np.testing.assert_array_equal(got, np.full((4, 1), -3.0))
        trainers[0].finalize(timeout=20.0)
        rank1.join(timeout=30.0)
        assert not rank1.is_alive() and not errs, errs
        assert tables[1].router.epoch == 1
        assert tables[1].rb_stats["blocks_in"] == 1
        assert tables[1].rebalance_settled()
        np.testing.assert_array_equal(tables[0].pull_all(),
                                      tables[1].pull_all())
    finally:
        for b in buses:
            b.close()
