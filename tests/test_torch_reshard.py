"""The port's planned collective redistribution (``balance/redistribute.py``
and the slice rounds of ``train/sharded_ps.py``), held against the JAX
package's.

- Every drill of ``tests/test_reshard.py`` runs on the port
  (``port_drills``): the spec and its fuzzer, the byte model, the round
  planner's properties, the planned migration against the p2p ship,
  idempotent redelivery, the aborted plan, the lost ``rbF``, chaos, the
  streaming reshard of checkpoints and whole-host evacuation.
- Pure logic through both packages: ``ReshardConfig`` parses and refuses
  alike on the reference fuzzer's alphabet, ``plan_rounds`` gives the
  same schedules and ``state_row_bytes`` the same byte model.
- Mixed fleets: the planned migration of Adagrad and Adam state, the
  degenerate plan's shipped bytes and the lost ``rbF`` leave every shard
  bit for bit as an all-reference fleet does. Slices that beat the
  gainer's adoption hold the drill's own bitwise asserts on the gainer
  (the sender's side then depends on when the buses close).
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.balance import redistribute as jrd
from minips_tpu_torch.balance import redistribute as rd
from tests.torch_ref_drills import (assert_mixed_equals_reference, fleet,
                                    parse_alike, port_drills)

globals().update(port_drills("test_reshard.py"))

REF = "test_reshard.py"


def test_reshard_config_parses_alike_on_the_fuzzer_alphabet():
    rng = np.random.default_rng(20260807)
    vocab = ["cap", "fanout", "bogus", "cap", "fanout"]
    vals = ["0", "1", "3", "64m", "2k", "1g", "-1", "abc", "", "2.5",
            "9999999999", "8K"]
    specs = ["", "1", "cap", "cap=64m,fanout=4", " , "]
    for _ in range(200):
        specs.append(",".join(
            f"{vocab[rng.integers(0, len(vocab))]}"
            f"={vals[rng.integers(0, len(vals))]}"
            for _ in range(int(rng.integers(0, 5)))))
    for spec in specs:
        parse_alike(rd.ReshardConfig.parse, jrd.ReshardConfig.parse, spec)


def test_plan_rounds_gives_the_reference_schedules():
    rng = np.random.default_rng(8)
    for _ in range(150):
        world = int(rng.integers(2, 8))
        moves = []
        for b in rng.choice(96, size=int(rng.integers(0, 14)),
                            replace=False):
            s = int(rng.integers(0, world))
            d = int(rng.integers(0, world - 1))
            moves.append((int(b), s, d if d < s else d + 1))
        rows = {b: int(rng.integers(1, 50)) for b, _s, _d in moves}
        rb = int(rng.integers(1, 65))
        kw = dict(cap=int(rng.integers(1, 900)),
                  fanout=int(rng.integers(1, 5)))
        got = rd.plan_rounds(moves, rows.__getitem__, rb, **kw)
        want = jrd.plan_rounds(moves, rows.__getitem__, rb, **kw)
        assert [[tuple(e) for e in r] for r in got] \
            == [[tuple(e) for e in r] for r in want]
        assert rd.peak_stage_bytes(got, rb) \
            == jrd.peak_stage_bytes(want, rb)
    for updater in ("sgd", "adagrad", "adam"):
        for dim in (1, 3, 16):
            assert rd.state_row_bytes(dim, updater) \
                == jrd.state_row_bytes(dim, updater)
    with pytest.raises(ValueError, match="more than one move"):
        rd.plan_rounds([(1, 0, 1), (1, 1, 2)], lambda b: 4, 8, cap=64,
                       fanout=2)


BITWISE = ["test_planned_migration_moves_adam_moments_and_steps",
           "test_degenerate_plan_ships_byte_identical_blobs",
           "test_fence_release_confirmation_survives_a_lost_rbF"]


@pytest.mark.parametrize("drill", BITWISE)
def test_mixed_fleet_equals_reference_fleet(drill):
    assert_mixed_equals_reference(REF, drill)


@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]])
def test_mixed_fleet_carries_early_slices(kinds):
    fleet(REF, kinds)["test_slices_beating_adoption_carry_their_journal"]()
