"""The port's Engine over a process group: rank 0 drives the worker
threads, the other ranks serve their table shards (``core/engine.py``).

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (the rank bodies are in ``torch_app_ranks.py``, which imports no
JAX); the failing run spawns its own. Checked on every n:

- the default workers are the group's size and each rank's device is
  the one ``run_ranks`` gave it (the CPU under gloo); ``barrier()``
  returns under a group (without one it keeps its refusal,
  ``test_torch_engine.py``);
- a pull is a snapshot under later pushes, as
  ``test_pull_is_a_snapshot_under_later_pushes`` checks on one device;
- one worker's every kind of table op (dense pull, pull_keys, push,
  push_keys; sparse pull, push) through the group gives the same pulls
  and final tables as on one device, exactly: a dense push applies the
  broadcast gradient on each rank's range, a sparse op's owner updates the
  rows the driving rank sent;
- a UDF error on rank 0 surfaces as the root cause and ends every rank
  well before the spawn's timeout.
"""

from __future__ import annotations

import time

import pytest

import torch_app_ranks as ranks
from minips_tpu_torch.parallel.mesh import run_ranks

WORLD_SIZES = (2, 4)
SPAWN_TIMEOUT = 300.0
ERROR_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def runs():
    cases = [("defaults", "engine_defaults", {}),
             ("snapshot", "engine_snapshot", {}),
             ("ops", "engine_ops", {})]
    return {n: run_ranks(ranks.run_cases, n, cases, device="cpu",
                         timeout=SPAWN_TIMEOUT) for n in WORLD_SIZES}


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_default_workers_are_the_group_size(runs, n):
    for r in range(n):
        got = runs[n][r]["defaults"]
        assert got["workers"] == got["ranks"] == n
        assert got["device"] == got["rank_device"] == "cpu"


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_pull_is_a_snapshot_under_later_pushes_over_a_group(runs, n):
    got = runs[n][0]["snapshot"]
    assert got == {"d_kept": True, "s_kept": True, "d_moved": True,
                   "s_moved": True}


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_every_table_op_matches_one_device(runs, n):
    for r in range(n):
        assert runs[n][r]["ops"] == {"pulls": True, "dense": True,
                                     "sparse": True}


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ranks_import_no_jax(runs, n):
    assert all(runs[n][r]["_jax"] == [] for r in range(n))


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_udf_error_on_rank_0_ends_every_rank(n):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 1 exploded"):
        run_ranks(ranks.engine_error, n, device="cpu",
                  timeout=ERROR_TIMEOUT)
    assert time.monotonic() - t0 < ERROR_TIMEOUT / 2
