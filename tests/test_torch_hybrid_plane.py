"""The port's hybrid data plane (``MINIPS_HIER`` ``agg=mesh``:
``train/mesh_plane.py``'s ``MeshAggregator`` under the leader lane of
``train/sharded_ps.py``), held against the JAX package's.

- Every drill of ``tests/test_hybrid_plane.py`` runs on the port
  (``port_drills``; its slow whole-host drill stays slow), with the
  aggregator's slots on ``[cpu] * m`` (``MINIPS_FORCE_CPU``, set for
  every test here): the sorted-keys contract of the host tier, the
  device tier against the host kernel, stamp folding, the 3-rank
  lockstep pins (degenerate, f32 and blk8 device tiers bitwise equal to
  the flat wire), the failure-domain latch and the trainer's stats.
- ``MeshAggregator`` on seeded deposits through both packages: the
  device tiers (f32 and blk8, 2 and 3 slots) and the host tier give the
  same keys, rows, residuals and counters, bit for bit.
- Mixed fleets: the hybrid lockstep with the leader from one package and
  the members from the other leaves every shard bit for bit as an
  all-reference fleet does, on the device tiers and the one-device tier.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.train import mesh_plane as jmp
from minips_tpu_torch.train import mesh_plane as mp
from tests.torch_ref_drills import assert_equal_tree, fleet, port_drills

globals().update(port_drills("test_hybrid_plane.py"))


@pytest.fixture(autouse=True)
def _slots_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MINIPS_FORCE_CPU", "1")
    for k in ("MINIPS_HIER", "MINIPS_HIER_MESH_DEVS",
              "MINIPS_HIER_MESH_COMM"):
        monkeypatch.delenv(k, raising=False)


def _agg_run(mod, slots, comm, rounds=4, rows=40, dim=3):
    agg = mod.MeshAggregator(rows, dim, slots=slots, comm=comm, block=8)
    rng = np.random.default_rng(21)
    outs = []
    for i in range(rounds):
        for s in range(slots + 1):         # one slot deposits twice
            n = int(rng.integers(0, 9))
            keys = rng.integers(0, rows, size=n)
            grads = (rng.normal(size=(n, dim))
                     * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
            agg.deposit(s % slots, keys, grads)
        outs.append(agg.reduce())
    return outs, agg.stats(), agg._L


@pytest.mark.parametrize("slots,comm,devs", [
    (2, "float32", ""), (2, "blk8", ""), (3, "blk8", ""),
    (3, "float32", ""), (3, "blk8", "1")])
def test_aggregator_matches_the_jax_aggregator(slots, comm, devs,
                                               monkeypatch):
    if devs:
        monkeypatch.setenv("MINIPS_HIER_MESH_DEVS", devs)
    want = _agg_run(jmp, slots, comm)
    got = _agg_run(mp, slots, comm)
    assert got[1] == want[1]
    assert got[1]["backend"] == ("host-degenerate" if devs else "mesh")
    assert got[2] == want[2]
    assert_equal_tree(got[0], want[0])


@pytest.mark.parametrize("comm,devs", [("float32", ""), ("blk8", ""),
                                       ("blk8", "1")])
def test_mixed_fleet_hybrid_lockstep_equals_reference_fleet(comm, devs,
                                                            monkeypatch):
    """Leader (rank 0, host group {0, 1}) from one package, member from
    the other: the leader's own package reduces, and every shard ends as
    the all-reference fleet's."""
    monkeypatch.setenv("MINIPS_HIER_MESH_COMM", comm)
    if devs:
        monkeypatch.setenv("MINIPS_HIER_MESH_DEVS", devs)
    spec = "group=2,agg=mesh"
    st_want: dict = {}
    want = fleet("test_hier.py", ["ref"])["run_hier_lockstep"](
        spec, stats=st_want)
    assert st_want["mesh_reduces"] > 0
    assert st_want["mesh_agg_fallbacks"] == 0
    for kinds in (["ref", "port"], ["port", "ref"]):
        st: dict = {}
        got = fleet("test_hier.py", kinds)["run_hier_lockstep"](
            spec, stats=st)
        assert_equal_tree(got, want)
        assert st == st_want
