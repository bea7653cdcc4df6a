"""The port's in-mesh collective data plane (``train/mesh_plane.py``:
``MeshTable``, ``MeshRank``, ``MeshPlane``), held against the JAX
package's.

- Every drill of ``tests/test_mesh_plane.py`` runs on the port
  (``port_drills``) with the ranks on ``[cpu] * n`` (``MINIPS_FORCE_CPU``,
  set for every test here): the BSP bitwise pin against the port's zmq
  wire, the SSP gate on the device clock vector, the blk8 tier and its
  error feedback, the API contracts. Two drills read what only the JAX
  plane has and are left out by name, each with its replacement below:
  ``test_plane_validation_and_selection`` refuses ``MeshPlane(64)``
  because the test process forces 8 JAX host devices (the port's
  refusals are a ``devices=`` list shorter than n and a mixed list), and
  ``test_sharded_state_is_one_over_n_per_shard`` reads the JAX array's
  ``sharding.device_set``.
- Parity on seeded numpy inputs, through both packages on one
  single-threaded schedule: every updater x {float32, blk8} x {dense,
  sparse} deposit, BSP and SSP s = 2. The shard states (weights and
  updater state), the pull mirror and the counters (``waves``,
  ``collective_bytes``, the EF fold and fence waves, resident rows,
  ``peak_deposit_bytes``) must agree: bitwise at sgd/float32, within
  1e-6 max-abs elsewhere. (The test process compiles the JAX side at
  ``--xla_backend_optimization_level=0``, ``tests/conftest.py``; at the
  default level XLA fuses ``w - lr * g`` into a multiply-add and the
  JAX plane drifts by an ulp from both the port and its own wire.)
- ``tests/torch_lockstep.py``'s copies of the lockstep harnesses (which
  the port's bench drills run, without JAX) leave the same final shard
  states as the reference harnesses run on the port.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from minips_tpu.train import mesh_plane as jmp
from minips_tpu_torch.train import mesh_plane as mp
from tests import torch_lockstep
from tests.torch_ref_drills import assert_equal_tree, port_drills, \
    port_helper

LEAVE = ("test_plane_validation_and_selection",
         "test_sharded_state_is_one_over_n_per_shard")
globals().update(port_drills("test_mesh_plane.py", leave=LEAVE))


@pytest.fixture(autouse=True)
def _ranks_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MINIPS_FORCE_CPU", "1")
    for k in ("MINIPS_MESH", "MINIPS_MESH_SPARSE", "MINIPS_MESH_EF",
              "MINIPS_OBS"):
        monkeypatch.delenv(k, raising=False)


# ----------------------------------------- replacements of the left-out
def test_plane_validation_and_selection_on_the_port():
    with pytest.raises(ValueError, match="comm"):
        mp.MeshPlane(2, comm="int4")
    with pytest.raises(ValueError, match="devices"):
        mp.MeshPlane(3, devices=["cpu", "cpu"])   # fewer than n
    with pytest.raises(ValueError, match="devices"):
        # one device twice beside another: neither rule of the plane
        mp.MeshPlane(3, devices=["cpu", "cpu", "meta"])
    assert "blk8" in mp.VALID_MESH_COMM
    assert mp.resolve_plane("wire") == "wire"
    assert mp.resolve_plane("mesh") == "mesh"
    with pytest.raises(ValueError, match="plane"):
        mp.resolve_plane("shm")
    plane = mp.MeshPlane(64)                      # [cpu] * 64
    assert plane.stats()["devices"] == 64


def test_sharded_state_is_one_over_n_per_shard_on_the_port():
    plane = mp.MeshPlane(4, staleness=0)
    t = plane.add_table("t", 1024, 8, updater="adam")
    full = 3 * 1024 * 8 * 4 + 1024 * 4
    assert t.local_bytes() == full // 4
    # one device named 4 times: the owner shards are the four row
    # ranges of one tensor per state on that device
    assert plane.mesh.one and plane.mesh.segs == 1
    for key in ("w", "m", "v", "steps"):
        (seg,) = t._st[key]
        assert seg.shape[0] == 4 * t.shard_rows and seg.device.type == "cpu"


# ------------------------------------------------------------- parity
def _drive(mod, updater, comm, deposit, staleness, n=3, rows=50, dim=4,
           steps=6):
    """One seeded single-threaded schedule: pushes with duplicate keys,
    a second deposit on some ranks, a dense push, pulls at admission;
    under SSP the last rank ticks every other step (skew up to s)."""
    plane = mod.MeshPlane(n, staleness=staleness, comm=comm,
                          deposit=deposit, block=8)
    t = plane.add_table("t", rows, dim, updater=updater, lr=0.1)
    rng = np.random.default_rng(7)
    t.load_dense(rng.normal(size=(rows, dim)).astype(np.float32))
    pulled = []
    for i in range(steps):
        live = [r for r in range(n)
                if not (staleness and r == n - 1 and i % 2)]
        for r in live:
            keys = rng.integers(0, rows, size=12)
            pulled.append(t.pull(r, keys))
            if r == 0 and i == 2:
                t.push_dense(r, rng.normal(size=(rows, dim)).astype(
                    np.float32))
            if r == 1 and i % 2:
                t.push(r, rng.integers(0, rows, size=5),
                       rng.normal(size=(5, dim)).astype(np.float32))
            t.push(r, keys, rng.normal(size=(12, dim)).astype(np.float32))
        for r in live:
            plane.tick(r, wait=False)
    ths = [threading.Thread(target=plane.finalize, args=(r,))
           for r in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60.0)
    state = {k: np.asarray(getattr(t, k))
             for k in ("_w", "_acc", "_m", "_v", "_steps")
             if getattr(t, k) is not None}
    st = plane.stats()
    counters = {k: st[k] for k in ("waves", "collective_bytes",
                                   "peak_deposit_bytes", "sparse_waves",
                                   "ef", "gate_waits", "devices")}
    return state, t.pull_all(0).copy(), np.stack(pulled), counters


@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("deposit", ["dense", "sparse"])
@pytest.mark.parametrize("comm", ["float32", "blk8"])
@pytest.mark.parametrize("updater", ["sgd", "adagrad", "adam"])
def test_plane_matches_the_jax_plane(updater, comm, deposit, staleness):
    want = _drive(jmp, updater, comm, deposit, staleness)
    got = _drive(mp, updater, comm, deposit, staleness)
    assert got[3] == want[3]
    assert sorted(got[0]) == sorted(want[0])
    for g, w in zip((*got[0].values(), got[1], got[2]),
                    (*(want[0][k] for k in got[0]), want[1], want[2])):
        if updater == "sgd" and comm == "float32":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_device_clock_vector_matches_the_jax_plane():
    out = []
    for mod in (jmp, mp):
        plane = mod.MeshPlane(3, staleness=1)
        plane.add_table("t", 16, 2)
        for r in (0, 1, 0):
            plane.tick(r, wait=False)
        out.append((plane.clocks().tolist(), plane._device_min(),
                    plane.max_skew_seen))
    assert out[0] == out[1] == ([2, 1, 0], 0, 2)


# ------------------------------------------------ the lockstep copies
@pytest.mark.parametrize("kw", [
    {"backend": "zmq"}, {"backend": "mesh"},
    {"backend": "zmq", "hedge": "1"}, {"backend": "zmq", "tenant": "1"},
    {"backend": "zmq", "traffic": "rate=0,users=1000000"}],
    ids=["zmq", "mesh", "hedge", "tenant", "traffic"])
def test_bsp_lockstep_copy_equals_the_reference_harness(kw):
    ref = port_helper("test_chaos_reliable.py", "run_bsp_lockstep")
    st_ref, st = {}, {}
    want = ref(**kw, stats=st_ref)
    got = torch_lockstep.run_bsp_lockstep(**kw, stats=st)
    assert_equal_tree(got, want)
    assert st == st_ref


@pytest.mark.parametrize("spec", ["", "group=2", "group=2,agg=mesh"])
def test_hier_lockstep_copy_equals_the_reference_harness(spec):
    ref = port_helper("test_hier.py", "run_hier_lockstep")
    st_ref, st = {}, {}
    want = ref(spec, stats=st_ref)
    got = torch_lockstep.run_hier_lockstep(spec, stats=st)
    assert_equal_tree(got, want)
    assert st == st_ref
