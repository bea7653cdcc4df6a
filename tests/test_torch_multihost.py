"""``comm/cluster.py`` and ``apps/multihost_example.py``'s LR paths of the
port against the JAX package's, on the CPU.

The cluster cases are ``tests/test_multihost.py``'s fast tier, each held
on both packages: one process is a no-op everywhere, a launcher run with
``--n 1`` starts no group, and a cluster configured the framework's
standard way (``JAX_COORDINATOR_ADDRESS``; PyTorch's ``MASTER_ADDR`` with
``env://``) passes through with rank and world size left to the
framework.

The launched job: ``--model lr --mode bsp`` on 2 port processes (a gloo
group on the CPU) is held bit for bit to the port's own ``--oracle-hosts
2`` (the same local steps one after another in one process), and within
``JAX_ORACLE_TOL`` to the JAX package's oracle run at this suite's XLA
setting (``tests/conftest.py``: O0, no FMA contraction), one device per
simulated host as the port has.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from minips_tpu import launch as jlaunch
from minips_tpu_torch import launch
from minips_tpu_torch.apps import multihost_example
from minips_tpu_torch.comm import cluster

CPU = {"MINIPS_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu"}
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
JAX_ORACLE_TOL = 1e-6
ENVS = ("MINIPS_COORDINATOR", "JAX_COORDINATOR_ADDRESS", "MINIPS_NUM_PROCS",
        "MINIPS_PROC_ID", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_cluster_env(monkeypatch):
    for var in ENVS:
        monkeypatch.delenv(var, raising=False)


def test_initialize_single_process_is_noop(no_cluster_env):
    from minips_tpu.comm import cluster as jcluster

    assert cluster.initialize() is False and jcluster.initialize() is False
    assert cluster.process_count() == jcluster.process_count() == 1
    assert cluster.process_index() == jcluster.process_index() == 0
    assert cluster.backend() is None and not dist.is_initialized()


def test_initialize_num_procs_one_is_noop(no_cluster_env, monkeypatch):
    from minips_tpu.comm import cluster as jcluster

    monkeypatch.setenv("MINIPS_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MINIPS_NUM_PROCS", "1")
    monkeypatch.setenv("MINIPS_PROC_ID", "0")
    assert cluster.initialize() is False and jcluster.initialize() is False
    assert not dist.is_initialized()


def test_initialize_standard_env_passes_through(no_cluster_env, monkeypatch):
    """JAX_COORDINATOR_ADDRESS reaches ``jax.distributed.initialize`` and
    PyTorch's MASTER_ADDR reaches ``init_process_group("env://")``, rank
    and world size left for the framework to resolve."""
    import jax

    from minips_tpu.comm import cluster as jcluster

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    jcalls = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jcalls.update(kw))
    assert jcluster.initialize() is True
    assert jcalls["num_processes"] is None and jcalls["process_id"] is None

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("MINIPS_FORCE_CPU", "1")
    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(kw, b=backend))
    assert cluster.initialize() is True
    assert calls["init_method"] == "env://"
    assert (calls["rank"], calls["world_size"]) == (-1, -1)
    assert calls["b"] == "gloo"


def test_sync_backend_follows_the_launch_layout(monkeypatch):
    """gloo on the CPU and for processes that share a card; NCCL only
    with a card for each process of the host."""
    monkeypatch.setenv("MINIPS_FORCE_CPU", "1")
    assert cluster.sync_backend() == "gloo"
    monkeypatch.delenv("MINIPS_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("MINIPS_LOCAL_PROCS", "2")
    assert cluster.sync_backend() == "gloo"
    monkeypatch.setenv("MINIPS_LOCAL_PROCS", "1")
    assert cluster.sync_backend() == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("MINIPS_LOCAL_PROCS", "4")
    assert cluster.sync_backend() == "nccl"


def test_barrier_single_process_returns():
    from minips_tpu.comm import cluster as jcluster

    cluster.barrier("unit")
    jcluster.barrier("unit")
    cluster.shutdown()


def test_global_batch_single_process(mesh8):
    """One process: the port's global batch is its local rows on the
    device, the JAX package's a device_put over the mesh: the same
    values."""
    from minips_tpu.comm import cluster as jcluster

    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    out = cluster.global_batch({"x": x}, "cpu")
    assert torch.is_tensor(out["x"]) and out["x"].device.type == "cpu"
    np.testing.assert_array_equal(out["x"].numpy(), x)
    jout = jcluster.global_batch(mesh8, {"x": x})
    np.testing.assert_array_equal(np.asarray(jout["x"]), out["x"].numpy())


def test_host_copy_addressable(mesh8):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from minips_tpu.comm import cluster as jcluster

    x = jax.device_put(np.arange(8, dtype=np.float32),
                       NamedSharding(mesh8, P("data")))
    t = torch.arange(8, dtype=torch.float32)
    np.testing.assert_array_equal(cluster.host_copy(t),
                                  jcluster.host_copy(x))
    np.testing.assert_array_equal(cluster.host_copy(t, sharded=True),
                                  np.arange(8))


def _oracle_in_process(capsys, argv) -> dict:
    capsys.readouterr()
    assert multihost_example.main(argv + ["--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_lr_bsp_two_processes_bitwise_to_the_oracles(capsys):
    flags = ["--model", "lr", "--mode", "bsp", "--iters", "12"]
    res = launch.run_local_job(
        2, [sys.executable, "-m", "minips_tpu_torch.apps.multihost_example"]
        + flags, env_extra=dict(CPU, **ONE_THREAD), timeout=240.0)
    oracle = _oracle_in_process(capsys, flags + ["--oracle-hosts", "2"])
    jres = jlaunch.run_local_job(
        1, [sys.executable, "-m", "minips_tpu.apps.multihost_example"]
        + flags + ["--oracle-hosts", "2"], base_port=None,
        env_extra=dict(CPU, MINIPS_MH_LOCAL_DEVICES="2"), timeout=240.0)
    joracle = jres[0]
    for r in res:
        rk = r["rank"]
        assert r["event"] == "done" and r["multi"] is True
        assert r["sync_backend"] == "gloo" and r["process_count"] == 2
        assert r["max_skew_seen"] <= 1 and r["sync_hlo_has_all_reduce"]
        assert r["losses"] == oracle["losses_per_host"][rk]
        assert r["param_fingerprint"] == oracle["param_fingerprints"][rk]
        np.testing.assert_allclose(r["losses"],
                                   joracle["losses_per_host"][rk],
                                   rtol=0, atol=JAX_ORACLE_TOL)
        np.testing.assert_allclose(r["param_fingerprint"],
                                   joracle["param_fingerprints"][rk],
                                   rtol=JAX_ORACLE_TOL)
    assert res[0]["param_fingerprint"] == res[1]["param_fingerprint"]
    assert res[0]["losses"][-1] < res[0]["losses"][0]


def test_lr_fused_two_processes_checkpoint_roundtrip(tmp_path, capsys):
    """The fused path over a 2-process gloo group: both ranks agree with
    the one-process run (the same global batches), and the sharded
    checkpoint drill (each process writes its own shard through DCP)
    restores what was saved."""
    flags = ["--mode", "fused", "--iters", "8"]
    res = launch.run_local_job(
        2, [sys.executable, "-m", "minips_tpu_torch.apps.multihost_example"]
        + flags + ["--checkpoint-dir", str(tmp_path / "ck"), "--save-at",
                   "4"], env_extra=dict(CPU, **ONE_THREAD), timeout=240.0)
    one = _oracle_in_process(capsys, flags)
    for r in res:
        assert r["event"] == "done" and r["ckpt_roundtrip_ok"] is True
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=0,
                                   atol=1e-6)
    assert res[0]["param_fingerprint"] == res[1]["param_fingerprint"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_4"]


def test_fused_across_shared_card_refuses(monkeypatch):
    """Two processes on one card get a gloo group, whose tables live on
    the CPU: the fused path refuses rather than run there as the card."""
    monkeypatch.setattr(cluster, "process_count", lambda: 2)
    monkeypatch.setattr(cluster, "initialize", lambda: True)
    monkeypatch.setattr(cluster, "backend", lambda: "gloo")
    monkeypatch.setattr(multihost_example, "_Watchdog",
                        lambda rank: None)
    import minips_tpu_torch.apps.common as common

    monkeypatch.setattr(common, "multiproc_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(dist, "group", type("G", (), {"WORLD": object()}))
    with pytest.raises(SystemExit, match="needs NCCL"):
        multihost_example.main(["--mode", "fused"])
