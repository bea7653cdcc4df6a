"""The port's partition routers, launcher and shared-memory sample store,
held against the JAX package's (``minips_tpu/parallel/partition.py``,
``launch.py``, ``data/shm_store.py``).

The routers are pure index math: the same (num_keys, shards, align,
block) specs, drawn from a seeded numpy generator, must give identical
owners, offsets, splits and block spans in both packages (exact integer
equality). The launcher's env wiring and harvest protocol are compared
field by field; the shared-memory store runs its own protocol with real
processes, and ``read_criteo``/``read_libsvm`` with ``shared=True`` on two
launched ranks must equal the unshared read bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from minips_tpu import launch as jlaunch
from minips_tpu.parallel import partition as jpart
from minips_tpu_torch import launch
from minips_tpu_torch.data import shm_store
from minips_tpu_torch.data.shm_store import shared_load
from minips_tpu_torch.parallel import partition as part

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(n, seed):
    """``n`` seeded (num_keys, num_shards, align) specs plus the classic
    corners (the JAX package's partition property sweep)."""
    rng = np.random.default_rng(seed)
    specs = [(int(rng.integers(0, 500)), int(rng.integers(1, 10)),
              int(rng.integers(1, 6))) for _ in range(n)]
    return specs + [(0, 4, 1), (1, 8, 3), (10, 4, 1), (7, 3, 5),
                    (500, 9, 5)]


# ------------------------------------------------------------ partitions
@pytest.mark.parametrize("seed", [42, 43, 44, 45])
def test_hash_partitioner_matches_reference(seed):
    for num_keys, shards, align in _specs(30, seed):
        p = part.HashPartitioner(num_keys, shards, align=align)
        q = jpart.HashPartitioner(num_keys, shards, align=align)
        assert (p.padded, p.shard_size) == (q.padded, q.shard_size)
        keys = np.arange(max(num_keys, 1))
        owners = p.shard_of(keys)
        np.testing.assert_array_equal(owners, q.shard_of(keys))
        np.testing.assert_array_equal(p.local_offset(keys),
                                      q.local_offset(keys))
        # the interleave round-trips every key
        np.testing.assert_array_equal(
            p.local_offset(keys) * shards + owners, keys)
        for a, b in zip(p.split(keys), q.split(keys)):
            np.testing.assert_array_equal(a, b)


def test_hash_partitioner_spreads_contiguous_hot_range():
    h = part.HashPartitioner(1 << 12, 4)
    r = part.RangePartitioner(1 << 12, 4)
    hot = np.arange(64)
    assert set(h.shard_of(hot).tolist()) == {0, 1, 2, 3}
    assert set(r.shard_of(hot).tolist()) == {0}


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_block_router_spans_match_reference(seed):
    rng = np.random.default_rng(seed)
    for num_keys, shards, align in _specs(20, seed):
        block = int(rng.integers(0, 41))  # 0 = the auto granularity
        r = part.BlockRouter(part.RangePartitioner(num_keys, shards,
                                                   align=align), block)
        j = jpart.BlockRouter(jpart.RangePartitioner(num_keys, shards,
                                                     align=align), block)
        assert (r.block_size, r.bps, r.num_blocks) \
            == (j.block_size, j.bps, j.num_blocks)
        keys = np.arange(r.part.padded)
        np.testing.assert_array_equal(r.blocks_of(keys), j.blocks_of(keys))
        covered = np.zeros(r.part.padded, bool)
        for b in range(r.num_blocks):
            lo, ln = r.block_span(b)
            assert (lo, ln) == j.block_span(b)
            assert r.home_of(b) == j.home_of(b) == lo // r.part.shard_size
            assert not covered[lo:lo + ln].any()
            covered[lo:lo + ln] = True
        assert covered.all()


def test_block_router_overlay_routing_and_epochs():
    keys = np.arange(64)
    routers = [m.BlockRouter(m.RangePartitioner(64, 4), 8)
               for m in (part, jpart)]
    for ep, ov in [(1, {0: 3}), (1, {0: 2}), (0, {}), (2, {4: 1}),
                   (3, {7: 0, 1: 2})]:
        prev = [r.apply(ep, ov) for r in routers]
        assert prev[0] == prev[1]
        np.testing.assert_array_equal(routers[0].shard_of(keys),
                                      routers[1].shard_of(keys))
        np.testing.assert_array_equal(routers[0].owner_of_blocks(),
                                      routers[1].owner_of_blocks())
        assert routers[0].table() == routers[1].table()
    # an explicit overlay routes without adopting it
    np.testing.assert_array_equal(
        routers[0].shard_of_with(keys, {0: 1}),
        routers[1].shard_of_with(keys, {0: 1}))
    assert routers[0].table() == (3, {7: 0, 1: 2})


@pytest.mark.parametrize("ov,match", [({0: 0}, "home"),
                                      ({999: 1}, "out of range"),
                                      ({0: 9}, "out of range")])
def test_block_router_rejects_bad_overlays(ov, match):
    r = part.BlockRouter(part.RangePartitioner(64, 4), 8)
    with pytest.raises(ValueError, match=match):
        r.apply(1, ov)
    assert r.table() == (0, {})


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("hosts", [
    ["localhost"] * 3,
    ["localhost", "127.0.0.1", "nodeA", "nodeA", "::1"],
    ["fe80::1", "nodeB", "fe80::1"],
])
def test_bus_addresses_and_child_env_match_reference(hosts, monkeypatch):
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    assert launch.bus_addresses(hosts, 6100) \
        == jlaunch.bus_addresses(hosts, 6100)
    for rank in range(len(hosts)):
        env = launch.child_env(rank, hosts, 6100)
        want = jlaunch.child_env(rank, hosts, 6100)
        mine = {k: v for k, v in env.items() if k.startswith("MINIPS_")}
        assert mine == {k: v for k, v in want.items()
                        if k.startswith("MINIPS_")}
        addrs = env["MINIPS_BUS_ADDRS"].split(",")
        assert launch.bus_endpoint_of(rank, addrs) == addrs[rank]
    assert launch.bus_endpoint_of(len(hosts), addrs) is None


def test_read_hostfile_and_bus_endpoint_from_env(tmp_path, monkeypatch):
    f = tmp_path / "hosts"
    f.write_text("# a comment\nnodeA\n\n  nodeB  # trailing\nlocalhost\n")
    assert launch.read_hostfile(str(f)) == jlaunch.read_hostfile(str(f)) \
        == ["nodeA", "nodeB", "localhost"]
    monkeypatch.setenv("MINIPS_BUS_ADDRS", "tcp://a:1,tcp://b:2")
    assert launch.bus_endpoint_of(1) == "tcp://b:2"
    assert launch.bus_endpoint_of(2) is None
    monkeypatch.delenv("MINIPS_BUS_ADDRS")
    assert launch.bus_endpoint_of(0) is None


def test_find_free_base_port_block_is_bindable():
    import socket

    base = launch.find_free_base_port(4)
    socks = []
    try:  # the block and its +1000 coordinator port bind right now
        for p in [base + i for i in range(4)] + [base + 1000]:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("", p))
            socks.append(s)
    finally:
        for s in socks:
            s.close()
    assert 20000 <= base < 60000


def test_spawn_rank_path_selection(tmp_path, monkeypatch):
    """Only CPU-pinned ``python -m`` ranks fork from the torch-warm
    server; a rank that may reach the card, a script path or an explicit
    opt-out stays a plain subprocess (a process that initialized CUDA
    cannot fork a CUDA child)."""
    out = (tmp_path / "o.txt").open("w+")
    argv_m = [sys.executable, "-m", "json.tool", "--help"]
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("MINIPS_FORCE_CPU", "MINIPS_SPAWN")}
    p = launch._spawn_rank(argv_m, dict(base_env), out)
    assert not isinstance(p, launch._ForkProc)
    assert p.wait(timeout=60) == 0
    env_cpu = dict(base_env, MINIPS_FORCE_CPU="1")
    p = launch._spawn_rank([sys.executable, "-c", "pass"], env_cpu, out)
    assert not isinstance(p, launch._ForkProc)
    assert p.wait(timeout=60) == 0
    monkeypatch.setenv("MINIPS_SPAWN", "subprocess")
    p = launch._spawn_rank(argv_m, env_cpu, out)
    assert not isinstance(p, launch._ForkProc)
    assert p.wait(timeout=60) == 0
    monkeypatch.delenv("MINIPS_SPAWN")
    # the eligible shape forks, and its exit code and output land as a
    # subprocess's would (argparse error: rc 2, message in the file)
    fout = (tmp_path / "f.txt").open("w+")
    p = launch._spawn_rank(
        [sys.executable, "-m", "minips_tpu_torch.launch", "--n", "0"],
        env_cpu, fout)
    assert isinstance(p, launch._ForkProc)
    assert p.wait(timeout=120) == 2
    fout.flush()
    fout.seek(0)
    assert "hostfile" in fout.read()


def test_stop_fork_server_reaps_the_server(tmp_path):
    """``stop_fork_server`` ends the torch-warm server and reaps it, so
    that nothing the launcher started outlives its caller; the next
    forked rank starts a fresh server."""
    from multiprocessing import forkserver

    env_cpu = dict(os.environ, MINIPS_FORCE_CPU="1")
    argv = [sys.executable, "-m", "minips_tpu_torch.launch", "--n", "0"]
    out = (tmp_path / "f.txt").open("w+")
    assert launch._spawn_rank(argv, env_cpu, out).wait(timeout=120) == 2
    pid = forkserver._forkserver._forkserver_pid
    assert pid is not None
    launch.stop_fork_server()
    assert forkserver._forkserver._forkserver_pid is None
    with pytest.raises(ChildProcessError):  # already reaped
        os.waitpid(pid, os.WNOHANG)
    launch.stop_fork_server()  # no server: nothing to do
    p = launch._spawn_rank(argv, env_cpu, out)
    assert isinstance(p, launch._ForkProc) and p.wait(timeout=120) == 2
    assert forkserver._forkserver._forkserver_pid not in (None, pid)


def test_run_local_job_tolerates_non_json_brace_lines():
    code = ("print({'pyrepr': 1}); print('{not json either'); "
            "import json; print(json.dumps({'ok': 1}))")
    assert launch.run_local_job(1, [sys.executable, "-c", code],
                                timeout=60) == [{"ok": 1}]
    # a malformed FINAL brace line fails loudly
    with pytest.raises(RuntimeError, match="final brace line"):
        launch.run_local_job(
            1, [sys.executable, "-c",
                "import json; print(json.dumps({'metrics': 1})); "
                "print({'result': 2})"], timeout=60)
    # the raw twin keeps every parsable line and the failing rc
    rc, events = launch.run_local_job_raw(
        2, [sys.executable, "-c",
            "import json, os, sys; r = int(os.environ['MINIPS_PROC_ID']); "
            "print(json.dumps({'rank': r})); print('{x'); sys.exit(3 * r)"],
        timeout=60)
    assert rc == 3 and events == [[{"rank": 0}], [{"rank": 1}]]


def test_launcher_cli_wires_every_rank():
    code = ("import json, os; print(json.dumps({k: os.environ[k] for k in "
            "('MINIPS_PROC_ID', 'MINIPS_NUM_PROCS', 'MINIPS_LOCAL_RANK', "
            "'MINIPS_LOCAL_PROCS')}))")
    r = subprocess.run(
        [sys.executable, "-m", "minips_tpu_torch.launch", "--n", "2",
         "--base-port", str(launch.find_free_base_port(2)), "--",
         sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    got = sorted((json.loads(ln) for ln in r.stdout.splitlines()),
                 key=lambda d: d["MINIPS_PROC_ID"])
    assert got == [{"MINIPS_PROC_ID": str(i), "MINIPS_NUM_PROCS": "2",
                    "MINIPS_LOCAL_RANK": str(i), "MINIPS_LOCAL_PROCS": "2"}
                   for i in range(2)]


# --------------------------------------------------- shared-memory store
WORKER = r"""
import json, os, sys
import numpy as np
from minips_tpu_torch.data.shm_store import shared_load
from minips_tpu_torch.data.libsvm import read_libsvm

marker, path = sys.argv[1], sys.argv[2]

def loader():
    open(f"{marker}.{os.environ['MINIPS_LOCAL_RANK']}", "w").close()
    return read_libsvm(path)

data = shared_load("t1", loader)
print(json.dumps({
    "rank": os.environ["MINIPS_LOCAL_RANK"],
    "sum": float(np.sum(data["val"])),
    "rows": int(data["y"].shape[0]),
    "mapped": all(isinstance(v, np.memmap) for v in data.values())
              if os.environ["MINIPS_LOCAL_RANK"] != "0" else None,
}))
"""


def _write_libsvm(path, rows=64, dim=10, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            y = rng.integers(0, 2)
            feats = sorted(rng.choice(dim, size=4, replace=False))
            cols = " ".join(f"{j + 1}:{rng.uniform():.4f}" for j in feats)
            f.write(f"{y} {cols}\n")


def test_shared_load_single_process_passthrough():
    calls = []
    out = shared_load("solo", lambda: (calls.append(1),
                                       {"x": np.arange(4)})[1],
                      local_rank=0, local_procs=1)
    assert calls == [1]
    np.testing.assert_array_equal(out["x"], np.arange(4))


def test_shared_load_multiprocess_parse_once(tmp_path):
    """3 colocated processes: exactly one parse, by the local leader, and
    identical zero-copy views for the attachers."""
    svm = tmp_path / "d.svm"
    _write_libsvm(str(svm))
    marker = str(tmp_path / "loaded")
    script = tmp_path / "w.py"
    script.write_text(WORKER)
    procs = []
    for lr in range(3):
        env = dict(os.environ, MINIPS_LOCAL_RANK=str(lr),
                   MINIPS_LOCAL_PROCS="3",
                   MINIPS_RUN_ID=f"torchtest{os.getpid()}",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), marker, str(svm)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    loaded = [f for f in os.listdir(tmp_path) if f.startswith("loaded.")]
    assert loaded == ["loaded.0"], loaded
    assert len({o["sum"] for o in outs}) == 1, outs
    assert len({o["rows"] for o in outs}) == 1, outs
    assert all(o["mapped"] for o in outs if o["rank"] != "0"), outs


def test_shared_load_attacher_timeout():
    with pytest.raises(TimeoutError):
        shared_load("never", lambda: {}, local_rank=1, local_procs=2,
                    timeout=0.3)


def test_sweep_reclaims_dead_runs(tmp_path):
    dead = str(tmp_path / "minips_shm_999999999_tag.x.bin")   # no such pid
    live = str(tmp_path / f"minips_shm_{os.getpid()}_tag.x.bin")
    named = str(tmp_path / "minips_shm_testrun_tag.x.bin")
    for p in (dead, live, named):
        open(p, "wb").close()
    assert shm_store.sweep_stale_segments(str(tmp_path)) == 1
    assert not os.path.exists(dead)
    assert os.path.exists(live) and os.path.exists(named)


def test_tombstone_fails_late_attacher_fast(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIPS_RUN_ID", "tomb")
    base, _ = shm_store._names("late", str(tmp_path))
    shm_store._atomic_write(base + ".tombstone", b"1")
    t0 = time.time()
    with pytest.raises(RuntimeError, match="already exited"):
        shared_load("late", lambda: {}, local_rank=1, local_procs=2,
                    directory=str(tmp_path), timeout=30.0)
    assert time.time() - t0 < 5.0


def test_run_id_namespacing_and_reference_names(tmp_path, monkeypatch):
    """Two MINIPS_RUN_IDs never share segments, and the segment names are
    the JAX package's (a mixed host sweeps one namespace)."""
    from minips_tpu.data import shm_store as jshm

    monkeypatch.setattr(shm_store, "_CLEANUP_GRACE_S", 0.1)
    monkeypatch.setenv("MINIPS_RUN_ID", "runA")
    assert shm_store._names("ns", str(tmp_path)) \
        == jshm._names("ns", str(tmp_path))
    assert shm_store.make_tag("criteo", "/x/y.tsv") \
        == jshm.make_tag("criteo", "/x/y.tsv")
    shared_load("ns", lambda: {"x": np.ones(3)}, local_rank=0,
                local_procs=2, directory=str(tmp_path))
    monkeypatch.setenv("MINIPS_RUN_ID", "runB")
    with pytest.raises(TimeoutError):
        shared_load("ns", lambda: {}, local_rank=1, local_procs=2,
                    directory=str(tmp_path), timeout=0.3)


READER = r"""
import json, sys
import numpy as np
from minips_tpu_torch.data.criteo import read_criteo
from minips_tpu_torch.data.libsvm import read_libsvm

kind, path = sys.argv[1], sys.argv[2]
read = read_criteo if kind == "criteo" else read_libsvm
shared, plain = read(path, shared=True), read(path)
print(json.dumps({k: [bool(np.array_equal(shared[k], plain[k])),
                      str(shared[k].dtype), list(shared[k].shape)]
                  for k in plain}))
"""


@pytest.mark.parametrize("kind", ["criteo", "libsvm"])
def test_shared_reads_on_two_launched_ranks(tmp_path, kind):
    """``shared=True`` under the launcher: the local leader parses, the
    other rank maps its copy, and both see the unshared read bit for bit
    (the segments carry the launcher's run id, which the leader removes
    at exit)."""
    path = str(tmp_path / f"d.{kind}")
    if kind == "libsvm":
        _write_libsvm(path, rows=96, dim=40)
    else:
        from minips_tpu_torch.data.criteo import write_criteo
        from minips_tpu_torch.data.synthetic import criteo_like

        d = criteo_like(128, seed=3)
        write_criteo(path, d["y"], d["dense"], d["cat"])
    script = tmp_path / "r.py"
    script.write_text(READER)
    res = launch.run_local_job(
        2, [sys.executable, str(script), kind, path],
        env_extra={"PYTHONPATH": REPO, "MINIPS_FORCE_CPU": "1"},
        timeout=120)
    assert res[0] == res[1]
    assert all(v[0] for v in res[0].values()), res[0]
