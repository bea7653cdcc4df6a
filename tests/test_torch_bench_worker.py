"""The port's sharded-PS bench worker (``apps/sharded_ps_bench.py``),
held against the JAX package's.

- The reference's worker cases on the port: ``tests/test_bench.py``'s
  standalone zero-wire run, ``--compute jit`` (forced to the CPU) and
  the two-process floor (slow, as there), and ``tests/test_obs_trace.py``'s
  done-line layout.
- Both packages' workers on the CPU, same argv: the done lines have the
  same keys, and every value that does not hang on the host's clock or
  scheduling is equal — the config echoes, the wire counters, the
  drills' stamps. Left out of the comparison: rates and latencies, the
  mesh arm's wave counts and its sparse deposit's peak staging (a BSP
  tick lets the eager full wave fire within a 50 ms grace, so a loaded
  host can flush a rank alone, and a wave stages what its ranks sent), and
  the JAX worker's ``device_count`` in this process, where the test
  suite forces 8 host devices (its CLI forces ``--mesh-ranks``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from minips_tpu.apps import sharded_ps_bench as jbench
from minips_tpu_torch.apps import sharded_ps_bench as bench

REPO = str(pathlib.Path(__file__).resolve().parents[1])
CPU = {"MINIPS_FORCE_CPU": "1", "OMP_NUM_THREADS": "1",
       "JAX_PLATFORMS": "cpu"}
SMALL = ["--iters", "8", "--warmup", "2", "--rows", "4096", "--batch",
         "512"]
# values that hang on the clock or on thread scheduling
VOLATILE = {"wall_s", "rows_per_sec", "cycles_per_sec",
            "aggregate_rows_per_sec", "rows_per_sec_ranks", "hist",
            "timing", "waves", "sparse_waves", "gate_waits",
            "collective_bytes", "collective_bytes_per_row_moved",
            "wire_push_bytes_per_sec", "wire_pull_bytes_per_sec",
            "device_count", "peak_deposit_bytes"}


def _done(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _cli(pkg: str, args, timeout=180):
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.apps.sharded_ps_bench", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, **CPU})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return _done(proc.stdout)


def test_sharded_ps_bench_worker_standalone():
    """Zero-wire baseline mode (no launcher) on the port."""
    out = _cli("minips_tpu_torch", ["--path", "sparse", *SMALL])
    assert out["event"] == "done" and out["nprocs"] == 1
    assert out["bus"] == "none"
    assert out["rows_per_sec"] > 0
    assert out["wire_push_bytes_per_sec"] == 0  # nothing rides a wire


def test_sharded_ps_bench_worker_jit_compute():
    """--compute jit on the port: the row-gradient step runs by autograd
    on the rank's device (the CPU here) between pull and push; the done
    line names the device type, as the reference's names its backend,
    and has the reference's keys."""
    args = ["--path", "sparse", *SMALL, "--compute", "jit",
            "--hidden", "64"]
    out = _cli("minips_tpu_torch", args)
    assert out["event"] == "done" and out["compute"] == "jit(cpu)"
    assert out["rows_per_sec"] > 0
    ref = _cli("minips_tpu", args)
    assert sorted(out) == sorted(ref)
    assert out["compute"] == ref["compute"]


@pytest.mark.slow
def test_sharded_ps_bench_floor_two_processes():
    """The port's two-process loopback sparse pull+push floor: >100k
    rows/sec per process, zero dropped frames (asserted in-worker)."""
    from minips_tpu_torch import launch

    res = launch.run_local_job(
        2, [sys.executable, "-m", "minips_tpu_torch.apps.sharded_ps_bench",
            "--path", "sparse", "--iters", "24", "--warmup", "4"],
        base_port=None, timeout=240.0, env_extra=dict(CPU))
    assert len(res) == 2
    for r in res:
        assert r["event"] == "done" and r["nprocs"] == 2
        assert r["rows_per_sec"] > 100_000, r
        assert r["wire_push_bytes_per_sec"] > 0  # wire actually engaged


def test_bench_done_line_carries_wire_record_layout(capsys):
    """The standalone bench path builds the SAME record through its
    adapter — layout defined once in utils/metrics.wire_record."""
    rc = bench.main(["--iters", "4", "--warmup", "1",
                     "--rows", "512", "--batch", "64"])
    assert rc == 0
    rec = _done(capsys.readouterr().out)
    for k in ("hist", "timing", "cache", "ef", "reliable", "chaos",
              "serve", "rebalance", "bytes_pushed", "bytes_pulled",
              "frames_dropped", "wire_frames_lost",
              "wire_frames_malformed", "trace_file"):
        assert k in rec, k
    assert rec["reliable"] is None and rec["trace_file"] is None
    assert rec["hist"]["pull_latency_ms"]["count"] > 0
    assert rec["timing"]["pull_latency_ms_p99"] is not None


def _main(mod, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return _done(buf.getvalue())


def _stable(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in VOLATILE}


@pytest.mark.parametrize("argv", [
    SMALL, [*SMALL, "--path", "dense"], [*SMALL, "--key-dist", "zipf"],
    ["--plane", "mesh", *SMALL, "--staleness", "0"],
    ["--plane", "mesh", *SMALL, "--staleness", "0", "--mesh-comm", "blk8",
     "--mesh-deposit", "sparse", "--updater", "adam"],
    ["--plane", "mesh", *SMALL, "--path", "dense", "--mesh-ranks", "2"],
    ["--mesh-bitwise-drill"], ["--hier-bitwise-drill"],
    ["--hybrid-idle-drill"], ["--hybrid-degenerate-drill"],
    ["--traffic-idle-drill"], ["--tenant-idle-drill"],
    ["--fail-slow-idle-drill"], ["--reshard-mem-drill"]],
    ids=["sparse", "dense", "zipf", "mesh", "mesh-blk8-sparse-adam",
         "mesh-dense", "mesh-drill", "hier-drill", "hybrid-idle",
         "hybrid-degenerate", "traffic-idle", "tenant-idle",
         "fail-slow-idle", "reshard-mem"])
def test_done_lines_match_the_jax_worker(argv, monkeypatch):
    monkeypatch.setenv("MINIPS_FORCE_CPU", "1")
    monkeypatch.delenv("MINIPS_HIER_MESH_DEVS", raising=False)
    threads = torch.get_num_threads()
    ref = _main(jbench, argv)
    # the degenerate drill pins its one-device tier in os.environ
    os.environ.pop("MINIPS_HIER_MESH_DEVS", None)
    got = _main(bench, argv)
    os.environ.pop("MINIPS_HIER_MESH_DEVS", None)
    torch.set_num_threads(threads)
    assert sorted(got) == sorted(ref)
    assert _stable(got) == _stable(ref)
    if got.get("plane") == "mesh":
        assert got["device_count"] == got["mesh_ranks"]
        assert got["iters_timed"] <= got["waves"]
        if got["deposit"] == "dense":  # fixed [n, rows, dim] buffers
            assert got["peak_deposit_bytes"] == ref["peak_deposit_bytes"]
