"""``utils/trace_analysis.py`` of the port against the reference's: the
synthetic traces of ``tests/test_trace_analysis.py`` give identical
tables through both packages; a Kineto-shaped capture (the GPU's process
named like the host's, as PyTorch 2.11 names it on an H100, with
annotation ranges on the device timeline) reports only the device's
kernels, copies and fills; and a real CPU capture of the port's profiler
round-trips through ``summarize`` and the CLI."""

from __future__ import annotations

import gzip
import json
import os

import pytest
import torch

from minips_tpu.utils import trace_analysis as jta
from minips_tpu_torch.utils import trace_analysis as tta
from minips_tpu_torch.utils.profiling import profile_trace


def _write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _meta(pid, name, key="process_name"):
    return {"ph": "M", "pid": pid, "name": key, "args": {"name": name}}


def _ev(pid, name, ts, dur, cat=None):
    e = {"ph": "X", "pid": pid, "name": name, "ts": ts, "dur": dur}
    if cat:
        e["cat"] = cat
    return e


REFERENCE_TRACES = {
    "device_wins": [
        _meta(1, "/host:CPU"), _meta(2, "/device:TPU:0"),
        _ev(1, "python_overhead", 0, 1000.0), _ev(2, "fusion.1", 0, 30.0),
        _ev(2, "fusion.1", 40, 30.0), _ev(2, "dot.7", 70, 40.0)],
    "host_fallback": [_meta(1, "/host:CPU"), _ev(1, "Execute", 0, 5.0)],
    "device_without_events": [_meta(1, "/host:CPU"),
                              _meta(2, "/device:TPU:0"),
                              _ev(1, "Execute", 0, 5.0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(REFERENCE_TRACES))
@pytest.mark.parametrize("top", [1, 15])
def test_reference_traces_give_identical_tables(tmp_path, case, top):
    p = str(tmp_path / "run" / "host.trace.json.gz")
    _write_trace(p, REFERENCE_TRACES[case])
    assert tta.load_events(p) == jta.load_events(p)
    events, pids = tta.load_events(p)
    assert tta.op_table(events, pids, top=top) == \
        jta.op_table(events, pids, top=top)
    assert tta.op_table(events, pids, device_only=False) == \
        jta.op_table(events, pids, device_only=False)
    assert tta.summarize(str(tmp_path)) == jta.summarize(str(tmp_path))


def test_latest_trace_file_and_missing_dir(tmp_path):
    old = str(tmp_path / "a" / "x.trace.json.gz")
    new = str(tmp_path / "b" / "y.pt.trace.json.gz")
    _write_trace(old, [])
    _write_trace(new, [])
    os.utime(old, (1, 1))
    assert tta.latest_trace_file(str(tmp_path)) == new == \
        jta.latest_trace_file(str(tmp_path))
    assert "error" in tta.summarize(str(tmp_path / "nothing"))
    assert tta.summarize(str(tmp_path / "nothing")) == \
        jta.summarize(str(tmp_path / "nothing"))


def test_kineto_capture_reports_the_device(tmp_path):
    """Host ops, runtime calls and the device's annotation ranges stay
    out; the kernels, copies and fills on the GPU's process are the
    table, with their counts."""
    p = str(tmp_path / "k" / "h_1.0.pt.trace.json.gz")
    _write_trace(p, [
        _meta(118, "python3"), _meta(0, "python3"),
        _meta(0, "GPU 0", key="process_labels"),
        _ev(118, "aten::mm", 0, 40.0, "cpu_op"),
        _ev(118, "cudaLaunchKernel", 5, 8.0, "cuda_runtime"),
        _ev(118, "my_region", 0, 90.0, "user_annotation"),
        _ev(0, "my_region", 10, 70.0, "gpu_user_annotation"),
        _ev(0, "gather_rows_kernel<u32,r1,i32>", 10, 15.0, "kernel"),
        _ev(0, "gather_rows_kernel<u32,r1,i32>", 30, 15.0, "kernel"),
        _ev(0, "Memcpy DtoH (Device -> Pageable)", 50, 20.0, "gpu_memcpy"),
        _ev(0, "Memset (Device)", 75, 5.0, "gpu_memset"),
    ])
    out = tta.summarize(str(tmp_path / "k"))
    assert out["source"] == "device" and out["busy_us"] == 55.0
    assert out["span_us"] == 70.0
    by = {o["name"]: o for o in out["ops"]}
    assert set(by) == {"gather_rows_kernel<u32,r1,i32>",
                       "Memcpy DtoH (Device -> Pageable)", "Memset (Device)"}
    assert by["gather_rows_kernel<u32,r1,i32>"]["count"] == 2
    assert by["gather_rows_kernel<u32,r1,i32>"]["pct_of_busy"] == 54.55
    host = tta.op_table(*tta.load_events(p), device_only=False)
    assert host["source"] == "host" and host["busy_us"] == 263.0


def test_roundtrip_real_capture(tmp_path, capsys):
    """profile_trace -> summarize on the CPU: the port's capture is
    analyzable by the same package, from Python and from the CLI."""
    x = torch.ones(256, 256)
    (x @ x.T).sum()
    with profile_trace(str(tmp_path), device="cpu"):
        (x @ x.T).sum()
    out = tta.summarize(str(tmp_path))
    assert "error" not in out, out
    assert out["source"] == "host" and out["ops"] and out["busy_us"] > 0
    assert "aten::mm" in {o["name"] for o in out["ops"]}
    tta.main([str(tmp_path), "--top", "3"])
    cli = json.loads(capsys.readouterr().out)
    assert len(cli["ops"]) == 3 and cli["trace_file"] == out["trace_file"]
