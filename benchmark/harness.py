"""One run of one cell: set-up, the first steps checked, the measured
window, the traced steps (``--trace 1``), the reference, and the result
line.

The order is the contract's: set-up builds the program from the seed and
drives its first steps through the window's own call, keeping what the
check needs; the window measures; the peak memory is read; the traced
steps run; the program is freed; the plain reference recomputes the first
steps from the same inputs; the numbers are compared with their limits.
Standard error ends with each number compared beside its limit, and the
last line of standard output is the result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import compare, devtrace, readers, spec, window

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from (compared whole: the program's own
# name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "minips_tpu"})


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _device_block(device: torch.device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak,
                "power_limit": _power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def _allocator(dev: torch.device) -> dict:
    """The caching allocator's retries (a full free and a retry, which
    waits for the card) and cudaMalloc calls so far."""
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_alloc_retries",
                                      "segment.all.allocated")}


def _describe(win, gc_before, alloc_before, alloc_after, err) -> None:
    """One line on standard error about the window: its step times and
    what could have stalled them (garbage collections by generation, the
    allocator's retries and new segments)."""
    ms = win.step_ms or [float("nan")]
    p90 = readers.p90(ms) or float("nan")
    gcs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    alloc = {k: alloc_after[k] - alloc_before[k] for k in alloc_after}
    print(f"window: {win.steps} steps in {win.seconds:.3f} s; step ms min "
          f"{min(ms):.3f} median {statistics.median(ms):.3f} p90 {p90:.3f}"
          f" max {max(ms):.3f}; gc collections by generation {gcs}; "
          f"allocator {alloc}", file=err)


def _capture(program, steps: int, dev: torch.device, *, host: bool) -> dict:
    path = window.trace(program, steps, dev, host=host)
    try:
        return devtrace.summarize(devtrace.load(path))
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t0: float, device: str | None = None, root: str | None = None,
        out=None, err=None) -> dict:
    """Run one cell and print its result; returns the result. ``device``
    None is the card, which must be there with the cell's chips; the CPU
    tests pass ``"cpu"`` at tiny sizes."""
    out, err = out or sys.stdout, err or sys.stderr
    root = root or os.path.dirname(spec.HERE)
    cell = spec.load_cell(root, workload)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                           f"available: {torch.cuda.is_available()}, "
                           f"count: {torch.cuda.device_count()}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # set-up: the program, the first steps checked, the warm-up
    marks = [("start", time.monotonic())]
    program = cell.family().Program(cell.config, cell.traffic, seed, dev)
    window.sync(dev)
    marks.append(("program and pool", time.monotonic()))
    prog_readings = program.checked_steps()
    marks.append(("checked steps", time.monotonic()))
    for _ in range(cell.traffic["warmup_steps"]):
        program.step()
    window.sync(dev)
    marks.append(("warm-up", time.monotonic()))
    # set-up's garbage is collected here and what is left is kept out of
    # the window's collections, which then scan only what the steps make
    gc.collect()
    gc.freeze()
    marks.append(("gc", time.monotonic()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - t0
    print("setup: imports " + "; ".join(
        f"{marks[0][1] - t0:.3f} s" if i == 0 else
        f"{name} {marks[i][1] - marks[i - 1][1]:.3f} s"
        for i, (name, _) in enumerate(marks)), file=err)

    gc_before = [g["collections"] for g in gc.get_stats()]
    alloc_before = _allocator(dev)
    win = window.measure(program, seconds, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    _describe(win, gc_before, alloc_before, _allocator(dev), err)
    failed = 0  # window steps whose loss is not finite
    if win.steps:
        losses = torch.stack([torch.stack(list(x)) if isinstance(x, tuple)
                              else x for x in win.losses]).float()
        failed = int((~torch.isfinite(losses.reshape(win.steps, -1)))
                     .any(-1).sum())
    tr = None
    if traced:
        # the device's work over the traced steps, captured without the
        # host's operator events (which lengthen the host's gaps); then one
        # step with them, to name each idle gap by what the host was doing
        tr = _capture(program, cell.traffic["trace_steps"], dev, host=False)
        named = _capture(program, 1, dev, host=True)
        tr["idle_gaps"] = named["idle_gaps"]
        tr["steps"] = cell.traffic["trace_steps"]
        print(f"trace: {tr['steps']} steps, device busy {tr['busy_s']:.6f}"
              f" s of {tr['window_s']:.6f} s; the step traced with host "
              f"events: busy {named['busy_s']:.6f} s of "
              f"{named['window_s']:.6f} s", file=err)
    work = program.work() if traced else {}
    if traced:
        print("work: " + json.dumps(work), file=err)
    units = program.units
    inputs = program.check_inputs()
    program.free()
    del program
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_readings = cell.reference().readings(cell.config, inputs, seed, dev)
    nums = compare.numbers(prog_readings, ref_readings)
    ok, checks = compare.judge(nums, cell.limits)
    correct = ok and failed == 0

    device_block = _device_block(dev, chips, peak)
    record = SimpleNamespace(setup_s=setup_s, window=win, trace=tr,
                             work=work, units=units,
                             kind=device_block["kind"])
    metrics = {}
    for m in cell.metrics("per_layer" if traced else "end_to_end"):
        value = spec.metric_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if tr is not None:
        device_block.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": correct, "attempted": win.steps, "failed": failed,
              "metrics": metrics, "device": device_block}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    checks["failed_steps"] = {"value": failed, "limit": 0}

    found = forbidden_modules()
    if found:
        raise ImportError(f"modules loaded in the run: {found}")
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=err)
    # last in the line: each number compared beside its limit (a number
    # that is not finite, from a side that gave none, as null)
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                            else None, "limit": c["limit"]}
                        for k, c in checks.items()}
    print(json.dumps(result), file=out, flush=True)
    return result
