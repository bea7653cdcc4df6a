"""Device-trace arithmetic: what a ``torch.profiler`` capture says the
card did.

A copy of the device-table reading of
``minips_tpu_torch/utils/trace_analysis.py`` (Kineto's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events are the device's work; the GPU's
process carries the same name as the host's, so the category decides,
never the process name), kept here so that the yardstick does not move
with the program. Beside the op table it gives the union of the device's
busy intervals over the traced window and the idle gaps between them,
each named by the host operation that was running in its middle.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# host events that say what the host was doing (operators, the benchmark's
# own annotations, runtime calls)
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver", "python_function"})
TOP = 10


def load(path: str) -> list[dict]:
    """The complete ("X") events of a Chrome trace file, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def summarize(events: list[dict]) -> dict:
    """The device's work in a capture: ``busy_s`` (the union of its kernel,
    copy and fill intervals), ``window_s`` (first device event's start to
    the last one's end), ``ops`` ({name: [count, seconds]}, each event's
    own duration), ``device_ops`` and ``idle_gaps`` (the ``TOP`` largest,
    as ``[name, seconds]``; a gap is named by the shortest host event
    that covers its middle). Times in seconds; trace times are in us."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "device_ops": [],
                "idle_gaps": []}
    ops: dict[str, list] = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        ops[e.get("name", "?")][0] += 1
        ops[e.get("name", "?")][1] += dur * 1e-6
    busy = _merge(spans)
    lo, hi = busy[0][0], busy[-1][1]
    busy_us = sum(b - a for a, b in busy)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    by_host = _name_gaps(gaps, [e for e in events
                                if e.get("cat") in HOST_CATS])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "ops": {k: list(v) for k, v in ops.items()},
            "device_ops": [[k, v[1]] for k, v in top_ops],
            "idle_gaps": [[k, v] for k, v in top_gaps]}


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by the host event running in each gap's middle: a
    sweep over gaps and host events, both in time order."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in host)
    out: dict[str, float] = defaultdict(float)
    active: list[tuple[float, float, str]] = []
    i = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active \
            else "(no host event)"
        out[name] += (b - a) * 1e-6
    return out


def kernel_seconds(trace: dict, *needles: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    ``needles``."""
    n, s = 0, 0.0
    for name, (count, secs) in trace["ops"].items():
        if any(k in name for k in needles):
            n += count
            s += secs
    return n, s
