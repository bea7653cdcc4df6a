"""Turn captured profiler traces into numbers — the port of
``minips_tpu/utils/trace_analysis.py``.

``profiling.profile_trace`` writes each capture as a gzipped Chrome trace
(``*.pt.trace.json.gz``, stdlib-parseable) whose complete ("X") events
carry microsecond durations. Summing them by name gives the op profile:
on the card, the kernels, copies and fills the device ran, with their
counts. The same schema as the reference's, so one reader serves both
packages' captures:

- a Kineto trace marks device work by category: ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events, on the GPU's own process
  (its ``gpu_user_annotation`` ranges repeat the host's annotations on
  the device timeline and are not work);
- a JAX capture puts each device in its own process ("/device:TPU:0
  ..."), every one of whose events is device work; ``obs/merge.py --xla``
  may be handed either, since port and JAX processes share one fleet.

With neither present (a CPU-only capture) the table reports the host
events and says so (``source: "host"``), rather than an empty table.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Optional

# Kineto's categories of work the device did (as opposed to annotations)
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def latest_trace_file(log_dir: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under ``log_dir`` (any host, any run)."""
    hits = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                     recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def load_events(path: str) -> tuple[list[dict], dict[int, str]]:
    """(complete events, pid -> process name) from a Chrome trace file."""
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    pids: dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e.get("args", {}).get("name", "")
    return [e for e in events if e.get("ph") == "X"], pids


def is_device_event(e: dict, dev_pids) -> bool:
    """Work the device did: a Kineto kernel, copy or fill, or any event
    of a JAX "/device:" process."""
    return e.get("cat") in DEVICE_CATS or e.get("pid") in dev_pids


def op_table(events: list[dict], pids: dict[int, str], *,
             device_only: bool = True, top: int = 15) -> dict:
    """Aggregate complete-event durations by op name.

    ``device_only`` keeps the device's work (:func:`is_device_event`).
    When the capture has no device (CPU-only traces carry only host
    events) it falls back to host events so the tool still reports
    something rather than an empty table.
    """
    dev_pids = {p for p, name in pids.items() if "/device:" in name}
    use_dev = device_only and (bool(dev_pids) or any(
        e.get("cat") in DEVICE_CATS for e in events))
    totals: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    span_lo, span_hi = float("inf"), 0.0
    for e in events:
        if use_dev and not is_device_event(e, dev_pids):
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        totals[name] += dur
        counts[name] += 1
        ts = float(e.get("ts", 0.0))
        span_lo = min(span_lo, ts)
        span_hi = max(span_hi, ts + dur)
    total_us = sum(totals.values())
    rows = sorted(totals, key=totals.get, reverse=True)[:top]
    return {
        "source": "device" if use_dev else "host",
        "span_us": round(max(0.0, span_hi - span_lo), 3),
        "busy_us": round(total_us, 3),
        "ops": [{
            "name": n,
            "total_us": round(totals[n], 3),
            "count": counts[n],
            "pct_of_busy": round(100.0 * totals[n] / total_us, 2)
            if total_us else 0.0,
        } for n in rows],
    }


def summarize(log_dir: str, *, top: int = 15) -> dict:
    """Op profile of the newest trace under ``log_dir`` (see op_table)."""
    path = latest_trace_file(log_dir)
    if path is None:
        return {"error": f"no *.trace.json.gz under {log_dir}"}
    events, pids = load_events(path)
    out = op_table(events, pids, top=top)
    out["trace_file"] = path
    return out


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Op-time table from a captured profiler trace dir")
    ap.add_argument("log_dir")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    try:
        print(json.dumps(summarize(args.log_dir, top=args.top), indent=2))
    except BrokenPipeError:  # e.g. piped into `head`
        os._exit(0)


if __name__ == "__main__":
    main()
