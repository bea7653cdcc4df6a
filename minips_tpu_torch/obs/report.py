"""Blocked-time attribution over a merged wire trace.

``python -m minips_tpu_torch.obs.report merged_trace.json [--json]``

The straggler observable: for each rank, how much wall time it spent
BLOCKED, split by what it was blocked ON —

- ``owner <r>``: waiting for a pull leg's reply from shard owner ``r``
  (``pull_wait`` spans; when the span's per-leg ``pull_leg`` children
  are present the wait is attributed to the leg that finished LAST
  inside it — the actual straggler — otherwise split evenly over the
  span's owners);
- ``gate <r>``: the SSP gate waiting for rank ``r``'s clock
  (``gate_wait`` spans, split evenly over the ``behind`` ranks);
- ``fence``: a local read fenced behind an in-flight block migration
  (``fence_wait`` spans).

This table is what every future perf PR reads first: it turns "rank 2
is slow" into "rank 2 spends 38% of its wall blocked, 31% of that on
owner 0's serves" — the difference between guessing and aiming.

A copy of ``minips_tpu/obs/report.py``, which imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from bisect import bisect_right
from collections import defaultdict
from typing import Optional

from minips_tpu_torch.obs.merge import XLA_PID_BASE

__all__ = ["attribute", "format_table", "main"]


def _span(e: dict) -> tuple[float, float]:
    ts = float(e.get("ts", 0.0))
    return ts, ts + float(e.get("dur", 0.0))


def attribute(doc: dict) -> dict:
    """``{rank: {"wall_us", "blocked_us", "by": {label: us}}}`` over a
    merged (or single-rank) trace document. Device processes an
    ``--xla`` interleave added (pid >= merge.XLA_PID_BASE) are not
    ranks and stay out of the table."""
    events = doc.get("traceEvents", ())
    by_rank: dict[int, list[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and int(e.get("pid", 0)) < XLA_PID_BASE:
            by_rank[int(e.get("pid", 0))].append(e)
    out: dict[int, dict] = {}
    for rank, evs in sorted(by_rank.items()):
        lo = min(_span(e)[0] for e in evs)
        hi = max(_span(e)[1] for e in evs)
        by: dict[str, float] = defaultdict(float)
        # legs sorted by END time once per rank: each wait span then
        # finds its last-finishing leg by bisection — a full-ring trace
        # has tens of thousands of each, and the quadratic rescan this
        # replaces took minutes on exactly the traces the tool is for
        legs = sorted((e for e in evs if e.get("name") == "pull_leg"),
                      key=lambda g: _span(g)[1])
        leg_ends = [_span(g)[1] for g in legs]
        for e in evs:
            name = e.get("name")
            t0, t1 = _span(e)
            dur = t1 - t0
            if dur <= 0.0:
                continue
            args = e.get("args") or {}
            if name == "pull_wait":
                # prefer the actual straggler: the leg whose reply
                # landed last inside this wait span — with leg_ends
                # sorted, walk left from the rightmost end <= t1
                # (+jitter) while still inside the window. The leg
                # must belong to one of THIS wait's owners: with
                # prefetch overlap another table/group's leg routinely
                # completes inside an unrelated wait span, and blaming
                # its owner would book the whole wait to the wrong
                # shard.
                owners = args.get("owners") or ["?"]
                owner_set = set(owners)
                pick = None
                i = bisect_right(leg_ends, t1 + 1.0) - 1
                while i >= 0 and leg_ends[i] >= t0 - 1.0:
                    o = (legs[i].get("args") or {}).get("owner", "?")
                    if o in owner_set:
                        pick = o
                        break
                    i -= 1
                if pick is not None:
                    by[f"owner {pick}"] += dur
                else:
                    for o in owners:
                        by[f"owner {o}"] += dur / len(owners)
            elif name == "gate_wait":
                behind = args.get("behind") or ["?"]
                for p in behind:
                    by[f"gate {p}"] += dur / len(behind)
            elif name == "fence_wait":
                by["fence"] += dur
        blocked = sum(by.values())
        out[rank] = {
            "wall_us": round(hi - lo, 1),
            "blocked_us": round(blocked, 1),
            "blocked_frac": round(blocked / (hi - lo), 4)
            if hi > lo else 0.0,
            "by": {k: round(v, 1)
                   for k, v in sorted(by.items(),
                                      key=lambda kv: -kv[1])},
        }
    return out


def format_table(attr: dict) -> str:
    """The human table (one rank per row, top-3 attributions)."""
    lines = [f"{'rank':>4}  {'wall_ms':>9}  {'blocked':>8}  "
             f"top blocked-on"]
    for rank, r in sorted(attr.items()):
        wall = r["wall_us"]
        tops = list(r["by"].items())[:3]
        top_s = ", ".join(
            f"{k} {100.0 * v / wall:.1f}%" for k, v in tops) or "-"
        lines.append(
            f"{rank:>4}  {wall / 1e3:>9.1f}  "
            f"{100.0 * r['blocked_frac']:>7.1f}%  {top_s}")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Blocked-time attribution table from a merged "
                    "wire trace")
    ap.add_argument("trace", help="merged_trace.json (obs.merge output)")
    ap.add_argument("--json", action="store_true",
                    help="emit the attribution dict instead of the "
                         "table")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    attr = attribute(doc)
    if not attr:
        print("report: no complete events in trace", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({str(k): v for k, v in attr.items()}))
    else:
        print(format_table(attr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
