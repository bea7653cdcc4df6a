"""Merge per-rank wire traces into ONE cross-rank Chrome trace.

``python -m minips_tpu_torch.obs.merge <dir-or-files...> [-o merged.json]
[--xla <logdir>]``

Three jobs:

1. **Clock alignment.** Every rank stamps events with its own
   ``time.monotonic()``. On one host those clocks share an epoch, but
   the merge must not assume it (multi-host runs, containers with
   per-namespace clocks) — so offsets are ESTIMATED from the heartbeat
   exchange the stack already runs: every rank records an ``hb``
   instant per received beat carrying the sender's send timestamp
   (comm/heartbeat.py). For a rank pair (a, b), with
   ``d_ab = min over a's receipts of (t_recv_a − t_sent_b)`` and the
   symmetric ``d_ba``, the one-way delays cancel:
   ``offset_a − offset_b = (d_ab − d_ba) / 2`` — the classic NTP
   two-sample estimate, min-filtered against scheduling jitter. Rank 0
   is the reference; ranks without bidirectional samples merge with
   offset 0 and a note in the summary.

2. **Flow linking.** The tracer's flow events carry ids both ends
   derived independently (``tracer.flow_id``); the merger counts the
   ids that appear with an 's' phase on one rank and an 'f' phase on
   another — the cross-rank arrows. ``flows_linked`` in the summary is
   what the TRACE-TAX bench gate asserts (>= 1), and per-(src→dst)
   pair counts let the acceptance drill check one flow per remote
   owner.

3. **XLA interleave** (``--xla <logdir>``; in this copy it raises
   ``NotImplementedError`` until ``utils/trace_analysis.py`` is ported,
   ROADMAP.md queue 1 item 17): the newest
   ``*.trace.json.gz`` the profiler wrote (utils/trace_analysis.py) is
   appended with its pids offset past the rank pids, so device compute
   and wire activity share one timeline. XLA traces carry their own
   epoch; they are shifted so their first event aligns with the first
   wire event — coarse, but the intra-trace timing is what matters.

Exit 0 with a one-line JSON summary on stdout; nonzero when no rank
trace was found or the output could not be written.

A copy of ``minips_tpu/obs/merge.py``, which imports no JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from typing import Optional

__all__ = ["load_rank_traces", "estimate_offsets_us", "merge_traces",
           "main"]

# device-trace pids are offset past any plausible rank pid; the report
# uses the same constant to keep XLA processes out of the rank table
XLA_PID_BASE = 10_000


def load_rank_traces(paths: list[str]) -> dict[int, dict]:
    """``{rank: trace doc}`` from explicit files and/or directories
    (directories glob ``trace-rank*.json``)."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(
                os.path.join(p, "trace-rank*.json"))))
        else:
            files.append(p)
    out: dict[int, dict] = {}
    for f in files:
        with open(f) as fh:
            doc = json.load(fh)
        rank = int((doc.get("otherData") or {}).get("rank", len(out)))
        out[rank] = doc
    return out


def _hb_samples(traces: dict[int, dict]) -> dict[tuple[int, int], float]:
    """``{(receiver, sender): min(t_recv − t_sent) in us}`` over every
    recorded heartbeat receipt."""
    best: dict[tuple[int, int], float] = {}
    for rank, doc in traces.items():
        for e in doc.get("traceEvents", ()):
            if e.get("name") != "hb" or e.get("ph") != "i":
                continue
            a = e.get("args") or {}
            snd = a.get("from")
            t_sent = a.get("t_sent")
            if snd is None or t_sent is None:
                continue
            d = float(e["ts"]) - float(t_sent) * 1e6
            key = (rank, int(snd))
            if key not in best or d < best[key]:
                best[key] = d
    return best


def estimate_offsets_us(traces: dict[int, dict]
                        ) -> tuple[dict[int, float], list[int]]:
    """Per-rank clock offset vs rank 0 (``aligned = ts − offset``), and
    the ranks that lacked bidirectional heartbeat data (offset 0)."""
    ranks = sorted(traces)
    if not ranks:
        return {}, []
    ref = ranks[0]
    best = _hb_samples(traces)
    offsets = {ref: 0.0}
    unaligned: list[int] = []
    for r in ranks:
        if r == ref:
            continue
        d_r_ref = best.get((r, ref))     # ref's beats as seen at r
        d_ref_r = best.get((ref, r))     # r's beats as seen at ref
        if d_r_ref is None or d_ref_r is None:
            offsets[r] = 0.0
            unaligned.append(r)
        else:
            offsets[r] = (d_r_ref - d_ref_r) / 2.0
    return offsets, unaligned


def _link_flows(events: list[dict]) -> tuple[int, dict[str, int]]:
    """Count flow ids seen with 's' on one pid and 'f' on a different
    pid; also per ``"src->dst"`` pair counts."""
    starts: dict[int, set] = defaultdict(set)
    ends: dict[int, set] = defaultdict(set)
    for e in events:
        if e.get("ph") == "s":
            starts[e.get("id")].add(e.get("pid"))
        elif e.get("ph") == "f":
            ends[e.get("id")].add(e.get("pid"))
    linked = 0
    pairs: dict[str, int] = defaultdict(int)
    for fid, spids in starts.items():
        for epid in ends.get(fid, ()):
            for spid in spids:
                if spid != epid:
                    linked += 1
                    pairs[f"{spid}->{epid}"] += 1
    return linked, dict(sorted(pairs.items()))


def _load_xla(logdir: str, t_base_us: float) -> list[dict]:
    raise NotImplementedError(
        "merge --xla is not ported yet (ROADMAP.md queue 1 item 17: "
        "utils/trace_analysis.py, which finds the profiler's trace)")


def merge_traces(paths: list[str], *, xla_logdir: Optional[str] = None
                 ) -> tuple[dict, dict]:
    """(merged trace doc, summary dict). Raises FileNotFoundError when
    no rank trace exists under ``paths``."""
    traces = load_rank_traces(paths)
    if not traces:
        raise FileNotFoundError(
            f"no trace-rank*.json under {paths!r}")
    offsets, unaligned = estimate_offsets_us(traces)
    merged: list[dict] = []
    for rank, doc in sorted(traces.items()):
        off = offsets.get(rank, 0.0)
        for e in doc.get("traceEvents", ()):
            if "ts" in e and e.get("ph") != "M":
                e = dict(e)
                e["ts"] = round(float(e["ts"]) - off, 3)
            merged.append(e)
    linked, pairs = _link_flows(merged)
    t_base = min((float(e["ts"]) for e in merged
                  if "ts" in e and e.get("ph") != "M"), default=0.0)
    xla_events = 0
    if xla_logdir:
        xe = _load_xla(xla_logdir, t_base)
        xla_events = len(xe)
        merged.extend(xe)
    summary = {
        "ranks": sorted(traces),
        "events": sum(len(d.get("traceEvents", ())) for d in
                      traces.values()),
        "flows_linked": linked,
        "flow_pairs": pairs,
        "clock_offsets_us": {str(r): round(o, 1)
                             for r, o in sorted(offsets.items())},
        "unaligned_ranks": unaligned,
        "xla_events": xla_events,
    }
    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "otherData": summary}
    return doc, summary


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-rank MINIPS_TRACE files into one "
                    "cross-rank Chrome trace")
    ap.add_argument("paths", nargs="+",
                    help="trace dirs and/or trace-rank*.json files")
    ap.add_argument("-o", "--out", default=None,
                    help="merged output (default: "
                         "<first dir>/merged_trace.json)")
    ap.add_argument("--xla", default=None, metavar="LOGDIR",
                    help="interleave the newest *.trace.json.gz under "
                         "LOGDIR (profiler output) on the same "
                         "timeline")
    args = ap.parse_args(argv)
    try:
        doc, summary = merge_traces(args.paths, xla_logdir=args.xla)
    except FileNotFoundError as e:
        print(f"merge: {e}", file=sys.stderr)
        return 1
    out = args.out
    if out is None:
        base = args.paths[0]
        base = base if os.path.isdir(base) else os.path.dirname(base)
        out = os.path.join(base or ".", "merged_trace.json")
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    summary["merged"] = out
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
