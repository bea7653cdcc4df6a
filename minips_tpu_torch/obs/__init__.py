"""Observability layer for the sharded PS.

Six pieces, all reading the same per-rank event stream:

- :mod:`minips_tpu_torch.obs.tracer` — the env-gated (``MINIPS_TRACE``)
  bounded ring buffer of typed wire events, dumped as Chrome-trace JSON
  per rank;
- :mod:`minips_tpu_torch.obs.hist` — fixed-bucket log2 latency histograms
  (always on, independent of the tracer) feeding p50/p95/p99 into the
  done lines next to the means;
- :mod:`minips_tpu_torch.obs.window` — WINDOWED metrics over the cumulative
  histograms/counters (always on, ``MINIPS_OBS=0`` for the tax arm):
  ring-buffered per-interval deltas, so quantiles and rates answer
  "now", not "since boot" — the autoscaler's arming signal;
- :mod:`minips_tpu_torch.obs.flight` — the always-on black-box FLIGHT
  RECORDER: a bounded typed decision/death event ring each rank dumps
  atomically on every poison path (and atexit), so a chaos kill leaves
  a post-mortem artifact with zero pre-arming;
- :mod:`minips_tpu_torch.obs.merge` — the cross-rank trace merger: clock
  alignment from heartbeat exchange, flow arrows linking client pull
  legs to owner serves, optional XLA device-trace interleave (the
  flight module carries its own merge CLI reusing the same clock-offset
  estimate);
- :mod:`minips_tpu_torch.obs.report` — blocked-time attribution over a merged
  trace (per-rank: fraction blocked on which owner / gate peer /
  fence).

Everything here is import-light on purpose: the tracer and flight
modules are imported by every hot-path module (bus, tables, gate) and
must cost one attribute lookup + one branch when quiet.

A copy of ``minips_tpu/obs``, which imports no JAX; ``merge``'s
``--xla`` interleave waits for ``utils/trace_analysis.py`` (ROADMAP.md
queue 1 item 17) and raises until then.
"""
