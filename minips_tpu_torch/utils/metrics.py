"""Structured JSONL metrics — rebuild of the reference's glog loss printing.

The reference logs per-iteration loss via glog (SURVEY.md §5.5). Here metrics
are structured JSONL records carrying the [T1] primary metric
(samples/sec/chip) plus SSP's key observable, min/max clock skew
(SURVEY.md §5.5).

A copy of ``minips_tpu/utils/metrics.py``, which imports no JAX.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO, Any, Optional


class MetricsLogger:
    """Append-only JSONL metrics sink; also mirrors to stderr when verbose.

    Thread-safe: the sharded-PS stack logs from the bus receive thread
    (drop notes, failure events) while the training thread logs step
    records — an unguarded ``write`` + ``flush`` pair can interleave two
    records into one torn JSONL line, which downstream scrapers then
    drop silently. One lock around the whole emit keeps every line
    atomic (``print`` to stderr included: the mirrored stream is
    scraped by the launcher harvest too)."""

    def __init__(self, path: Optional[str] = None, verbose: bool = True):
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self._verbose = verbose
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def log(self, **record: Any) -> dict:
        record.setdefault("t", round(time.monotonic() - self._t0, 6))
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
            if self._verbose:
                print(line, file=sys.stderr)
        return record

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def wire_record(trainer) -> dict:
    """One JSON-able record of a sharded-PS trainer's wire health: bytes
    both directions, loss/drop accounting, and the per-leg timing
    (utils/timing.CommTimers) the overlapped pipeline exposes, nested
    under ``"timing"`` — the done-line shape the apps splat into their
    result line (and the bench worker mirrors with per-window deltas),
    so sweep tooling scrapes one layout."""
    return {
        "bytes_pushed": trainer.bytes_pushed,
        "bytes_pulled": trainer.bytes_pulled,
        "frames_dropped": trainer.frames_dropped,
        "wire_frames_lost": trainer.wire_frames_lost,
        # torn/undecodable frames, counted instead of silently swallowed
        # (comm/bus.py dispatch_message) — nonzero means a stale run's
        # tail or real wire corruption, next to the loss counter on
        # purpose: both are wire-health signals the done line must carry
        "wire_frames_malformed": trainer.wire_frames_malformed,
        "timing": trainer.comm_timing(),
        # log2 latency histograms (obs/hist.py) as p50/p95/p99 blocks:
        # ALWAYS a dict (the layer is always on); a quantity that saw
        # no samples reports {"count": 0} — "idle", distinct from the
        # None an OFF layer (cache/reliable/chaos/rebalance) reports
        "hist": trainer.hist_stats(),
        # WINDOWED metrics (obs/window.py): quantiles/rates over the
        # last K clock boundaries, next to the cumulative hist block —
        # None when the layer is off (MINIPS_OBS=0, the tax arm), idle
        # quantities {"count": 0} as above (getattr: the bench worker's
        # standalone record has no trainer behind it)
        "window": getattr(trainer, "window_stats", lambda: None)(),
        # heartbeat liveness-layer counters (comm/heartbeat.py): the
        # stall= forgiveness window's hits — a forgiven stall must be
        # visible, an operator can't tell forgiveness from health
        # otherwise. None when no monitor rides this trainer.
        "heartbeat": getattr(trainer, "heartbeat_stats",
                             lambda: None)(),
        # row-cache counters (train/sharded_ps.RowCache): None when every
        # table runs cache-off, so scrapers can tell "off" from "cold"
        "cache": trainer.cache_stats(),
        # error-feedback residual counters (compressed push wire,
        # train/sharded_ps.ResidualStore): None when every table runs
        # an exact push wire — fold/retain/flush accounting is the
        # evidence no gradient mass is stranded
        "ef": getattr(trainer, "ef_stats", lambda: None)(),
        # fail-slow plane (serve/hedge.py + obs/slowness.py): hedged
        # pull-leg counters (fired/won/lost/no_holder/denied) and the
        # detection state (suspects, per-peer windowed p99s, slow
        # verdicts when the quorum is armed) — None when the
        # respective knob is off, zeros/empty when armed-but-idle
        "hedge": getattr(trainer, "hedge_stats", lambda: None)(),
        "slowness": getattr(trainer, "slowness_stats",
                            lambda: None)(),
        # hierarchical push tree (balance/hier.py): per-level byte/
        # frame split (l1 intra-group, l2 the cross-group leader leg),
        # aggregation + election/fallback counters — None when
        # MINIPS_HIER is off, zero counters when armed-idle (group=1)
        "hier": getattr(trainer, "hier_stats", lambda: None)(),
        # hybrid data plane (MINIPS_HIER agg=mesh): the leader's
        # in-host device-reduce counters — None when hier is off or
        # the host f64 backend is configured, ALL-ZERO when armed-idle
        # (group=1 never flushes); all-numeric by contract (the
        # schema test pins it)
        "hybrid": getattr(trainer, "hybrid_stats", lambda: None)(),
        # retransmission-protocol + fault-injection counters: None when
        # the respective layer is off ('off' vs 'clean' distinguishable)
        "reliable": trainer.reliable_stats(),
        "chaos": trainer.chaos_stats(),
        # per-owner serve-load counters (ALWAYS on): requests/rows this
        # process served as an owner — max/mean across ranks is the
        # partition-imbalance observable the heat-aware rebalancer acts
        # on, measurable even with the rebalancer off. Its "replica"
        # sub-block carries the read-mostly serving plane's counters
        # (replica-served/shed/lease-refused/stale-reads + the SLO
        # check): None when the plane is OFF, zero counters when armed
        # but idle — the same off-vs-idle convention as the hist block
        "serve": trainer.serve_stats(),
        # rebalancer counters (balance/): None when the subsystem is
        # off (distinguishable from an armed-but-idle run)
        "rebalance": trainer.rebalance_stats(),
        # planned collective redistribution (balance/redistribute.py):
        # round/slice/dup/abort counters and the measured per-round
        # peak staging bytes the RESHARD-MEM gate reads — None when
        # MINIPS_RESHARD is off, zero counters when armed but idle
        "reshard": getattr(trainer, "reshard_stats", lambda: None)(),
        # elastic membership plane (balance/membership.py): None when
        # MINIPS_ELASTIC is off; armed runs carry the live/standby/
        # dead/left sets and transition counters (getattr: the bench
        # worker's standalone record has no trainer behind it)
        "membership": getattr(trainer, "membership_stats",
                              lambda: None)(),
        # closed-loop autoscaler (balance/autoscaler.py): None when
        # MINIPS_AUTOSCALE is off; armed runs carry admit/drain counts,
        # hysteresis streaks, and the pre/post-admit shed rates the
        # CTRL-SCALE tripwire gates
        "autoscale": getattr(trainer, "autoscale_stats",
                             lambda: None)(),
        # multi-tenant tables (tenant/registry.py): per-tenant SLO
        # evidence — tenant id, spec'd overrides, and the deny
        # counters the serve plane attributed to each tenant's own
        # budget (shed/throttle/stale_reads/hedge_denied). None when
        # MINIPS_TENANT is off, zero counters when armed but idle —
        # the TENANT-IDLE gate pins the zeros
        "tenant": getattr(trainer, "tenant_stats", lambda: None)(),
        # push-visible-at-replica freshness (obs/freshness.py): per-
        # tenant visibility-lag p50/p99 + owner stamp counters, next to
        # the read p99 above — None when the serving plane is OFF
        # (there are no replicas to be visible at), {"count": 0} lag
        # summaries + zero counters when armed but idle
        "freshness": getattr(trainer, "freshness_stats",
                             lambda: None)(),
        # SLO burn-rate accounting (obs/slo.py): fast/slow-window burn
        # ratios per tenant, burn/clear edge counts (each burn edge is
        # a flight-recorder checkpoint), and the promotion-budget
        # flex proof (boost_ticks, per-tenant max_budget) — None when
        # MINIPS_SLO is off, zero counters when armed but idle
        "slo": getattr(trainer, "slo_stats", lambda: None)(),
    }
