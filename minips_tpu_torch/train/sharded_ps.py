"""Key-range-sharded multi-process parameter server — a copy of
``minips_tpu/train/sharded_ps.py``, which imports no JAX: the servers are
numpy on the host, and the apps run each process's model step in PyTorch
on the process's device (``apps/*_example.py --exec multiproc``). The
hierarchical push tree's device reduce (``MINIPS_HIER`` ``agg=mesh``) is
``train/mesh_plane.py``'s ``MeshAggregator`` on the leader's devices.

This is the reference's *actual* server topology (SURVEY.md §1 L2, §2
SimpleRangeManager/ServerThread/KVTable rows): every process hosts a server
shard owning a contiguous row range of each table, and worker pushes/pulls
route **per-owner key slices** over the bus — point-to-point directed
frames, not full-model broadcasts. This replaces the replicated delta relay
(train/ssp_trainer.py) for workloads whose tables don't fit one host:

- per-process table memory is ``~1/N`` of the table (plus optimizer state,
  sharded identically — PS state *is* optimizer state);
- wire traffic per push is the touched rows, split by owner (the sparse
  Criteo/W&D case ships only the batch's embedding rows, SURVEY.md §7.4.2);
- the server applies the updater (SGD/Adagrad/lazy-Adam, reference
  ``updater->Update(keys, grads)`` semantics with duplicate keys summed
  first) on receipt, exactly the reference's server-side optimizer;
- consistency is the same StalenessGate + ClockGossip as the delta relay —
  BSP/SSP/ASP admission is unchanged (consistency/gate.py).

Why the SSP contract holds — admission happens AT THE OWNER, like the
reference's server-side ``model->Get`` (SURVEY.md §3.3): every pull request
carries the requester's clock ``c``; the owner serves it only once *its
own* view of the global min clock reaches ``c − s``, otherwise the request
is **parked** (the reference's PendingBuffer) and re-checked on every clock
message. Every bus backend preserves per-(sender → receiver) frame order,
and a worker pushes its step-``k`` slices *before* publishing clock ``k`` —
so when the owner's view says peer P reached ``c − s``, P's pushes through
``c − s`` have already been applied to the owner's shard. An admitted pull
therefore reads state containing every peer's updates up to ``c − s``, the
SSP contract, enforced per-owner (client-side gating alone could not
promise this: the pusher→owner link and the pusher→reader clock broadcast
are different links).

Numerics: the server-side numpy updaters match ops/sparse_update.py's
row_sgd/row_adagrad/row_adam (sum-duplicates-then-update; lazy moments for
adam) bit-for-bit at f32 — the parity tests in tests/test_sharded_ps.py
assert it against those oracles.

The OVERLAPPED pipeline: the synchronous loop pays
full round-trip latency on every leg, so the hot path grows three
independently-gated levers —

- **async push** (``async_push=True``): ``push()``/``push_dense()``
  enqueue and return; a per-table sender thread routes/encodes/sends,
  and every cross-process frame carries a sequence number the owner
  ACKS after applying. Under a FINITE staleness bound (BSP/SSP) every
  ``tick()`` drains the queue to the EMIT barrier before the clock
  frame goes out — all step-``k`` push frames precede the clock-``k``
  frame on the same ordered per-link stream, so the FIFO staleness
  argument above holds unchanged (bound preserved at send cost, no
  per-step ack round trip). Under ASP (``staleness=inf``) admission
  always passes — there is no bound for a drain to protect — so the
  clock frame goes out without waiting and the sender drains behind
  the next step's compute. Acks are pure loss detection and cost
  ~zero frames in steady state: owners BATCH ack seqs and piggyback
  them on their next pull reply to the pusher (one per PS cycle),
  with dedicated psK frames only on the batch threshold, clock events
  (``serve_parked``), or a drain's psQ solicitation. ``push_window``
  bounds both the unacked-frame window and the unsent queue depth
  (backpressure), and ``finalize()`` runs the HARD drain — queue
  empty AND every ack in, soliciting stragglers. A lost ack cannot
  hang the loop: a jammed window or drain deadline poisons the table
  and ``check_fatal()`` raises at the next tick.
- **pull prefetch** (``prefetch_pull(keys)``): issue batch ``t+1``'s
  pull while batch ``t`` computes. The request is stamped with a FUTURE
  clock (``clock_ahead``, default 1 — the clock the consuming step will
  run at), so the owner parks it under exactly the admission rule a
  synchronous pull at that step would face; the reply rides back while
  the worker computes/pushes/ticks, and ``wait()`` (or a later
  ``pull()`` with the same keys, which consumes the registered
  prefetch) picks it up, re-checking LOCAL admission before reading the
  local shard slice.
- **int8 pull wire** (``pull_wire="int8"``): pull replies ship per-row
  absmax int8 codes + f32 scales (round-to-nearest — deterministic, so
  identical bytes decode identically everywhere) instead of raw f32
  rows, mirroring the push codec in ops/quantized_comm.py. Frames
  self-describe their wire (mixed fleets decode per frame), and workers
  echo the negotiated format so the bench can assert it.

The DEDUPLICATED PULL WIRE + CLOCK-VERSIONED ROW CACHE (the
reference ``KVClientTable``'s process-level parameter
cache, rebuilt with the SSP rule as its validity predicate):

- ``pull()`` requests ship UNIQUE keys only (``np.unique`` client-side,
  scatter by ``return_inverse`` on reply) — a zipfian batch no longer
  pays full row traffic per occurrence of the same hot row. The owner
  is oblivious: it serves whatever keys arrive. ``pull_dedup=False``
  restores the verbatim wire (the bench's A/B lever; refused when the
  cache is on).
- ``cache_bytes > 0`` enables the worker-side row cache: every pull
  reply is STAMPED by its owner with ``min_excluding(requester)`` — the
  owner's view of every OTHER worker's applied clock (its own
  included; the requester's excluded because per-link FIFO already
  certifies its pushes, see comm/bus.py). A later pull at clock ``c``
  is served from cache for rows whose stamp satisfies
  ``consistency.gate.admits(stamp, c, s)`` — the EXACT owner-side
  admission predicate — so a hit is provably no staler than a
  synchronous pull admitted under the same min-view. Misses (and only
  misses) go to the wire, deduplicated. Local pushes WRITE THROUGH the
  cached rows they touch (sgd + float32 push wire: the delta is exact
  and additive, bitwise the server's op) or INVALIDATE them (stateful
  updaters / quantized pushes: the client cannot reproduce the
  server's step), so read-your-own-writes holds either way.
  ``tick()`` ages out rows that can never be admitted again, an LRU
  byte bound evicts beyond ``cache_bytes``, ``finalize()`` clears (the
  post-finalize agreement guarantee is exact, not staleness-bounded),
  and prefetches populate/consult the same cache under the same stamp
  rule (a fully-cached prefetch never touches the wire).

Per-leg timing (issue→reply latency, blocked time, overlap fraction,
ack latency) runs through ``utils/timing.CommTimers`` — which now also
carries rows-requested vs rows-over-wire and cache hit/lookup counts
into the done lines; wire bytes both directions count ACTUAL bytes on
the wire (compressed when compressed).

WIRE LOSS: everything above assumes frames arrive, and one
dropped frame anywhere — a pull reply, a push ack, a clock broadcast —
used to cost a deadline poison or a gate stall misread as death. With
``MINIPS_RELIABLE=1`` the bus installs the retransmission protocol
(comm/reliable.py): per-link send journals, receiver gap detection
soliciting NACK/retransmit with backoff under a retry budget, and
deliver-once in-order sequencing — so a lost pull reply or push ack
retransmits (milliseconds) long before the deadline poison fires, a
duplicated/retransmitted push frame is never applied twice (the summed
rows land exactly once — the row cache's write-through depends on it),
and clock gossip stays monotone (ClockGossip max-merges besides). Retry
exhaustion and heartbeat-confirmed death still poison through every
path below, unchanged: loss degrades to latency, never to silence.
Drills are seeded + deterministic via ``MINIPS_CHAOS`` (comm/chaos.py);
the whole ladder: docs/fault_tolerance.md.

HEAT-AWARE SHARD REBALANCING: the static range partition
above puts a zipf head's whole hot range on ONE owner — that shard
becomes the system's straggler, and nothing here could fix it short of
relaunching. With ``MINIPS_REBALANCE`` set (off by default):

- every owner keeps decayed per-key-block heat on its serve path
  (balance/heat.py) plus always-on per-owner request/row serve
  counters (in ``wire_record``/done lines even with the rebalancer
  off — imbalance is observable before it is fixed);
- the coordinator (rank 0) collects heat, bin-packs hot blocks away
  from the hottest shard past a hysteresis threshold
  (balance/rebalancer.py), and broadcasts the new block→owner overlay
  stamped with the next ROUTING EPOCH;
- each rank adopts the table at its own clock boundary (``tick``) —
  the epoch-fenced migration: the old owner snapshots the block's
  rows AND optimizer state under its state lock, ships them (``rbS``),
  and afterwards FORWARDS stale-routed pushes to the current owner;
  stale-routed pulls are REFUSED with the new table (``psE``) and the
  client retries the leg against the right owner; frames stamped with
  a FUTURE epoch park until the local table catches up;
- the SSP bound holds across the move: the new owner serves NO pull
  of a migrated block until the fence releases (``rbF``), and the
  fence releases only after every live rank's adoption ack (``rbA``)
  arrived at the old owner — each rbA rides the same per-link stream
  as that rank's pushes, so every stale push precedes it, and the rbF
  rides the old→new link AFTER every forwarded push. A pull admitted
  mid-migration therefore still reads state containing every peer's
  updates up to ``clk − s`` (property-tested in
  tests/test_rebalance.py), and read-your-own-writes survives the
  two-hop window for the same per-link-FIFO reason.

Checkpoints record the routing epoch + overlay + migrated block state
so a restored fleet agrees with itself; protocol walkthrough:
docs/architecture.md "Heat-aware shard rebalancer".

THE READ-MOSTLY SERVING PLANE (``minips_tpu_torch/serve/``): all of
the above measures a fixed training gang; the north star serves
parameter reads at user scale, where the workload is MANY read-only
clients against few pushers and a hot key range saturates one owner's
receive thread. With ``MINIPS_SERVE`` set (off by default):

- owners promote their hottest blocks (the same heat accounting the
  rebalancer reads) to REPLICA ranks — a full-block snapshot grant,
  then stamped delta frames each refresh interval carrying only the
  rows pushes dirtied (rows ride the configured pull wire, int8 when
  configured);
- every grant/delta is stamped with the owner's gossip ``global_min``
  read BEFORE the state read, and a replica serves a pull at requester
  clock ``c`` only when ``admits(stamp, c, s)`` — the same predicate
  the owner-side park and the row cache run — so a replica hit is
  provably no staler than an owner pull (the owner stamp
  ``min_excluding(requester)`` is ≥ this one) and the RowCache ingests
  replica replies unchanged;
- replica grants are LEASES: owners revoke them at the ``adopt_table``
  epoch-fence point when a granted block migrates away, and expiry
  (renewed by every refresh) turns a mute owner's replicas dark; a
  replica that cannot serve refuses (``svN``) and the client re-issues
  the leg against the owner — serving composes with online migration
  instead of fighting it;
- per-owner token-bucket ADMISSION on the wire pull path sheds
  overload to replicas (``svS`` redirect) or refuses with explicit
  backpressure (``svB`` + delayed retry); retried legs are
  force-admitted, so every path is bounded and nothing times out to
  a silent poison;
- clients fan hot-block pull legs across ``{owner} ∪ holders``
  round-robin, which is what converts replication into read
  throughput (the ``pull_storm`` bench arm's lever).

Protocol, knobs, and the staleness argument: docs/serving.md.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from minips_tpu_torch.comm.bus import ClockGossip
from minips_tpu_torch.consistency.gate import (RETIRED_CLOCK, PeerFailureError,
                                         StalenessGate, admits)
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc
from minips_tpu_torch.obs import window as _ow
from minips_tpu_torch.obs.hist import Log2Histogram, merge_counts, \
    summarize_counts
from minips_tpu_torch.ops.quantized_comm import (HOST_BLOCK,
                                           blockwise_stream_bytes,
                                           decode_key_deltas,
                                           delta_stream_bytes,
                                           dequantize_blockwise,
                                           dequantize_rows_int8,
                                           encode_key_deltas,
                                           quantize_blockwise,
                                           quantize_rows_int8, topk_rows)
from minips_tpu_torch.parallel.partition import BlockRouter, RangePartitioner
from minips_tpu_torch.utils.timing import CommTimers

__all__ = ["ShardedTable", "ShardedPSTrainer", "PeerFailureError",
           "PullFuture", "RowCache", "ResidualStore", "table_state_bytes",
           "tables_hist_stats", "quantize_rows_int8",
           "dequantize_rows_int8", "sum_duplicate_keys"]

VALID_PUSH_COMM = ("float32", "int8", "topk8", "topk4")


def _as_blob(arr: np.ndarray) -> memoryview:
    """Zero-copy byte view of an array for the bus's blob slot — every
    backend accepts bytes-likes (the framing ships blobs as raw
    views), so the ``tobytes()`` this replaces was a full payload copy
    per frame on the hot path. ONLY sound for arrays this process owns
    and never mutates after the send (fresh fancy-index/copy results):
    the reliable journal and the chaos injector retain the blob past
    the call, so an aliased caller buffer would retransmit whatever the
    caller wrote next."""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def _cat_blob(*parts) -> bytearray:
    """Single-allocation multi-part blob assembly: each part (array or
    bytes-like) is copied ONCE into the result — vs the seed pattern
    ``a.tobytes() + b.tobytes()`` which paid one copy per part plus the
    concatenation. The bytearray is freshly owned, so journal retention
    is alias-safe."""
    views = [memoryview(np.ascontiguousarray(p)).cast("B")
             if isinstance(p, np.ndarray) else memoryview(p)
             for p in parts]
    out = bytearray(sum(v.nbytes for v in views))
    off = 0
    for v in views:
        out[off:off + v.nbytes] = v
        off += v.nbytes
    return out


def sum_duplicate_keys(keys: np.ndarray, grads: np.ndarray,
                       dim: int) -> tuple[np.ndarray, np.ndarray, bool]:
    """THE client-side duplicate-key coalesce kernel: sum each key's
    occurrences via per-dim f64 bincount, rounded ONCE to f32 — at
    least as accurate as a sequential f32 sum, ~3x faster than
    np.add.at on the hot path. Shared by the wire plane's
    ``_coalesce_for_wire`` and the mesh plane's deposit
    (train/mesh_plane.py) deliberately: the BSP bitwise-parity drill
    depends on both planes summing duplicates identically, so the
    kernel exists exactly once. Returns ``(uniq, summed, had_dups)``
    — the ORIGINAL pairing when there is nothing to coalesce (uniq
    would be sorted; re-pairing grads against it scrambles rows)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    if uniq.size == keys.size:
        return keys, grads, False
    summed = np.empty((uniq.size, dim), np.float32)
    for d in range(dim):
        summed[:, d] = np.bincount(inv, weights=grads[:, d],
                                   minlength=uniq.size)
    return uniq, summed, True


class RowCache:
    """Clock-versioned LRU cache of REMOTE rows — the reference
    KVClientTable's process-level parameter cache, with the SSP rule as
    its validity predicate instead of a freshness heuristic.

    Storage is a SLAB: one preallocated ``[cap_rows, dim]`` f32 buffer
    plus a parallel stamp vector, with an insertion-ordered ``key →
    slot`` map for LRU. Every float op (gather on lookup, scatter on
    insert, the write-through add) is a single vectorized numpy call —
    a per-key Python loop here costs more than the loopback wire it
    saves, which is exactly the per-row-overhead failure mode the
    motivation cites. Python-level work per op is one cheap
    ``dict.get`` pass over the keys.

    ``stamp`` is the freshness certificate the owning shard put on the
    pull reply that delivered the row (its min-view over every other
    worker's applied clock at serve time). ``lookup`` at clock ``c``
    under staleness ``s`` serves exactly the rows
    ``consistency.gate.admits`` would admit — the one predicate the
    owner-side park uses — so a hit can never read past the staleness
    bound a synchronous pull enforces.

    The byte bound counts row payload (``4*dim`` per entry, the slab's
    real allocation); eviction is LRU — hits and re-inserts refresh
    recency. Thread-safe: pushes from the training thread race replies
    consumed in ``wait()``.
    """

    def __init__(self, dim: int, cache_bytes: int):
        self.dim = int(dim)
        self.row_bytes = 4 * self.dim
        self.cap = int(cache_bytes)
        self.cap_rows = max(int(cache_bytes) // self.row_bytes, 1)
        self._buf = np.empty((self.cap_rows, self.dim), np.float32)
        self._stamp = np.zeros(self.cap_rows, np.int64)
        self._slot: OrderedDict[int, int] = OrderedDict()  # key -> slot
        self._free: list[int] = list(range(self.cap_rows - 1, -1, -1))
        self._lock = threading.Lock()
        self.hits = 0
        self.lookups = 0
        self.evictions = 0
        self.invalidations = 0
        self.write_throughs = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._slot)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return len(self._slot) * self.row_bytes

    def lookup(self, keys: np.ndarray, clk: int,
               staleness: float) -> tuple[np.ndarray, np.ndarray]:
        """Serve what the admission rule allows: returns
        ``(rows [n, dim], miss bool [n])`` — ``rows[i]`` is valid where
        ``miss[i]`` is False, i.e. the cached stamp admits clock
        ``clk`` under ``staleness``."""
        with self._lock:
            self.lookups += keys.size
            get = self._slot.get
            slots = np.fromiter((get(k, -1) for k in keys.tolist()),
                                np.int64, count=keys.size)
            held = slots >= 0
            hit = held.copy()
            if staleness != float("inf"):
                # vectorized admits(): stamp >= clk - s, slot-wise
                hit[held] = (self._stamp[slots[held]]
                             >= clk - int(staleness))
            out = np.empty((keys.size, self.dim), np.float32)
            hs = slots[hit]
            out[hit] = self._buf[hs]          # one gather, no row loop
            for k in keys[hit].tolist():      # LRU refresh: dict ops only
                self._slot.move_to_end(k)
            self.hits += int(hit.sum())
        return out, ~hit

    def _take_slot_locked(self, key: int) -> int:
        slot = self._slot.get(key)
        if slot is not None:
            self._slot.move_to_end(key)
            return slot
        if not self._free:  # full: evict the LRU entry, reuse its slot
            _, slot = self._slot.popitem(last=False)
            self.evictions += 1
        else:
            slot = self._free.pop()
        self._slot[key] = slot
        return slot

    def insert(self, keys: np.ndarray, rows: np.ndarray,
               stamp: int) -> None:
        """Fill from a pull reply stamped ``stamp`` by its owner; evicts
        LRU entries beyond the byte bound (slab capacity)."""
        with self._lock:
            slots = np.fromiter(
                (self._take_slot_locked(k) for k in keys.tolist()),
                np.int64, count=keys.size)
            self._buf[slots] = rows           # one scatter
            self._stamp[slots] = stamp

    def write_through(self, keys: np.ndarray, deltas: np.ndarray) -> None:
        """Apply ``row += delta`` to cached rows (missing keys are
        no-ops). Only sound when the delta is exactly what the server
        applies (sgd over a float32 push wire): additivity keeps the
        entry equal to 'stamped state + my subsequent updates', a legal
        read wherever the stamp is."""
        with self._lock:
            get = self._slot.get
            slots = np.fromiter((get(k, -1) for k in keys.tolist()),
                                np.int64, count=keys.size)
            held = slots >= 0
            # keys are unique (push dedup upstream): plain indexed add
            self._buf[slots[held]] += deltas[held]
            self.write_throughs += int(held.sum())

    def invalidate(self, keys: np.ndarray) -> None:
        """Drop cached rows a push touched — read-your-own-writes when
        the client cannot reproduce the server's update."""
        with self._lock:
            for k in keys.tolist():
                slot = self._slot.pop(k, None)
                if slot is not None:
                    self._free.append(slot)
                    self.invalidations += 1

    def age(self, clk: int, staleness: float) -> None:
        """Drop rows that can never be admitted again — clocks only
        advance, so ``not admits(stamp, clk, s)`` is terminal. Called
        from ``tick()``; keeps BSP's cache near-empty instead of
        carrying a table of dead stamps to the LRU bound."""
        if staleness == float("inf"):
            return
        with self._lock:
            dead = [k for k, s in self._slot.items()
                    if self._stamp[s] < clk - int(staleness)]
            for k in dead:
                self._free.append(self._slot.pop(k))

    def clear(self) -> None:
        with self._lock:
            self._slot.clear()
            self._free = list(range(self.cap_rows - 1, -1, -1))

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "lookups": self.lookups,
                "hit_rate": (round(self.hits / self.lookups, 4)
                             if self.lookups else None),
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "write_throughs": self.write_throughs,
                "rows": len(self._slot),
                "bytes": len(self._slot) * self.row_bytes,
            }


class ResidualStore:
    """Error-feedback residuals for the compressed push wire (the
    SparCML rule: what the codec did not send is KEPT, not dropped).

    Every ``topk8``/``topk4`` push retains two kinds of unsent mass per
    key: the full gradient row of every row the top-k selection left
    out, and the quantization error ``g - decode(encode(g))`` of every
    row it shipped. The NEXT push touching the same key FOLDS the
    residual into its gradient before selection, so hot rows
    self-repair within a step; cold rows are bounded by the staleness
    accounting instead — every entry carries a BIRTH clock (the oldest
    clock whose mass it holds; folding preserves the minimum, so age
    can never reset by re-touching), and the trainer's clock boundary
    flushes entries older than the staleness bound ``s`` as plain f32
    pushes — the RowCache stamp rule run in reverse: a cached read may
    be up to ``s`` behind, and symmetrically a withheld write may trail
    at most ``s`` clock boundaries before it is forced onto the wire.
    Epoch fences (rebalance adoption, membership transitions) and
    ``finalize()`` flush the WHOLE store, so migration, drains, and the
    exact post-finalize agreement never strand mass.

    Storage is a slab like the RowCache: a preallocated ``[cap, dim]``
    f32 buffer + parallel birth/key vectors with a dict for key lookup
    — all float work vectorized. A full slab cannot drop mass: retain
    overflow is returned to the caller, which ships it dense
    immediately (counted; the byte win shrinks, correctness does not).
    Thread-safe: the async-push sender thread retains while the
    training thread age-flushes at the boundary."""

    INF = np.iinfo(np.int64).max

    def __init__(self, dim: int, cap_bytes: int = 1 << 24):
        self.dim = int(dim)
        # byte-bounded, with a row-count ceiling: the parallel birth /
        # key vectors cost 16 B/row whatever the dim, so a dim-1 table
        # must not turn the 16 MiB byte budget into 4M preallocated
        # slots (overflow past the cap ships dense — graceful, counted)
        self.cap_rows = min(max(int(cap_bytes) // (4 * self.dim), 1024),
                            1 << 18)
        self._buf = np.zeros((self.cap_rows, self.dim), np.float32)
        self._birth = np.zeros(self.cap_rows, np.int64)
        self._key = np.full(self.cap_rows, -1, np.int64)
        self._slot: dict[int, int] = {}
        self._free: list[int] = list(range(self.cap_rows - 1, -1, -1))
        self._lock = threading.Lock()
        self.folded_rows = 0
        self.retained_rows = 0
        self.flushed_age = 0
        self.flushed_fence = 0
        self.flushed_overflow = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._slot)

    def fold(self, keys: np.ndarray, grads: np.ndarray) -> np.ndarray:
        """Add stored residuals into ``grads`` (in place) for every key
        present, release those entries, and return each key's former
        birth clock (``INF`` where nothing was stored) — the caller
        re-retains unsent mass under ``min(birth, current clock)`` so
        residual age survives the fold."""
        births = np.full(keys.size, self.INF, np.int64)
        with self._lock:
            if not self._slot:
                return births
            get = self._slot.get
            slots = np.fromiter((get(k, -1) for k in keys.tolist()),
                                np.int64, count=keys.size)
            held = slots >= 0
            if not held.any():
                return births
            hs = slots[held]
            grads[held] += self._buf[hs]
            births[held] = self._birth[hs]
            self._key[hs] = -1
            for k in keys[held].tolist():
                self._free.append(self._slot.pop(k))
            self.folded_rows += int(held.sum())
        return births

    def retain(self, keys: np.ndarray, rows: np.ndarray,
               births: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Store unsent mass (all-zero rows are skipped — nothing to
        repay). Returns the ``(keys, rows)`` OVERFLOW the slab had no
        room for; the caller must ship it dense — mass is conserved
        whatever the slab pressure."""
        live = rows.any(axis=1)
        if not live.all():
            keys, rows, births = keys[live], rows[live], births[live]
        if not keys.size:
            return keys, rows
        ov_from = keys.size
        with self._lock:
            get = self._slot.get
            for i, k in enumerate(keys.tolist()):
                slot = get(k)
                if slot is not None:  # belt-and-braces: fold removed it
                    self._buf[slot] += rows[i]
                    self._birth[slot] = min(self._birth[slot],
                                            int(births[i]))
                    continue
                if not self._free:
                    ov_from = i
                    break
                slot = self._free.pop()
                self._slot[k] = slot
                self._key[slot] = k
                self._buf[slot] = rows[i]
                self._birth[slot] = int(births[i])
            stored = min(ov_from, keys.size)
            self.retained_rows += stored
            if ov_from < keys.size:
                self.flushed_overflow += keys.size - ov_from
        return keys[ov_from:], rows[ov_from:]

    def take(self, up_to_birth: Optional[int] = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Pop every entry with ``birth <= up_to_birth`` (None = all),
        sorted by key (deterministic flush frames)."""
        with self._lock:
            used = self._key >= 0
            if up_to_birth is not None:
                used &= self._birth <= up_to_birth
            slots = np.nonzero(used)[0]
            if not slots.size:
                return (np.empty(0, np.int64),
                        np.empty((0, self.dim), np.float32))
            keys = self._key[slots].copy()
            rows = self._buf[slots].copy()
            self._key[slots] = -1
            for k in keys.tolist():
                self._free.append(self._slot.pop(k))
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order]

    def note_flushed(self, n: int, reason: str) -> None:
        with self._lock:
            if reason == "age":
                self.flushed_age += n
            else:
                self.flushed_fence += n

    def stats(self) -> dict:
        with self._lock:
            return {
                "folded_rows": self.folded_rows,
                "retained_rows": self.retained_rows,
                "flushed_age": self.flushed_age,
                "flushed_fence": self.flushed_fence,
                "flushed_overflow": self.flushed_overflow,
                "resident_rows": len(self._slot),
                "resident_bytes": len(self._slot) * 4 * self.dim,
            }


def table_state_bytes(num_rows: int, dim: int, updater: str) -> int:
    """Whole-table bytes of weights + optimizer state for one table — the
    accounting twin of ``ShardedTable.local_bytes`` summed over all shards
    (modulo partition padding). The apps' smoke protocol compares
    ``local_bytes * N <= table_bytes`` against this ONE formula so a state-
    layout change can't leave stale copies behind."""
    mult = {"sgd": 1, "adagrad": 2, "adam": 3}[updater]
    n = num_rows * dim * 4 * mult
    if updater == "adam":  # per-row lazy step counters (int32)
        n += num_rows * 4
    return n


class _ReissuePullAll(Exception):
    """A shard-assembly (psA) leg was addressed to a now-dead rank and
    the death plan has re-homed its blocks: the whole pull_all must
    re-issue at the new epoch (a psA leg asks one rank for ITS shard —
    there is no per-leg re-route that can recover the corpse's half).
    Internal to this module: pull_all catches it and retries."""


class PullFuture:
    """Handle for an in-flight (possibly prefetched) pull: the requests
    are already on the wire (unique MISS keys only — dupes scatter by
    inverse, cache hits were filled at issue time); ``wait()`` blocks
    only for whatever has not yet arrived, reads the LOCAL shard slice
    after re-checking admission for the stamped clock, assembles the
    unique-row matrix, inserts fetched rows into the row cache with
    their owner stamps, and scatters back to request order.
    Single-consumer: ``wait()`` may be called once."""

    def __init__(self, table: "ShardedTable", req: int, keys: np.ndarray,
                 uniq: np.ndarray, inv: Optional[np.ndarray],
                 out_u: np.ndarray, remote: list, local_idx, clk: int):
        self._table = table
        self._req = req
        self._keys = keys
        self._uniq = uniq              # unique keys (== keys if no dedup)
        self._inv = inv                # scatter map uniq -> keys order
        self._out_u = out_u            # [uniq.size, dim]; hits pre-filled
        self._remote = remote          # [(owner, idx-into-uniq)] wire legs
        self._local_idx = local_idx    # idx-into-uniq my shard owns
        self.clk = clk
        self._t_issue = time.monotonic()
        self._done = False
        self._pf_key: Optional[bytes] = None  # prefetch-registry slot
        self._issue_epoch = 0  # cache push-log position at issue time

    def _deregister(self) -> None:
        if self._pf_key is None:
            return
        t = self._table
        with t._prefetch_lock:
            if t._prefetched.get(self._pf_key) is self:
                del t._prefetched[self._pf_key]

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._done:
            raise RuntimeError("PullFuture.wait() called twice")
        self._done = True
        self._deregister()
        t = self._table
        t_block0 = time.monotonic()
        out_u = self._out_u
        extra_local: list = []
        try:
            if self._remote:
                got = t._await_replies(self._req, timeout=timeout)
                # the FINAL leg map: the psE re-router may have re-split
                # legs (and turned some local) since issue
                legs, extra_local = t._take_group(self._req)
                for rid, (o, idx) in legs.items():
                    rows, stamp = got[rid][0], got[rid][1]
                    out_u[idx] = rows
                    if t._sv is not None:
                        # the SERVE-STALE observable: every consumed
                        # reply (owner- OR replica-served) must satisfy
                        # the admission rule its serve claimed
                        t._sv.check_reply_stamp(int(stamp), self.clk)
                    if t._cache is not None:
                        # the prefetch path populates the same cache
                        # under the same stamp rule — this is the one
                        # fill point; keys pushed since issue are
                        # DROPPED from the insert (the reply may sit on
                        # either side of the push — read-your-own-
                        # writes over the in-flight window, see
                        # _cache_insert_guarded)
                        t._cache_insert_guarded(self, self._uniq[idx],
                                                rows, stamp)
            else:
                with t._reply_cond:
                    t._replies.pop(self._req, None)
        finally:
            # even on timeout/peer-failure: a leaked registration would
            # pin the push-journal floor forever and churn the cache
            # through the overflow valve on every later push
            if t._cache is not None:
                t._cache_close_issue(self)
        with t._reply_cond:
            t_arrived = t._reply_t.pop(self._req, t_block0)
        local_parts = ([self._local_idx]
                       if self._local_idx is not None else [])
        local_parts += [ix for ix in extra_local if ix.size]
        if local_parts:
            # the local slice obeys the SAME admission rule the remote
            # owners applied: read only once my view admits the stamped
            # clock (matters for prefetches stamped clock_ahead > 0 —
            # a synchronous pull passes instantly, its own gate already
            # waited for this); _read_local additionally honors the
            # migration fences a remote owner would have parked under
            t._wait_local_admission(self.clk, timeout)
            idxs = (local_parts[0] if len(local_parts) == 1
                    else np.concatenate(local_parts))
            out_u[idxs] = t._read_local(self._uniq[idxs], self.clk,
                                        timeout)
        now = time.monotonic()
        # latency is issue -> reply PROCESSED (t_arrived), not wait() —
        # a fully-prefetched pull whose reply landed mid-compute must
        # report the real RTT, not the compute window it hid under
        t.timers.record_pull(latency_s=t_arrived - self._t_issue,
                             blocked_s=now - t_block0)
        tr = _trc.TRACER
        if tr is not None and self._remote:
            tr.complete("pull", "pull_wait", t_block0,
                        {"owners": sorted({int(o)
                                           for o, _i in self._remote}),
                         "clk": self.clk}, t1=now)
        return out_u[self._inv] if self._inv is not None else out_u

    def cancel(self) -> None:
        """Abandon an un-waited prefetch (e.g. past the last batch):
        releases the reply slot so late replies don't accumulate."""
        if self._done:
            return
        self._done = True
        self._deregister()
        if self._table._cache is not None:
            self._table._cache_close_issue(self)
        with self._table._reply_cond:
            self._table._cleanup_group_locked(self._req)


class ShardedTable:
    """One table: my server shard (owned contiguous row range) + the client
    router splitting pulls/pushes by owner (reference KVClientTable +
    ServerThread + RangeManager collapsed into one object per process).

    ``dim=1`` rows model the reference's dense ``VectorStorage`` (each key a
    scalar parameter); larger ``dim`` is the embedding-table case
    (``MapStorage`` → fixed rows). Dense whole-vector traffic uses the
    range fast path (``pull_all``/``push_range``) with no key lists on the
    wire.
    """

    def __init__(
        self,
        name: str,
        num_rows: int,
        dim: int,
        bus,
        rank: int,
        num_processes: int,
        *,
        updater: str = "sgd",
        lr: float = 0.05,
        adagrad_init: float = 0.1,
        eps: Optional[float] = None,
        beta1: float = 0.9,
        beta2: float = 0.999,
        init_scale: float = 0.0,
        seed: int = 0,
        pull_timeout: float = 30.0,
        monitor=None,
        push_comm: Optional[str] = None,
        pull_wire: str = "f32",
        async_push: bool = False,
        push_window: int = 32,
        cache_bytes: int = 0,
        pull_dedup: bool = True,
        push_dedup: bool = True,
        topk_mass: float = 0.9,
        topk_cap: float = 0.5,
        topk_block: int = HOST_BLOCK,
    ):
        if updater not in ("sgd", "adagrad", "adam"):
            raise ValueError(
                "sharded-PS updater must be 'sgd', 'adagrad' or 'adam'")
        if push_comm is None:
            # the env spelling of the wire ladder (explicit-empty =
            # default, every MINIPS_* knob's convention); an explicit
            # constructor/flag value always wins — the bench pins ""
            # so an armed environment can't leak into baseline arms
            push_comm = os.environ.get("MINIPS_PUSH_COMM",
                                       "").strip() or "float32"
        if push_comm not in VALID_PUSH_COMM:
            raise ValueError(
                f"push_comm must be one of {VALID_PUSH_COMM}")
        if pull_wire == "float32":  # accept the push-knob spelling too
            pull_wire = "f32"
        if pull_wire not in ("f32", "int8"):
            raise ValueError("pull_wire must be 'f32' or 'int8'")
        if push_window < 1:
            raise ValueError("push_window must be >= 1")
        if cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0 (0 = cache off)")
        if cache_bytes and not pull_dedup:
            # a cache keyed on unique rows over a duplicate wire would
            # double-count hits and mis-stamp scattered fills
            raise ValueError("cache_bytes > 0 requires pull_dedup=True")
        if push_comm in ("topk8", "topk4") and not push_dedup:
            # error feedback is keyed per unique row: a per-occurrence
            # wire would fold one key's residual into whichever
            # occurrence happened first — dedup is the codec's contract
            raise ValueError(
                f"push_comm={push_comm!r} requires push_dedup=True "
                "(error-feedback residuals are keyed per unique row)")
        if not 0.0 < topk_mass <= 1.0:
            raise ValueError("topk_mass must be in (0, 1]")
        if not 0.0 < topk_cap <= 1.0:
            raise ValueError("topk_cap must be in (0, 1]")
        if topk_block < 1:
            raise ValueError("topk_block must be >= 1")
        self.name = name
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.bus = bus
        self.rank = rank
        self.num_processes = num_processes
        self.updater = updater
        self.lr = lr
        # defaults match the jax oracles (ops/sparse_update.py): adagrad
        # divides by sqrt(accum)+1e-10, adam by sqrt(v_hat)+1e-8
        self.eps = (1e-8 if updater == "adam" else 1e-10) \
            if eps is None else eps
        self.beta1 = beta1
        self.beta2 = beta2
        self.pull_timeout = pull_timeout
        self.monitor = monitor
        self.push_comm = push_comm
        self.topk_mass = float(topk_mass)
        self.topk_cap = float(topk_cap)
        self.topk_block = int(topk_block)
        # the error-feedback residual store (module class docstring):
        # only the compressed-push tiers carry unsent mass to repay
        self._ef = (ResidualStore(dim)
                    if push_comm in ("topk8", "topk4") else None)
        self.pull_wire = pull_wire
        self.async_push = bool(async_push)
        self.push_window = int(push_window)
        self.pull_dedup = bool(pull_dedup)
        self.push_dedup = bool(push_dedup)
        self.cache_bytes = int(cache_bytes)
        # the clock-versioned client row cache (module docstring): holds
        # REMOTE rows only — my own shard is always read directly
        self._cache = RowCache(dim, cache_bytes) if cache_bytes else None
        # read-your-own-writes for IN-FLIGHT pulls: a reply served
        # before my push reached the owner would be inserted into the
        # cache AFTER push() ran its write-through/invalidation — a
        # no-op for the not-yet-cached row — storing a pre-own-push row
        # every later hit would silently serve. And the converse is
        # just as possible: a PARKED pull is served after the push
        # applied, so the reply already contains the delta — the client
        # cannot tell which side of the push the serve landed on. So
        # pushes are journaled in a LOG while pulls are outstanding,
        # and an insert DROPS the keys any entry newer than its pull's
        # issue point touched: ambiguous rows are simply not cached
        # (the future's RESULT is untouched; the next pull of such a
        # key round-trips once). Single-writer in practice (all ops on
        # the training thread); the lock is belt-and-braces.
        self._cache_epoch = 0           # cache-maintenance ops so far
        self._cache_log: list[tuple] = []     # (epoch, sorted keys)
        self._cache_open: dict[int, int] = {}  # id(fut) -> issue epoch
        self._cache_broken_floor = -1   # valve: pre-floor issues skip
        self._cache_log_lock = threading.Lock()
        if self._cache is not None and self.async_push:
            # an async push frame can reach the owner AFTER a
            # later-issued pull was served, with no client-side event
            # marking the window — read-your-own-writes would need the
            # ack plumbing to certify arrival. Refuse loudly; the
            # cache composes with the prefetch leg (--overlap-legs
            # pull), which is the overlap lever that pays anyway.
            raise ValueError(
                "cache_bytes > 0 is not supported with async_push "
                "(use overlap_legs='pull'): an unacked push frame can "
                "trail a later pull, and a cached reply could then "
                "silently miss this worker's own update")
        self.timers = CommTimers()
        # quantization noise stream: per-(seed, rank) so reruns are
        # deterministic and ranks draw independent rounding noise
        self._q_rng = np.random.default_rng((seed, rank, 0x9e37))
        self._seed = int(seed)  # hier leader lane derives its own rng
        self.part = RangePartitioner(self.num_rows, num_processes)
        self.shard_lo = rank * self.part.shard_size
        # ---- heat-aware rebalancing (balance/; OFF unless a Rebalancer
        # attaches): the epoch-versioned block router overlays hot-block
        # reassignments on the base range map. With no rebalancer bound
        # every path below falls through to the seed behavior exactly.
        self.router = BlockRouter(self.part)
        self._rb = None            # balance.rebalancer.Rebalancer
        self._mb = None            # balance.membership.Membership
        self._heat = None          # balance.heat.HeatAccountant
        self._sv = None            # serve.plane.TableServeState
        self._mig_cond = threading.Condition()  # guards the maps below
        self._xtra: dict[int, dict] = {}        # migrated-in block state
        # fenced/pending carry the COUNTERPART rank (the old owner whose
        # rbF releases the fence / whose rbS is in transit): the elastic
        # membership plane resolves entries stuck on a corpse by source
        # instead of guessing
        self._fenced: dict[int, int] = {}        # block -> old owner
        self._pending_state: dict[int, int] = {}  # block -> shipper
        self._early_state: dict[int, dict] = {}  # rbS beat my adoption
        self._early_release: set[tuple] = set()  # rbF beat my adoption
        self._parked_pushes: list[tuple] = []    # future-epoch / pending
        self._adopt_acks: dict[int, set[int]] = {}  # ep -> acked ranks
        self._await_acks: dict[int, list] = {}   # ep -> [(block, dst)]
        # rbF releases awaiting the gainer's rbG confirmation:
        # (block, dst) -> (epoch, last-send monotonic). Fire-and-forget
        # releases are fine for a STAYING old owner (the reliable plane
        # retransmits for live senders), but a LEAVER whose last rbF is
        # eaten by a partition would strand the gainer's fence forever —
        # leave() re-sends until this map drains (releases_confirmed)
        self._release_unacked: dict[tuple[int, int], tuple] = {}
        self.rb_stats = {"blocks_in": 0, "blocks_out": 0,
                         "forwarded_pushes": 0, "refused_pulls": 0,
                         "parked_frames": 0, "migrated_rows": 0,
                         "blocks_restored": 0, "pushes_lost_to_dead": 0,
                         # max bytes of outbound state staged at once on
                         # the ship path — measured on BOTH the planned
                         # and the point-to-point path, it is the
                         # RESHARD-MEM observable (the p2p arm's proof
                         # that whole-plan staging exceeds the cap)
                         "peak_stage_bytes": 0}
        # ---- planned collective redistribution (balance/redistribute;
        # OFF unless attach_reshard): slice-granular migration shipping
        # in cap-bounded rounds. Inbound slice progress rides NEXT TO
        # _pending_state (block granularity is still the fence unit);
        # _early_prog mirrors _early_state for slices that beat my plan
        # adoption.
        self._reshard = None       # balance.redistribute.ReshardConfig
        self._slice_prog: dict[int, dict] = {}  # block -> {got, seen}
        self._early_prog: dict[int, dict] = {}  # pre-adoption twin
        self.rs_stats = {"plans": 0, "rounds": 0, "slices": 0,
                         "dup_slices": 0, "aborts": 0,
                         "peak_stage_bytes": 0}
        # ---- per-owner serve counters (ALWAYS on — the observability
        # half of heat accounting): requests/rows this shard served
        # (wire) and rows read/applied on this shard's storage (wire +
        # local) — utils/metrics.wire_record "serve", done lines
        self._serve_lock = threading.Lock()
        self.serve = {"pull_requests": 0, "pull_rows": 0,
                      "push_frames": 0, "push_rows": 0}
        # ---- tenancy (tenant/registry.py; OFF unless the trainer
        # binds a TenantRegistry): this table's tenant spec and its
        # 1-based tenant id — stamped on every frame head ("tb", next
        # to ws/nr/dm/rb) — plus the per-tenant SLO counters the serve
        # plane's deny paths bump when tenancy is armed. tid 0 = off:
        # no stamp, no counters (the armed-idle drill pins the bare
        # default tenant bitwise-equal to off with these at zero).
        self._tenant = None            # tenant.registry.TenantSpec
        self._tenant_tid = 0
        self.tenant_counters = {"shed": 0, "throttle": 0,
                                "stale_reads": 0, "hedge_denied": 0}
        # ---- observability (obs/): always-on server-side latency
        # histograms (serve duration, park duration — the tail half of
        # the serve counters above — and rebalance-fence duration: a
        # fence that keeps aging is a migration losing, feed for the
        # windowed layer), the env-gated wire tracer, and the always-on
        # flight recorder. ``_trc.maybe_init`` arms the process tracer
        # from MINIPS_TRACE on first construction and is a no-op (one
        # env read) when off; ``_leg_t0`` is ALWAYS stamped since the
        # fail-slow plane (one dict insert/pop per wire leg): the hedge
        # timer needs each leg's issue time and the SlownessMonitor
        # needs the per-peer round trip a reply closes, tracer or not.
        # ``_fence_t0`` is likewise always stamped (the fence hist).
        self.hist_serve = Log2Histogram()
        self.hist_park = Log2Histogram()
        self.hist_fence = Log2Histogram()
        _trc.maybe_init(rank)
        _fl.maybe_init(rank)
        self._leg_t0: dict[int, tuple] = {}   # rid -> (t0, target)
        # ---- fail-slow plane (serve/hedge.py + obs/slowness.py; OFF
        # unless the trainer attaches them): hedged pull legs against
        # replica holders, and the per-peer latency feed for the
        # SlownessMonitor. _hedges_live bounds outstanding hedges
        # (budget); counters follow the serve-plane convention.
        self._hedge = None           # serve.hedge.HedgeConfig
        self._slowness = None        # obs.slowness.SlownessMonitor
        self._hedges_live: set[int] = set()
        # legs whose group completed WITHOUT their reply (a hedge won,
        # or the pull timed out): rid -> (t0, target), bounded. The
        # late reply is precisely the tail evidence that indicts a
        # slow rank — dropping it with the group would blind the
        # detector exactly when the mitigation works (measured: with
        # hedging on, every slow-owner sample went late). Insertion-
        # ordered; oldest evicted past the cap.
        self._late_t0: dict[int, tuple] = {}
        self.hedge_counters = {k: 0 for k in
                               ("fired", "won", "lost", "no_holder",
                                "denied")}
        self._fence_t0: dict[int, float] = {}  # block -> fence start
        # ---- hierarchical push tree (balance/hier.py; OFF unless the
        # trainer attaches a HierConfig). Member side: the elected
        # leader, the unacked retained window (re-pushed on fallback),
        # and the direct-mode latch. Leader side: per-owner buckets of
        # member contributions plus per-member boundary floors — the
        # flush trigger is the GROUP-MIN floor advancing, so whichever
        # boundary frame completes a step (training thread or recv
        # thread) ships exactly one aggregated frame per owner. Owner
        # side: per-contributor floors folded into pull admission.
        # _hier_lock guards all of it; _hier_flush_lock serializes the
        # flush critical section (snapshot + sends) so a later flush's
        # floor claim can never overtake an earlier flush's mass.
        self._hier = None                    # balance.hier.HierConfig
        self._hier_lock = threading.Lock()
        self._hier_flush_lock = threading.Lock()
        self._hier_floor: dict[int, int] = {}         # owner side
        self._hier_leader: Optional[int] = None       # member side
        self._hier_retained: list[tuple] = []  # (step, owner, keys, g)
        self._hier_direct = False            # fallback latch
        self._hier_buckets: dict[int, list] = {}      # leader side
        self._hier_member_floor: dict[int, int] = {}
        self._hier_own_floor = 0
        self._hier_flushed_floor = 0
        self._hier_members: list[int] = []
        self._hier_cross: list[int] = []
        self._hier_group: list[int] = []
        self._hier_shunned: Optional[int] = None  # leader I fell back from
        self._hier_expelled: set[int] = set()     # members gone direct
        self._hier_claimed: dict[int, int] = {}   # floors I flushed
        self._hier_xa: Optional[int] = None       # expel-ack floor
        self._hier_host_of = None
        self._hier_elect_fn = None
        # leader-lane EF: a DEDICATED store + rng — flushes can fire
        # from the recv thread (a member boundary completes the step),
        # and sharing _ef/_q_rng with the training thread's flat-path
        # encodes would race both the slab and the rng stream
        self._hier_ef = None
        self._hier_rng = None
        # agg=mesh: the leader's device-reduce backend (lazy — only a
        # LEADER that actually flushes pays the mesh build), plus the
        # whole-host failure-domain latch (sticky: a mesh host demotes
        # as ONE unit and never re-enters this incarnation)
        self._hier_mesh = None
        self._hier_mesh_failed = False
        self._hier_domain_down = False
        self.hier_counters = {k: 0 for k in (
            "l1_tx_bytes", "l1_frames", "l2_tx_bytes", "l2_frames",
            "agg_frames", "agg_rows", "floor_frames", "contribs",
            "elections", "fallbacks", "repushed_steps", "repush_drops",
            "stale_leader_drops", "mesh_reduces", "mesh_agg_fallbacks",
            "domain_demotions")}
        self.hist_hier = Log2Histogram()     # leader flush latency
        # ---- server shard: ONLY my row range lives here (the 1/N memory
        # claim, materialization included — a multi-GB Criteo table must
        # never exist whole on any host); per-(seed, rank) stream keeps
        # init deterministic, and no other process ever materializes these
        # rows (single-owner), so cross-replica init equality is moot
        self._w = (np.zeros((self.part.shard_size, self.dim), np.float32)
                   if not init_scale else
                   np.random.default_rng((seed, rank)).normal(
                       scale=init_scale,
                       size=(self.part.shard_size, self.dim)
                   ).astype(np.float32))
        self._acc = (np.full((self.part.shard_size, self.dim),
                             adagrad_init, np.float32)
                     if updater == "adagrad" else None)
        # lazy adam: moments + a per-row step counter for bias correction
        # (the server-side numpy twin of ops/sparse_update.row_adam —
        # untouched rows decay nothing, the standard sparse/CTR semantics)
        if updater == "adam":
            self._m = np.zeros((self.part.shard_size, self.dim), np.float32)
            self._v = np.zeros((self.part.shard_size, self.dim), np.float32)
            self._steps = np.zeros(self.part.shard_size, np.int32)
        else:
            self._m = self._v = self._steps = None
        self._state_lock = threading.Lock()
        # dropped-frame accounting: a dropped push is
        # a silently-lost gradient, so every early return below is counted,
        # exposed through the trainer's metrics, and asserted zero by the
        # multiproc smokes. A config mismatch (relaunch at a different
        # world size / table shape) additionally poisons the table — the
        # next client op raises instead of training garbage.
        self.drops = {"malformed": 0, "misrouted": 0, "config": 0}
        self._fatal: Optional[str] = None
        # ---- server-side admission (bound by ShardedPSTrainer): parked
        # pull requests waiting for the staleness rule — the reference's
        # PendingBuffer (SURVEY.md §2 ProgressTracker/PendingBuffer row)
        self._cons = None  # object with admit_pull(clk) + clock
        # parked pulls: (sender, req, keys|None, clk, ep, t_parked) —
        # the timestamp feeds the park-duration histogram (and the
        # tracer's 'parked' spans) when the entry is finally served
        self._parked: list[tuple] = []
        self._park_lock = threading.Lock()
        # ---- client plumbing
        self._req = 0
        self._req_lock = threading.Lock()
        # Pull bookkeeping is LEG-keyed: every per-owner slice of a pull
        # gets its own wire request id (rid), grouped under a group id
        # (gid) the PullFuture holds. The server is oblivious (it serves
        # whatever "req" it was sent) — what legs buy is RE-ROUTING: an
        # epoch-refused leg (psE, mid-migration) is re-split by the new
        # table and re-sent without disturbing the group's other legs.
        self._replies: dict[int, dict[int, tuple]] = {}  # gid->rid->reply
        self._reply_t: dict[int, float] = {}  # gid -> last-reply arrival
        self._rid_gid: dict[int, int] = {}    # live leg rid -> gid
        self._groups: dict[int, dict] = {}    # gid -> legs/clk/uniq
        self._reply_cond = threading.Condition()
        self._prefetched: dict[bytes, PullFuture] = {}
        self._prefetch_lock = threading.Lock()
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.rows_pushed = 0
        # ---- async-push pipeline: a bounded-window sender thread + an
        # in-flight ledger. Every cross-process frame carries a seq the
        # owner acks after handling (applied OR counted-dropped — a
        # withheld ack would stack a window stall on top of an already-
        # loud drop). Acks are BATCHED at the owner and mostly ride
        # PIGGYBACKED on pull replies (the PS cycle sends one per owner
        # per step anyway) — a dedicated psK frame goes out only on the
        # batch threshold, a clock event, or a drain's solicitation, so
        # steady state pays ~zero extra frames for loss detection (a
        # per-frame ack wire measurably LOST the overlap_on_off sweep
        # on CPU-bound hosts: +1 frame per push frame).
        # ``_inflight`` maps seq -> (send time, owner); its size is
        # the unacked window ``push_window`` bounds, and a seq that
        # never leaves it is exactly what the hard drain's deadline
        # turns into a poisoned table.
        self._push_seq = 0
        self._inflight: dict[int, tuple[float, int]] = {}
        self._dead_ranks: set[int] = set()  # membership deaths (sticky)
        self._ack_pending: dict[int, list[int]] = {}  # sender -> seqs
        self._ack_lock = threading.Lock()
        self._push_cond = threading.Condition()
        self._q_pending = 0            # queued items not yet fully sent
        self._push_q: Optional[queue.Queue] = None
        if self.async_push:
            self._push_q = queue.Queue()
            threading.Thread(target=self._push_loop, daemon=True,
                             name=f"ps-push:{name}").start()
        if bus is not None:
            bus.on(f"psP:{name}", self._on_push)
            bus.on(f"psR:{name}", self._on_push_range)
            bus.on(f"psG:{name}", self._on_pull)
            bus.on(f"psA:{name}", self._on_pull_all)
            bus.on(f"psr:{name}", self._on_pull_reply)
            bus.on(f"psK:{name}", self._on_push_ack)
            bus.on(f"psQ:{name}", self._on_ack_solicit)

    # --------------------------------------------------------- server side
    def _base_state(self) -> dict:
        """The base-slab state arrays as the dict shape block updates
        operate on — migrated-in blocks (``_xtra``) carry the identical
        shape, so the updater math below has exactly one implementation
        wherever a row lives."""
        return {"w": self._w, "acc": self._acc, "m": self._m,
                "v": self._v, "steps": self._steps}

    def _update_block(self, st: dict, uniq: np.ndarray,
                      g: np.ndarray) -> None:
        """One updater step on deduped rows of ONE storage (base slab or
        a migrated block) — caller holds the state lock, ``uniq`` are
        row indices into ``st``'s arrays."""
        if self.updater == "sgd":
            st["w"][uniq] -= self.lr * g
        elif self.updater == "adagrad":
            # accum += g², step by rsqrt of NEW accum
            st["acc"][uniq] += g * g
            st["w"][uniq] -= self.lr * g / (
                np.sqrt(st["acc"][uniq]) + self.eps)
        else:
            self._adam_rows(st, uniq, g)

    def _apply_rows(self, offs: np.ndarray, grads: np.ndarray) -> None:
        """Reference ``updater->Update``: sum duplicate keys, then one
        update per touched row (ops/sparse_update.py semantics)."""
        grads = grads.reshape(offs.size, self.dim)
        self._count_serve(push_rows=offs.size)
        if self._heat is not None:
            # the serve plane's promotion signal on the seed (rb-off)
            # path — the rb path's _ingest_push already touches
            self._heat.touch(self.router.blocks_of(offs + self.shard_lo))
        with self._state_lock:
            uniq, inv = np.unique(offs, return_inverse=True)
            g = np.zeros((uniq.size, self.dim), np.float32)
            np.add.at(g, inv, grads)
            self._update_block(self._base_state(), uniq, g)
        if self._sv is not None:
            # dirty-row tracking for replica delta refresh: noted in the
            # same handler call as the apply, so per-link FIFO keeps
            # 'covered by a refresh stamp' implying 'noted or shipped'
            self._sv.note_push(offs + self.shard_lo)

    def _adam_rows(self, st: dict, uniq: np.ndarray,
                   g: np.ndarray) -> None:
        """Lazy adam on the (deduped) touched rows — one full Adam step per
        row with per-row bias correction, matching row_adam's f32 math
        (caller holds the state lock)."""
        b1, b2 = np.float32(self.beta1), np.float32(self.beta2)
        t_new = st["steps"][uniq] + 1
        m_new = b1 * st["m"][uniq] + (np.float32(1) - b1) * g
        v_new = b2 * st["v"][uniq] + (np.float32(1) - b2) * g * g
        tf = t_new.astype(np.float32)[:, None]
        bc1 = np.float32(1) - b1 ** tf
        bc2 = np.float32(1) - b2 ** tf
        st["w"][uniq] -= np.float32(self.lr) * (m_new / bc1) / (
            np.sqrt(v_new / bc2) + np.float32(self.eps))
        st["m"][uniq] = m_new
        st["v"][uniq] = v_new
        st["steps"][uniq] = t_new

    def _apply_range(self, lo_local: int, grads: np.ndarray) -> None:
        grads = grads.reshape(-1, self.dim)
        self._count_serve(push_rows=grads.shape[0])
        if self._sv is not None:
            self._sv.note_push_range(
                self.shard_lo + lo_local,
                self.shard_lo + lo_local + grads.shape[0])
        sl = slice(lo_local, lo_local + grads.shape[0])
        with self._state_lock:
            if self.updater == "sgd":
                self._w[sl] -= self.lr * grads
            elif self.updater == "adagrad":
                self._acc[sl] += grads * grads
                self._w[sl] -= self.lr * grads / (
                    np.sqrt(self._acc[sl]) + self.eps)
            else:  # every row in the range is touched: plain lazy-adam rows
                self._adam_rows(self._base_state(),
                                np.arange(sl.start, sl.stop), grads)

    def _count_serve(self, pull_requests: int = 0, pull_rows: int = 0,
                     push_frames: int = 0, push_rows: int = 0) -> None:
        """Per-owner serve-load counters (always on): ``*_rows`` count
        rows read from / applied to THIS shard's storage, local or
        wire; ``pull_requests``/``push_frames`` count served wire
        frames. Done lines and ``wire_record`` carry them so partition
        imbalance is observable with the rebalancer off."""
        with self._serve_lock:
            s = self.serve
            s["pull_requests"] += pull_requests
            s["pull_rows"] += pull_rows
            s["push_frames"] += push_frames
            s["push_rows"] += push_rows

    # ------------------------------------------- heat-aware rebalancing
    def attach_rebalancer(self, rb, cfg) -> None:
        """Bind the migration machinery (balance/rebalancer.Rebalancer):
        rebuilds the router at the configured block granularity, arms
        heat accounting, and registers the migration control frames.
        Must happen before any traffic (the trainer's constructor does,
        which precedes the bus handshake in every app)."""
        from minips_tpu_torch.balance.heat import HeatAccountant

        self._rb = rb
        # a tenant may spec its own rebalance block granularity (its
        # rows may be much wider/narrower than the fleet default's
        # sweet spot); the per-frame rb stamp is per-table, so ranks
        # still cross-check — the registry's deterministic assignment
        # keeps them agreeing
        blk = cfg.block
        if self._tenant is not None and self._tenant.block is not None:
            blk = self._tenant.block
        self.router = BlockRouter(self.part, blk)
        self._heat = HeatAccountant(self.router.num_blocks, cfg.decay,
                                    table_id=self._tenant_tid)
        if self.bus is not None:
            self.bus.on(f"rbS:{self.name}", self._on_migrate_state)
            self.bus.on(f"rbA:{self.name}", self._on_adopt_ack)
            self.bus.on(f"rbF:{self.name}", self._on_fence_release)
            self.bus.on(f"rbG:{self.name}", self._on_release_ack)
            self.bus.on(f"psE:{self.name}", self._on_epoch_nack)

    def attach_reshard(self, cfg) -> None:
        """Arm planned collective redistribution (balance/redistribute,
        MINIPS_RESHARD): migration state ships as cap-bounded slice
        ROUNDS computed identically at every rank from the overlay diff
        instead of whole-block point-to-point snapshots. Requires the
        rebalancer machinery (the plan's input IS the epoch-fenced
        overlay diff; there is nothing to schedule without it)."""
        if self._rb is None:
            raise ValueError(
                "MINIPS_RESHARD schedules the epoch-fenced migration's "
                "state rounds — arm MINIPS_REBALANCE or MINIPS_ELASTIC "
                "too (attach_rebalancer first)")
        self._reshard = cfg

    def attach_tenant(self, spec) -> None:
        """Bind this table's tenant (tenant/registry.TenantSpec): the
        1-based tenant id joins the per-frame config stamp next to
        ws/nr/dm/rb — a fleet half-armed, or armed with divergent
        tenant order, poisons the table instead of silently crossing
        tenants' wires — and the spec's staleness/admission/hedge
        budgets override the fleet-wide ones wherever the serve plane
        and the consistency gates consult them. The trainer binds
        tenancy right after consistency and BEFORE any balance/serve
        layer arms, so attach_rebalancer/attach_serve_plane/
        attach_hedge can read the overrides."""
        self._tenant = spec
        self._tenant_tid = int(spec.tid)

    def attach_serve_plane(self, plane, cfg) -> None:
        """Bind the read-mostly serving plane (serve/plane.py): arms
        heat accounting when the rebalancer hasn't already, and
        registers the serve control/data frames. Must run AFTER
        ``attach_rebalancer`` when both are armed (the rebalancer
        rebuilds the router and heat at its own block granularity —
        the trainer constructs them in that order) and before any
        traffic, like the rebalancer."""
        from minips_tpu_torch.balance.heat import HeatAccountant
        from minips_tpu_torch.serve.plane import TableServeState

        self._sv = TableServeState(self, plane, cfg)
        if self._heat is None:
            self._heat = HeatAccountant(self.router.num_blocks,
                                        cfg.decay)
        if self.bus is not None:
            for kind, fn in self._sv.handlers():
                self.bus.on(f"{kind}:{self.name}", fn)

    def attach_hedge(self, cfg) -> None:
        """Arm hedged pull legs (serve/hedge.py): a leg outstanding
        past the hedge delay — or aimed at a slow-verdict owner — is
        re-issued to a replica holder under the identical admission
        stamp, first admissible reply wins. Pure client-side state; a
        table with no serving plane attached simply never finds a
        holder (counted ``no_holder``, the documented honest limit)."""
        if cfg is not None and self._tenant is not None \
                and self._tenant.hedge is not None:
            # per-tenant hedge budget: a shallow copy so one tenant's
            # budget never moves another's valve; hedge=0 keeps the
            # plane armed but always sheds at the valve (counted
            # ``denied`` + the tenant's ``hedge_denied``)
            import copy

            cfg = copy.copy(cfg)
            cfg.budget = int(self._tenant.hedge)
        self._hedge = cfg

    def attach_hier(self, cfg) -> None:
        """Arm the two-level push tree (balance/hier.py, MINIPS_HIER).
        Refusals here mirror the ctor's validation ladder: the retained
        window is the fallback's replay source, so any path that lets
        pushes leave the table without passing ``_push_now`` — the
        async push window re-frames sends on the flush thread, and the
        RowCache turns pulls into local reads the floor wait cannot
        see — would break the zero-lost-steps contract. With
        ``group=1`` (armed-idle) no pair is ever in hier mode and the
        push path is bitwise the flat wire."""
        from minips_tpu_torch.balance.hier import elect, group_ranks, host_of
        if cfg is None:
            return
        if self.async_push:
            raise ValueError(
                "MINIPS_HIER is incompatible with async_push/"
                "MINIPS_PUSH_WINDOW: the hier retained window replays "
                "exact member contributions on leader fallback, and "
                "the async window re-frames sends outside that "
                "bookkeeping — pick one push discipline")
        if self._cache is not None:
            raise ValueError(
                "MINIPS_HIER is incompatible with the client RowCache "
                "(MINIPS_CACHE_BYTES): cached reads bypass the owner's "
                "per-contributor floor wait, so a cache hit could "
                "observe a staleness bound the hier floors have not "
                "certified yet")
        self._hier = cfg
        self._hier_host_of = lambda r: host_of(r, cfg.group)
        self._hier_elect_fn = elect
        g, n = cfg.group, self.num_processes
        self._hier_group = group_ranks(self.rank, g, n)
        self._hier_members = [r for r in self._hier_group
                              if r != self.rank]
        self._hier_cross = [r for r in range(n)
                            if host_of(r, g) != host_of(self.rank, g)]
        if cfg.agg and g > 1:
            # owner side: pre-register a floor of 0 for every cross-
            # group contributor from a multi-rank group BEFORE any
            # frame flows — an empty floor dict must mean "no hier
            # contributors", never "none heard from yet", or the
            # admission gate would ignore them at startup
            self._hier_floor = {
                r: 0 for r in self._hier_cross
                if len(group_ranks(r, g, n)) >= 2}
            self._hier_member_floor = {r: 0 for r in self._hier_members}
            if self.push_comm in ("topk8", "topk4"):
                self._hier_ef = ResidualStore(self.dim)
            self._hier_rng = np.random.default_rng(
                (self._seed, self.rank, 0x48e5))
            if self.bus is not None:
                self.bus.on(f"psH:{self.name}", self._on_hier)
        self._hier_leader = self._hier_elect()

    def bind_slowness(self, sm) -> None:
        """Feed the fail-slow detector (obs/slowness.py): pull-leg
        round trips and push-ack lags recorded at the call sites that
        already hold the timestamps — no second measurement path."""
        self._slowness = sm

    def attach_membership(self, mb) -> None:
        """Bind the elastic membership plane (balance/membership.py).
        Requires the rebalancer machinery (membership transitions ARE
        epoch-fenced migrations); arms the death-survival paths below:
        a heartbeat-dead peer whose transition the plane owns unjams
        waits and re-routes legs instead of poisoning the run."""
        if self._rb is None:
            raise RuntimeError(
                "attach_membership requires the rebalancer machinery "
                "(attach_rebalancer first): membership transitions ride "
                "the epoch-fenced migration protocol")
        self._mb = mb

    def _fatal_dead(self, dead) -> set[int]:
        """The subset of heartbeat-dead peers that must still POISON a
        wait: everything, until the elastic membership plane is armed —
        then only deaths it cannot own (no checkpoint to restore from,
        a dead coordinator, verdict timeout). A survivable death keeps
        the wait alive until the membership plan re-homes the corpse's
        blocks and the wait's own re-check path unblocks it."""
        dead = set(dead)
        if not dead or self._mb is None:
            return dead
        return self._mb.fatal_dead(dead)

    def on_ranks_dead(self, dead: set[int]) -> None:
        """Detection-time unjam (membership death path, called the
        moment the monitor's verdict lands — BEFORE any plan): unacked
        push frames addressed to the corpse will never ack, so drop
        them from the window (counted — a lost push is a lost gradient,
        never silent) and wake every waiter so the re-check paths see
        the new world. The dead set is STICKY: frames the sender thread
        registers after this sweep (already-queued async pushes, or
        pushes the pre-plan table still routes to the corpse) are
        dropped by the wait loops' re-sweep and skipped at send time —
        a one-shot sweep would let a later-registered seq jam the
        window to its deadline."""
        with self._push_cond:
            self._dead_ranks |= set(dead)
            self._drop_dead_inflight_locked()
            self._push_cond.notify_all()
        with self._reply_cond:
            self._reply_cond.notify_all()
        with self._mig_cond:
            self._mig_cond.notify_all()

    def _drop_dead_inflight_locked(self) -> None:
        gone = [s for s, (_t, o) in self._inflight.items()
                if o in self._dead_ranks]
        for s in gone:
            del self._inflight[s]
        if gone:
            self.rb_stats["pushes_lost_to_dead"] += len(gone)

    def _reroute_dead_legs(self, gid: int, dead: set[int]) -> None:
        """Re-issue a pull group's legs addressed to dead ranks by the
        CURRENT routing table — the elastic twin of the psE re-router.
        Only legs whose keys no longer route to a corpse move (the
        membership plan must land first; until then the caller keeps
        waiting, bounded by its own deadline)."""
        with self._reply_cond:
            grp = self._groups.get(gid)
            assembly = grp is not None and grp.get("uniq") is None
            miss = dict(self._missing_legs_locked(gid))
        owner_map = self.router.owner_of_blocks()
        if assembly:
            if any(o in dead and not (owner_map == o).any()
                   for o in miss.values()):
                # a psA leg asks one rank for ITS shard — nothing to
                # re-route leg-wise once that rank is a corpse. The
                # death plan has re-homed its blocks (owner_map check),
                # so the whole assembly re-issues at the new epoch.
                with self._reply_cond:
                    self._cleanup_group_locked(gid)
                raise _ReissuePullAll()
            return
        for rid, o in miss.items():
            if o not in dead or (owner_map == o).any():
                continue  # alive, or the plan hasn't re-homed it yet

            def _plan(keys: np.ndarray):
                owners = self._owners_of(keys)
                return [(int(t), "psG", {}, owners == t)
                        for t in np.unique(owners)]
            self._resend_leg(rid, _plan)

    def _owners_of(self, keys: np.ndarray) -> np.ndarray:
        return (self.router.shard_of(keys) if self._rb is not None
                else self.part.shard_of(keys))

    def _ep_header(self) -> dict:
        return {"ep": self.router.epoch} if self._rb is not None else {}

    def _excluded_ranks(self) -> set[int]:
        g = getattr(self._cons, "gossip", None)
        return set(g.excluded) if g is not None else set()

    def adopt_table(self, ep: int, overlay: dict, *,
                    dead: frozenset = frozenset(),
                    restore=None) -> bool:
        """Adopt routing epoch ``ep`` — THE epoch fence point. Only ever
        run from the PUSH-DRIVING thread (trainer tick / finalize /
        pull_all / the pull-wait poll): the adoption ack's promise is
        'every stale-routed push of mine precedes this ack per link',
        which a bus-thread adoption racing a mid-flight send could
        break. Everything the fence's safety argument needs happens
        here, in order:

        1. (async push only) drain the send queue to the bus, so every
           stale-routed push of mine is on its per-link wire BEFORE my
           adoption ack;
        2. atomically with the serve-path verdicts (one lock): swap the
           routing table, SNAPSHOT outbound blocks' rows + optimizer
           state out of storage, and fence inbound blocks
           (state-pending until their ``rbS`` lands, pull-fenced until
           the old owner's ``rbF``);
        3. ship outbound state (``rbS``) and send my adoption ack
           (``rbA``) DIRECTED to every source owner — the same per-link
           stream my stale pushes rode, which is what lets the source
           conclude 'no more stale pushes from this rank' on receipt;
        4. drop row-cache entries of moved blocks and re-evaluate
           everything parked.

        DEATH plans (elastic membership, balance/membership.py) ride the
        same fence point with two extra arguments: blocks whose source
        is in ``dead`` cannot ship an rbS or release an rbF — the new
        owner instead installs ``restore(block)`` (the coordinator-chosen
        elastic-checkpoint state, ckpt/elastic.load_block_state) and
        serves immediately, un-fenced: no stale push can ever be
        forwarded from a corpse, so the fence would protect against
        nothing, and the restored content IS the recovery semantics
        (loss of a rank rolls exactly its ranges back to the last
        checkpoint, nothing else). Blocks stuck mid-migration ON the
        corpse (pending rbS / fenced on its rbF from an earlier epoch)
        resolve the same way.
        """
        if ep <= self.router.epoch:  # cheap duplicate cut (benign race;
            return False             # the locked apply re-checks)
        t_adopt0 = time.monotonic()
        if self.async_push:
            try:
                self.flush_pushes(acks=False)
            except Exception as e:  # noqa: BLE001 - poison, don't hide
                if self._fatal is None:
                    self._fatal = (f"table {self.name}: adoption drain "
                                   f"failed: {e!r}")
        # error-feedback residuals flush BEFORE the router swap: the
        # dense frames route by the OLD table and precede my rbA on
        # every per-link stream, so the fence's promise ('no more stale
        # pushes from this rank') covers withheld mass too — migration
        # and elastic transitions can never strand a residual
        try:
            self.residual_flush(reason="fence")
        except Exception as e:  # noqa: BLE001 - poison, don't hide
            if self._fatal is None:
                self._fatal = (f"table {self.name}: residual fence "
                               f"flush failed: {e!r}")
        ships: list[tuple[int, int, dict]] = []
        moved: list[tuple[int, int, int]] = []

        def _restore_locked(b: int) -> None:
            try:
                st = restore(b) if restore is not None else None
            except Exception as e:  # noqa: BLE001 - poison, don't hide
                st = None
                if self._fatal is None:
                    self._fatal = (f"table {self.name}: elastic restore "
                                   f"of block {b} failed: {e!r}")
            if st is None:
                if self._fatal is None:
                    self._fatal = (
                        f"table {self.name}: block {b} owned by a dead "
                        "rank has no restorable checkpoint state")
                return
            self._install_block_locked(b, st)
            self.rb_stats["blocks_restored"] += 1

        planned = self._reshard is not None
        out_blocks: list[tuple[int, int]] = []
        with self._mig_cond:
            prev = self.router.apply(ep, overlay)
            if prev is None:
                return False
            home = self.router.home_of
            for b in set(prev) | set(overlay):
                o_old = prev.get(b, home(b))
                o_new = overlay.get(b, home(b))
                if o_old != o_new:
                    moved.append((int(b), int(o_old), int(o_new)))
            with self._state_lock:
                for b, src, dst in moved:
                    if src == self.rank:
                        if planned:
                            # planned mode defers the snapshot: the
                            # block is quiescent the moment the router
                            # swapped (pushes forward, residuals
                            # flushed pre-swap), so each ROUND stages
                            # only its cap-bounded slice set later —
                            # the whole point of the schedule
                            out_blocks.append((b, dst))
                        else:
                            ships.append((b, dst,
                                          self._take_block_locked(b)))
                    if dst == self.rank:
                        if src in dead:
                            # no rbS/rbF will ever come from the corpse:
                            # restore from the elastic checkpoint and
                            # serve un-fenced (docstring above)
                            self._early_state.pop(b, None)
                            self._abort_slices_locked(b, "early")
                            _restore_locked(b)
                            continue
                        early = self._early_state.pop(b, None)
                        if early is not None \
                                and b not in self._early_prog:
                            self._install_block_locked(b, early)
                            self.rb_stats["blocks_in"] += 1
                        elif early is not None:
                            # a PARTIAL slice set beat my adoption: the
                            # buffer becomes the destination storage,
                            # remaining slices land via the pending path
                            self._install_block_locked(b, early)
                            self._slice_prog[b] = self._early_prog.pop(b)
                            self._pending_state[b] = src
                        else:
                            self._pending_state[b] = src
                        if (b, ep) in self._early_release:
                            self._early_release.discard((b, ep))
                        else:
                            self._fenced[b] = src
                            self._fence_t0[b] = time.monotonic()
                if dead:
                    # blocks stuck MID-MIGRATION on the corpse from an
                    # earlier epoch: a pending rbS that will never
                    # arrive restores from checkpoint; a fence whose
                    # rbF died with its old owner releases (no source
                    # left to forward a stale push)
                    for b in [b for b, s in self._pending_state.items()
                              if s in dead]:
                        del self._pending_state[b]
                        self._abort_slices_locked(b, "pending")
                        _restore_locked(b)
                    for b in [b for b, s in self._fenced.items()
                              if s in dead]:
                        del self._fenced[b]
                        self._fence_t0.pop(b, None)
            if ships:
                self._await_acks[ep] = [(b, dst) for b, dst, _ in ships]
            if out_blocks:
                self._await_acks[ep] = list(out_blocks)
            self._adopt_acks.setdefault(ep, set()).add(self.rank)
            # prune ack bookkeeping for long-released epochs
            for stale in [e for e in self._adopt_acks
                          if e < ep - 4 and e not in self._await_acks]:
                del self._adopt_acks[stale]
            self._mig_cond.notify_all()
        tr = _trc.TRACER
        if out_blocks:
            self._ship_planned(ep, moved, dead)
        if ships:
            # point-to-point path: EVERY outbound block's full state is
            # staged at once (the list above) — record it honestly, it
            # is the baseline the RESHARD-MEM gate compares against
            staged = sum(sum(int(a.nbytes) for a in st.values())
                         for _b, _dst, st in ships)
            self.rb_stats["peak_stage_bytes"] = max(
                self.rb_stats["peak_stage_bytes"], staged)
        for b, dst, st in ships:
            head, blob = self._encode_block_state(b, ep, st)
            self.bus.send(dst, f"rbS:{self.name}", head, blob=blob)
            self.rb_stats["blocks_out"] += 1
            self.rb_stats["migrated_rows"] += int(head["n"])
            if tr is not None:
                tr.instant("rebalance", "rb_ship",
                           {"b": int(b), "dst": int(dst),
                            "rows": int(head["n"]), "ep": ep})
        for src in sorted({s for _b, s, _d in moved
                           if s != self.rank and s not in dead}):
            self.bus.send(src, f"rbA:{self.name}", {"ep": ep})
        if self._sv is not None and moved:
            # lease/epoch invalidation: every replica lease I granted on
            # a block that just migrated away dies AT the fence point —
            # serving composes with online migration (docs/serving.md)
            self._sv.on_blocks_moved(moved)
        if self._cache is not None:
            for b, _src, _dst in moved:
                lo, ln = self.router.block_span(b)
                self._cache.invalidate(np.arange(lo, lo + ln, dtype=np.int64))
        self._maybe_release_fences(ep)
        self._drain_parked_pushes()
        self.serve_parked()
        if tr is not None:
            tr.complete("rebalance", "rb_adopt", t_adopt0,
                        {"ep": ep, "out": len(ships),
                         "moved": len(moved)})
        return True

    def _take_block_locked(self, b: int) -> dict:
        """Snapshot-and-remove block ``b``'s live state (caller holds
        the state lock): a home block's slab rows are copied out (the
        slab copy is dead until the block migrates back), a migrated-in
        block's arrays leave ``_xtra`` wholesale."""
        if self.router.home_of(b) == self.rank:
            lo, ln = self.router.block_span(b)
            sl = slice(lo - self.shard_lo, lo - self.shard_lo + ln)
            st = {"w": self._w[sl].copy()}
            if self._acc is not None:
                st["acc"] = self._acc[sl].copy()
            if self._m is not None:
                st["m"] = self._m[sl].copy()
                st["v"] = self._v[sl].copy()
                st["steps"] = self._steps[sl].copy()
            return st
        return self._xtra.pop(b)

    def _install_block_locked(self, b: int, st: dict) -> None:
        if self.router.home_of(b) == self.rank:
            lo, ln = self.router.block_span(b)
            sl = slice(lo - self.shard_lo, lo - self.shard_lo + ln)
            self._w[sl] = st["w"]
            if self._acc is not None:
                self._acc[sl] = st["acc"]
            if self._m is not None:
                self._m[sl] = st["m"]
                self._v[sl] = st["v"]
                self._steps[sl] = st["steps"]
        else:
            self._xtra[b] = st

    # ---------------- planned collective redistribution (MINIPS_RESHARD)
    def _ship_planned(self, ep: int, moved: list,
                      dead: frozenset) -> None:
        """Planned-mode shipper: compile the GLOBAL round schedule from
        the overlay diff — every rank derives the identical ``moved``
        set from prev/overlay at the shared epoch, so the plan needs no
        coordination wire — then stage and ship only MY slices, one
        cap-bounded round at a time. Runs on the push-driving thread
        right after the fence swap: every outbound block is quiescent
        from that moment (pushes forward under the new table, residuals
        flushed pre-swap), so per-round lazy snapshots are consistent
        by construction. Rounds are journaled in the frame head (``rd``
        next to ws/nr/dm/rb) and as ``reshard_round`` flight events;
        redelivered slices resume idempotently at the receiver
        (``reshard_resume``), a death mid-plan aborts the affected
        blocks back to checkpoint state (``reshard_abort``)."""
        from minips_tpu_torch.balance import redistribute as _rd

        cfg = self._reshard
        rbytes = _rd.state_row_bytes(self.dim, self.updater)
        live_moves = [(b, s, d) for b, s, d in moved if s not in dead]
        rounds = _rd.plan_rounds(
            live_moves, lambda b: self.router.block_span(b)[1], rbytes,
            cap=cfg.cap, fanout=cfg.fanout)
        self.rs_stats["plans"] += 1
        tr = _trc.TRACER
        total = {b: self.router.block_span(b)[1]
                 for b, s, _d in live_moves if s == self.rank}
        shipped = dict.fromkeys(total, 0)
        nrd = len(rounds)
        for rd, exchanges in enumerate(rounds):
            mine = [ex for ex in exchanges if ex.src == self.rank]
            if not mine:
                continue
            staged = []
            with self._state_lock:
                for ex in mine:
                    staged.append((ex, self._take_slice_locked(ex)))
                    shipped[ex.block] += ex.rows
                    if shipped[ex.block] >= total[ex.block]:
                        # the block's last slice just staged: a
                        # migrated-in block's arrays leave _xtra now —
                        # the planned twin of _take_block_locked's pop
                        self._xtra.pop(ex.block, None)
                        self.rb_stats["blocks_out"] += 1
            round_bytes = sum(sum(int(a.nbytes) for a in st.values())
                              for _ex, st in staged)
            self.rs_stats["peak_stage_bytes"] = max(
                self.rs_stats["peak_stage_bytes"], round_bytes)
            self.rb_stats["peak_stage_bytes"] = max(
                self.rb_stats["peak_stage_bytes"], round_bytes)
            for ex, st in staged:
                head, blob = self._encode_block_state(ex.block, ep, st)
                head.update({"rd": int(rd), "nrd": int(nrd),
                             "sl": int(ex.lo),
                             "bn": int(total[ex.block])})
                self.bus.send(ex.dst, f"rbS:{self.name}", head,
                              blob=blob)
                self.rs_stats["slices"] += 1
                self.rb_stats["migrated_rows"] += int(ex.rows)
                if tr is not None:
                    tr.instant("rebalance", "rb_ship",
                               {"b": int(ex.block), "dst": int(ex.dst),
                                "rows": int(ex.rows), "ep": ep,
                                "rd": int(rd), "sl": int(ex.lo)})
            self.rs_stats["rounds"] += 1
            _fl.record("reshard_round",
                       {"table": self.name, "ep": int(ep),
                        "rd": int(rd), "nrd": int(nrd),
                        "ships": len(mine), "bytes": int(round_bytes)})

    def _take_slice_locked(self, ex) -> dict:
        """Copy rows ``[lo, lo+rows)`` of block ``ex.block``'s live
        state WITHOUT removing it (caller holds the state lock): the
        block stays readable for later rounds' slices; removal happens
        once its last slice is staged (_ship_planned)."""
        b, lo, n = ex.block, ex.lo, ex.rows
        if self.router.home_of(b) == self.rank:
            blo, _ln = self.router.block_span(b)
            s = blo - self.shard_lo + lo
            sl = slice(s, s + n)
            st = {"w": self._w[sl].copy()}
            if self._acc is not None:
                st["acc"] = self._acc[sl].copy()
            if self._m is not None:
                st["m"] = self._m[sl].copy()
                st["v"] = self._v[sl].copy()
                st["steps"] = self._steps[sl].copy()
            return st
        src = self._xtra[b]
        return {k: v[lo:lo + n].copy() for k, v in src.items()}

    def _zero_block_state(self, n: int) -> dict:
        """A zero-filled full-block state dict in the rbS layout — the
        destination allocation slice writes land in (it IS the block's
        final storage for a non-home gainer, not extra staging)."""
        st = {"w": np.zeros((n, self.dim), np.float32)}
        if self._acc is not None:
            st["acc"] = np.zeros((n, self.dim), np.float32)
        if self._m is not None:
            st["m"] = np.zeros((n, self.dim), np.float32)
            st["v"] = np.zeros((n, self.dim), np.float32)
            st["steps"] = np.zeros(n, np.int32)
        return st

    def _write_slice_locked(self, b: int, lo: int, st: dict,
                            bn: int) -> None:
        """Install one slice's rows straight into destination storage
        (caller holds the state lock): the block is fenced + state-
        pending for the whole plan, so nothing reads or writes these
        rows until completion flips the pending bit — receiver staging
        stays one in-flight frame, never a buffered block."""
        n = st["w"].shape[0]
        if self.router.home_of(b) == self.rank:
            blo, _ln = self.router.block_span(b)
            s = blo - self.shard_lo + lo
            sl = slice(s, s + n)
            self._w[sl] = st["w"]
            if self._acc is not None:
                self._acc[sl] = st["acc"]
            if self._m is not None:
                self._m[sl] = st["m"]
                self._v[sl] = st["v"]
                self._steps[sl] = st["steps"]
            return
        dst = self._xtra.get(b)
        if dst is None:
            dst = self._zero_block_state(bn)
            self._xtra[b] = dst
        for k, arr in st.items():
            dst[k][lo:lo + n] = arr

    def _abort_slices_locked(self, b: int, where: str) -> None:
        """Discard partial slice progress for block ``b`` (its source
        died mid-plan): the checkpoint restore that follows IS the
        abort-to-known-state contract — partially landed slices are
        overwritten wholesale, never mixed with restored rows."""
        prog = self._slice_prog.pop(b, None)
        eprog = self._early_prog.pop(b, None)
        got = (prog or eprog or {}).get("got", 0)
        if prog is not None or eprog is not None:
            self.rs_stats["aborts"] += 1
            _fl.record("reshard_abort",
                       {"table": self.name, "b": int(b),
                        "rows_got": int(got), "where": where})

    def _ingest_slice(self, sender: int, payload: dict,
                      st: dict) -> None:
        """Receiver half of the planned shipper: one slice frame lands
        in destination storage exactly-once. The journal is the per-
        block ``seen`` offset set — a redelivered slice (partition
        heal, reliable-channel retransmit) is counted and dropped
        (``reshard_resume``), never double-applied; completion routes
        through the same install bookkeeping as a whole-block rbS."""
        b = int(payload.get("b", -1))
        lo = int(payload.get("sl", 0))
        bn = int(payload.get("bn", 0))
        rd = int(payload.get("rd", 0))
        n = st["w"].shape[0]
        done = dup = False
        with self._mig_cond:
            with self._state_lock:
                if b in self._pending_state:
                    prog = self._slice_prog.setdefault(
                        b, {"got": 0, "seen": set()})
                    if lo in prog["seen"]:
                        dup = True
                    else:
                        self._write_slice_locked(b, lo, st, bn)
                        prog["seen"].add(lo)
                        prog["got"] += n
                        if prog["got"] >= bn:
                            del self._slice_prog[b]
                            self._pending_state.pop(b, None)
                            self.rb_stats["blocks_in"] += 1
                            done = True
                elif int(self.router.owner_of_blocks()[b]) == self.rank:
                    # slice of an already-installed block (full replay
                    # after a heal): a re-write would roll back updates
                    # applied since — drop it, count it
                    dup = True
                else:
                    # slices beat my plan adoption: accumulate into a
                    # full-block buffer exactly like _early_state (the
                    # reorder window is bounded; adoption installs a
                    # complete buffer, or carries a partial one into
                    # the pending path with its progress journal)
                    prog = self._early_prog.setdefault(
                        b, {"got": 0, "seen": set()})
                    if lo in prog["seen"]:
                        dup = True
                    else:
                        buf = self._early_state.get(b)
                        if buf is None:
                            buf = self._zero_block_state(bn)
                            self._early_state[b] = buf
                        for k, arr in st.items():
                            buf[k][lo:lo + n] = arr
                        prog["seen"].add(lo)
                        prog["got"] += n
                        if prog["got"] >= bn:
                            del self._early_prog[b]
            self._mig_cond.notify_all()
        if dup:
            self.rs_stats["dup_slices"] += 1
            _fl.record("reshard_resume",
                       {"table": self.name, "b": int(b), "sl": int(lo),
                        "rd": int(rd), "from": int(sender)})
        if done:
            tr = _trc.TRACER
            if tr is not None:
                tr.instant("rebalance", "rb_install", {"b": b})
            self._drain_parked_pushes()
            self.serve_parked()

    def reshard_table_stats(self) -> Optional[dict]:
        """Planned-redistribution counters — None when MINIPS_RESHARD
        is off (off vs armed-idle, the obs convention)."""
        if self._reshard is None:
            return None
        with self._mig_cond:
            inflight = len(self._slice_prog) + len(self._early_prog)
        return {**self.rs_stats, "blocks_inflight": inflight,
                "cap": self._reshard.cap,
                "fanout": self._reshard.fanout}

    def _encode_block_state(self, b: int, ep: int, st: dict) -> tuple:
        """rbS wire format: rows AND optimizer state AND the shipper's
        min-clock view at snapshot time (stamp metadata — recorded so
        drills can audit that a migrated block's content was at least
        as fresh as the bound requires)."""
        n = st["w"].shape[0]
        parts = [np.ascontiguousarray(st["w"], np.float32)]
        for k in ("acc", "m", "v"):
            if st.get(k) is not None:
                parts.append(np.ascontiguousarray(st[k], np.float32))
        if st.get("steps") is not None:
            parts.append(np.ascontiguousarray(st["steps"], np.int32))
        g = getattr(self._cons, "gossip", None)
        stamp = int(g.global_min()) if g is not None else 0
        head = {"b": int(b), "ep": int(ep), "n": int(n), "stamp": stamp,
                "u": self.updater, **self._cfg_header()}
        return head, _cat_blob(*parts)

    def _decode_block_state(self, payload: dict) -> Optional[dict]:
        n = int(payload.get("n", 0))
        blob = payload.get("__blob__") or b""
        row = n * self.dim * 4
        need = row * {"sgd": 1, "adagrad": 2, "adam": 3}[self.updater] \
            + (n * 4 if self.updater == "adam" else 0)
        if payload.get("u") != self.updater or len(blob) != need:
            return None
        st = {"w": np.frombuffer(blob[:row], np.float32
                                 ).reshape(n, self.dim).copy()}
        off = row
        if self.updater == "adagrad":
            st["acc"] = np.frombuffer(blob[off:off + row], np.float32
                                      ).reshape(n, self.dim).copy()
        elif self.updater == "adam":
            st["m"] = np.frombuffer(blob[off:off + row], np.float32
                                    ).reshape(n, self.dim).copy()
            st["v"] = np.frombuffer(blob[off + row:off + 2 * row],
                                    np.float32).reshape(n, self.dim).copy()
            st["steps"] = np.frombuffer(blob[off + 2 * row:],
                                        np.int32).copy()
        return st

    def _on_migrate_state(self, sender: int, payload: dict) -> None:
        b = int(payload.get("b", -1))
        if not self._check_peer_config(sender, payload):
            return
        st = self._decode_block_state(payload)
        if st is None:
            self._drop("malformed", sender, "bad rbS block state")
            return
        if "sl" in payload:  # planned-mode slice frame (MINIPS_RESHARD)
            self._ingest_slice(sender, payload, st)
            return
        tr = _trc.TRACER
        with self._mig_cond:
            with self._state_lock:
                if b in self._pending_state:
                    self._install_block_locked(b, st)
                    self._pending_state.pop(b, None)
                    self.rb_stats["blocks_in"] += 1
                    if tr is not None:
                        tr.instant("rebalance", "rb_install", {"b": b})
                elif int(self.router.owner_of_blocks()[b]) == self.rank:
                    pass  # duplicate of an installed block: a re-install
                    # would roll back updates applied since — drop it
                else:
                    # rbS beat my plan adoption: stash until it arrives
                    # (a whole-block frame supersedes any partial slice
                    # accumulation — drop its progress journal too)
                    self._early_prog.pop(b, None)
                    self._early_state[b] = st
            self._mig_cond.notify_all()
        self._drain_parked_pushes()
        self.serve_parked()

    def _on_adopt_ack(self, sender: int, payload: dict) -> None:
        ep = int(payload.get("ep", 0))
        with self._mig_cond:
            self._adopt_acks.setdefault(ep, set()).add(sender)
        self._maybe_release_fences(ep)

    def _maybe_release_fences(self, ep: int) -> None:
        """Old-owner side: once every LIVE rank acked adoption of ``ep``,
        no more stale-routed pushes can arrive here (each rbA trails
        that rank's last stale push on its per-link stream) — so the
        fence release (rbF) sent NOW on the old→new link is ordered
        after every forwarded push. Re-checked on exclusions too, so a
        dead rank can't hold fences forever."""
        with self._mig_cond:
            out = self._await_acks.get(ep)
            if out is None:
                return
            live = set(range(self.num_processes)) - self._excluded_ranks()
            if not live <= self._adopt_acks.get(ep, set()):
                return
            del self._await_acks[ep]
            now = time.monotonic()
            for b, dst in out:
                self._release_unacked[(int(b), int(dst))] = (int(ep),
                                                             now)
        for b, dst in out:
            self.bus.send(dst, f"rbF:{self.name}",
                          {"b": int(b), "ep": int(ep)})

    def _on_fence_release(self, sender: int, payload: dict) -> None:
        b, ep = int(payload.get("b", -1)), int(payload.get("ep", 0))
        released = False
        with self._mig_cond:
            if b in self._fenced and self.router.epoch >= ep:
                self._fenced.pop(b, None)
                released = True
            else:  # rbF beat my plan adoption (reordered control plane)
                self._early_release.add((b, ep))
            self._mig_cond.notify_all()
        # confirm receipt (idempotent — a re-sent rbF for an already-
        # released fence still acks): the old owner's leave() gate
        # re-sends rbF until this lands, so a release eaten by a
        # partition cannot strand the fence after the sender exits
        self.bus.send(sender, f"rbG:{self.name}",
                      {"b": b, "ep": ep})
        if released:
            t0 = self._fence_t0.pop(b, None)
            if t0 is not None:
                # always-on fence-duration hist (the windowed layer's
                # rebalance signal); the tracer span rides when armed
                self.hist_fence.record_s(time.monotonic() - t0)
                tr = _trc.TRACER
                if tr is not None:
                    tr.complete("rebalance", "rb_fence", t0,
                                {"b": b, "ep": ep})
        self.serve_parked()

    def _on_release_ack(self, sender: int, payload: dict) -> None:
        b = int(payload.get("b", -1))
        with self._mig_cond:
            self._release_unacked.pop((b, int(sender)), None)
            self._mig_cond.notify_all()

    def releases_confirmed(self) -> bool:
        """Every rbF this rank sent has been confirmed (rbG) by a
        still-live gainer — the leave() exit gate. Entries addressed to
        ranks excluded since (died mid-handshake) are pruned: their
        fences resolve through the death plan's dead-source path, not
        through a confirmation that can never come."""
        with self._mig_cond:
            if self._release_unacked:
                gone = self._excluded_ranks()
                for key in [k for k in self._release_unacked
                            if k[1] in gone]:
                    del self._release_unacked[key]
            return not self._release_unacked

    def resend_stale_releases(self, age_s: float = 0.25) -> None:
        """Re-send unconfirmed fence releases older than ``age_s`` —
        called from the leave() wait loop so a partition that ate the
        first rbF heals into a released fence instead of a permanently
        wedged gainer (the sender is about to exit; nobody else can
        ever release that fence)."""
        now = time.monotonic()
        with self._mig_cond:
            stale = [(b, dst, ep)
                     for (b, dst), (ep, t0) in
                     self._release_unacked.items()
                     if now - t0 > age_s]
            for b, dst, ep in stale:
                self._release_unacked[(b, dst)] = (ep, now)
        for b, dst, ep in stale:
            self.bus.send(dst, f"rbF:{self.name}",
                          {"b": int(b), "ep": int(ep)})

    def rebalance_settled(self) -> bool:
        """No migration in flight at this rank: nothing fenced, no state
        pending, no acks awaited, nothing parked — the coordinator only
        plans over a fleet that reports settled at one epoch."""
        with self._mig_cond:
            return not (self._fenced or self._pending_state
                        or self._await_acks or self._parked_pushes
                        or self._early_state)

    def _wait_settled(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            # adopt pending plans while waiting: a plan landing in this
            # window stashes rbS state as early_state here (unsettled),
            # and only THIS thread can adopt it — blocking without
            # adopting would wedge until the deadline
            if self._rb is not None:
                self._rb.adopt_now()
            if self._mb is not None:
                # membership poll too (the gate poll_hook rule): a
                # partitioned ex-coordinator can sit HERE awaiting acks
                # for a plan the survivors FENCED — acks that will
                # never come from peers it cannot convict. Its own
                # death verdict (FencedOutError) must be able to
                # resolve the wait instead of the settle deadline
                # mislabeling it a gate_timeout.
                self._mb.poll()
            with self._mig_cond:
                if not (self._fenced or self._pending_state
                        or self._await_acks or self._parked_pushes
                        or self._early_state):
                    return
                if time.monotonic() > deadline:
                    # flight dump OUTSIDE the lock below (file I/O +
                    # the windowed snapshot hook must never run under
                    # a table lock a reliable-dispatched handler may
                    # want — the outside-the-lock rule every poison
                    # site in this file follows)
                    fenced = sorted(self._fenced)
                    pending = sorted(self._pending_state)
                    break
                self._mig_cond.wait(timeout=0.2)
        _fl.poison("settle_deadline",
                   {"table": self.name, "fenced": fenced,
                    "pending": pending})
        raise TimeoutError(
            f"table {self.name}: migration never settled "
            f"(fenced={fenced}, pending={pending})")

    def rebalance_table_stats(self) -> dict:
        with self._mig_cond:
            extra = {"fenced": len(self._fenced),
                     "pending_state": len(self._pending_state),
                     "xtra_blocks": len(self._xtra)}
        return {"epoch": self.router.epoch, **self.rb_stats, **extra}

    # ---- serve-path classification (rebalancer on)
    def _pull_verdict(self, keys: np.ndarray, ep: int,
                      owners: Optional[np.ndarray] = None) -> str:
        """'serve' | 'park' | 'refuse' for a pull slice under MY current
        table: keys not mine → the sender's table is stale (refuse with
        mine) unless the FRAME's is newer (park until my adoption
        catches up); keys mine but fenced/state-pending → park.
        ``owners`` lets a caller that already routed the keys skip the
        recompute (the hot serve path routes once per frame)."""
        if owners is None:
            owners = self.router.shard_of(keys)
        if (owners != self.rank).any():
            return "park" if ep > self.router.epoch else "refuse"
        with self._mig_cond:
            if self._fenced or self._pending_state:
                blocks = {int(x)
                          for x in np.unique(self.router.blocks_of(keys))}
                if blocks & (self._fenced.keys()
                             | self._pending_state.keys()):
                    return "park"
        return "serve"

    def _pull_all_verdict(self, ep: int = 0) -> str:
        """'serve' | 'park' for a shard-assembly request stamped with
        the REQUESTER's routing epoch ``ep``: park while a migrated
        block is in transit here, and park requests from a NEWER epoch
        until my adoption catches up — a pre-adoption reply would omit
        every block the new table assigns to me (a death plan's
        restored blocks have no other live holder, so the assembler
        would read uninitialized rows for their span)."""
        if ep > self.router.epoch:
            return "park"
        with self._mig_cond:
            return "park" if (self._fenced or self._pending_state) \
                else "serve"

    def _send_epoch_nack(self, sender: int, req: int) -> None:
        ep, ov = self.router.table()
        self.rb_stats["refused_pulls"] += 1
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("serve", "pull_refused",
                       {"from": sender, "rid": req, "ep": ep})
        self.bus.send(sender, f"psE:{self.name}",
                      {"req": int(req), "ep": ep,
                       "ovb": [int(b) for b in ov],
                       "ovo": [int(o) for o in ov.values()]})

    # ---- push ingest (rebalancer on): classify → apply/forward/park
    def _ingest_push(self, keys: np.ndarray, grads: np.ndarray,
                     ep: int) -> None:
        forwards: list[tuple[int, np.ndarray, np.ndarray]] = []
        with self._mig_cond:
            owners = self.router.shard_of(keys)
            bad = (owners < 0) | (owners >= self.num_processes)
            if bad.any():  # garbage keys from a stale run
                self._drop("misrouted", -1, "push keys outside key space")
                keys, grads, owners = (keys[~bad], grads[~bad],
                                       owners[~bad])
            mine = owners == self.rank
            if not mine.all():
                if ep > self.router.epoch:
                    # the sender runs a NEWER table than me: park the
                    # whole frame until my adoption catches up
                    self._parked_pushes.append((keys, grads, ep))
                    self.rb_stats["parked_frames"] += 1
                    return
                for o in np.unique(owners[~mine]):
                    m = owners == o
                    forwards.append((int(o), keys[m], grads[m]))
                keys, grads = keys[mine], grads[mine]
            if keys.size:
                pend = self._pending_state
                if pend:
                    blocks = self.router.blocks_of(keys)
                    pm = np.isin(blocks,
                                 np.fromiter(pend, np.int64, len(pend)))
                    if pm.any():  # inbound block, state still in transit
                        self._parked_pushes.append(
                            (keys[pm], grads[pm], ep))
                        self.rb_stats["parked_frames"] += 1
                        keys, grads = keys[~pm], grads[~pm]
            if keys.size:
                self._heat.touch(self.router.blocks_of(keys))
                self._apply_keys_locked(keys, grads)
        tr = _trc.TRACER
        for o, k, g in forwards:
            # forwarded slice: decoded f32 rows, no seq (the ORIGINAL
            # frame was acked by this hop; the reliable layer covers
            # the second hop like any other frame)
            self.rb_stats["forwarded_pushes"] += 1
            if tr is not None:
                tr.instant("push", "push_forward",
                           {"to": int(o), "n": int(k.size)})
            blob = _cat_blob(k, np.ascontiguousarray(g, np.float32))
            self.bus.send(o, f"psP:{self.name}",
                          {"n": int(k.size), "comm": "float32",
                           "ep": self.router.epoch, **self._cfg_header()},
                          blob=blob)

    def _apply_keys_locked(self, keys: np.ndarray,
                           grads: np.ndarray) -> None:
        """Global-key twin of :meth:`_apply_rows` (caller holds the mig
        lock; takes the state lock): dedup-sum over the WHOLE frame
        first — identical math to the seed path — then split the unique
        rows between the base slab and migrated-in blocks."""
        grads = grads.reshape(keys.size, self.dim)
        self._count_serve(push_rows=keys.size)
        with self._state_lock:
            uniq, inv = np.unique(keys, return_inverse=True)
            g = np.zeros((uniq.size, self.dim), np.float32)
            np.add.at(g, inv, grads)
            base = (uniq >= self.shard_lo) \
                & (uniq < self.shard_lo + self.part.shard_size)
            if base.any():
                self._update_block(self._base_state(),
                                   uniq[base] - self.shard_lo, g[base])
            if (~base).any():
                rk, rg = uniq[~base], g[~base]
                blocks = self.router.blocks_of(rk)
                for b in np.unique(blocks):
                    m = blocks == b
                    st = self._xtra.get(int(b))
                    if st is None:  # protocol hole — loud, not silent
                        raise RuntimeError(
                            f"table {self.name}: no state for migrated "
                            f"block {int(b)} (keys routed here without "
                            "an installed rbS)")
                    lo, _ln = self.router.block_span(int(b))
                    self._update_block(st, rk[m] - lo, rg[m])
        if self._sv is not None:
            self._sv.note_push(keys)  # replica delta dirty tracking

    def _drain_parked_pushes(self) -> None:
        with self._mig_cond:
            take, self._parked_pushes = self._parked_pushes, []
        for keys, grads, ep in take:
            self._ingest_push(keys, grads, ep)

    def _read_rows_locked(self, keys: np.ndarray) -> np.ndarray:
        """Gather rows for keys THIS shard currently owns, wherever they
        live (base slab or migrated-in blocks); caller holds the state
        lock and has already classified ownership."""
        out = np.empty((keys.size, self.dim), np.float32)
        base = (keys >= self.shard_lo) \
            & (keys < self.shard_lo + self.part.shard_size)
        if base.any():
            out[base] = self._w[keys[base] - self.shard_lo]
        if (~base).any():
            rk = keys[~base]
            ri = np.nonzero(~base)[0]
            blocks = self.router.blocks_of(rk)
            for b in np.unique(blocks):
                m = blocks == b
                st = self._xtra.get(int(b))
                if st is None:
                    raise RuntimeError(
                        f"table {self.name}: no state for migrated "
                        f"block {int(b)} on pull")
                lo, _ln = self.router.block_span(int(b))
                out[ri[m]] = st["w"][rk[m] - lo]
        return out

    def _drop(self, reason: str, sender: int, detail: str) -> None:
        """Count a dropped frame; config mismatches (a peer launched at a
        different world size or table shape would route keys wrong forever)
        also poison the table so the next client op raises loudly."""
        self.drops[reason] += 1
        if reason == "config" and self._fatal is None:
            self._fatal = (f"table {self.name}: dropped frame from peer "
                           f"{sender}: {detail}")

    def _rb_cfg(self) -> int:
        """The rebalance config a frame stamps: the key-block size when
        the subsystem is armed, 0 when off. Divergence is a config
        mismatch like a wrong world size — an rb-off peer would
        silently drop overlay-routed pushes as misrouted and hang its
        refused pulls to timeout, and a different block granularity
        makes every overlay block id mean a different key range."""
        return self.router.block_size if self._rb is not None else 0

    def _check_peer_config(self, sender: int, payload: dict) -> bool:
        ws = int(payload.get("ws", self.num_processes))
        nr = int(payload.get("nr", self.num_rows))
        dm = int(payload.get("dm", self.dim))
        rb = int(payload.get("rb", 0))
        tb = int(payload.get("tb", 0))
        if ws != self.num_processes or nr != self.num_rows \
                or dm != self.dim or rb != self._rb_cfg() \
                or tb != self._tenant_tid:
            self._drop("config", sender,
                       f"peer sees world_size={ws} num_rows={nr} dim={dm}"
                       f" rebalance_block={rb} tenant={tb}, mine are "
                       f"{self.num_processes}/{self.num_rows}/"
                       f"{self.dim}/{self._rb_cfg()}/{self._tenant_tid}")
            return False
        return True

    def _cfg_header(self) -> dict:
        """Per-frame config stamp: a peer relaunched at a different world
        size / table shape — or with a divergent rebalance or tenant
        config — must poison the receiver (loud failure), never
        silently train garbage. ``tb`` is the 1-based tenant id
        (tenant/registry.py): absent/0 = tenancy off, so an off fleet's
        frames are byte-identical to before tenancy existed, and a
        half-armed fleet (or one whose ranks disagree on tenant order)
        fails the stamp check both directions."""
        hd = {"ws": self.num_processes, "nr": self.num_rows,
              "dm": self.dim, "rb": self._rb_cfg()}
        if self._tenant_tid:
            hd["tb"] = self._tenant_tid
        return hd

    def _on_push(self, sender: int, payload: dict) -> None:
        try:
            self._handle_push(sender, payload)
        finally:
            self._ack_push(sender, payload)

    def _on_push_range(self, sender: int, payload: dict) -> None:
        try:
            self._handle_push_range(sender, payload)
        finally:
            self._ack_push(sender, payload)

    def _ack_push(self, sender: int, payload: dict) -> None:
        """Ack EVERY seq-stamped frame, applied or dropped: a dropped
        frame is already loud at this end (drop counters; config drops
        poison my table), and withholding the ack would stall the
        pusher's window on top of it — one fault, one failure path.

        Acks are BATCHED, not per-frame: the seq lands in a per-sender
        pending list and rides out piggybacked on my next pull reply to
        that sender (one per PS cycle in steady state — zero extra
        frames), or in a dedicated psK frame when the batch threshold
        trips, a clock event lands (serve_parked), or the sender's
        drain solicits (psQ)."""
        seq = payload.get("seq")
        if seq is None or self.bus is None:
            return
        with self._ack_lock:
            pend = self._ack_pending.setdefault(sender, [])
            pend.append(int(seq))
            if len(pend) < max(1, self.push_window // 4):
                return
            seqs, self._ack_pending[sender] = pend, []
        self.bus.send(sender, f"psK:{self.name}", {"seqs": seqs})

    def _drain_acks_for(self, sender: int) -> list[int]:
        with self._ack_lock:
            return self._ack_pending.pop(sender, None) or []

    def _flush_acks(self, sender: Optional[int] = None) -> None:
        """Send out pending ack batches — for one sender (drain
        solicitation) or all (clock events): liveness when no pull
        reply is flowing to piggyback on."""
        with self._ack_lock:
            if sender is None:
                out = [(s, q) for s, q in self._ack_pending.items() if q]
                self._ack_pending.clear()
            else:
                q = self._ack_pending.pop(sender, None)
                out = [(sender, q)] if q else []
        for s, seqs in out:
            self.bus.send(s, f"psK:{self.name}", {"seqs": seqs})

    def _on_ack_solicit(self, sender: int, payload: dict) -> None:
        # per-link FIFO: the solicit was sent after the frames it wants
        # acked, so their seqs are already in my pending list
        self._flush_acks(sender)

    def _handle_push(self, sender: int, payload: dict) -> None:
        t_apply0 = time.monotonic()
        blob = payload.get("__blob__")
        n = int(payload.get("n", 0))
        comm = payload.get("comm", "float32")
        tr = _trc.TRACER
        if not self._check_peer_config(sender, payload):
            return
        if self._hier is not None and self._hier_floor:
            # stale-leader fence: an aggregated frame (it carries hfr
            # floor claims) from a sender the quorum has since convicted
            # must be dropped WHOLE — its members re-push that mass on
            # fallback, so applying the zombie copy would double-apply
            if "hfr" in payload and sender in (
                    self._excluded_ranks() | self._dead_ranks):
                self.hier_counters["stale_leader_drops"] += 1
                return
            # fallback re-push dedup: the step tag rides the exact f32
            # frame; tags below the floor the (now dead) leader already
            # delivered were applied via its last flush — exactly-once
            # across the handoff
            hst = payload.get("hst")
            if hst is not None and int(hst) < self._hier_floor.get(
                    sender, 0):
                self.hier_counters["repush_drops"] += 1
                return
        # frames self-describe their wire format, so a mixed fleet (one
        # pusher compressed, another not) decodes correctly per frame
        if comm in ("topk8", "topk4"):
            # the sparse top-k index+code stream: int32/int64 indices,
            # blockwise f32 scales, then 8- or 4-bit codes — decoded
            # into plain f32 rows here, so the updaters below (and the
            # rebalancer's forward/park classification) never know the
            # wire was compressed (ops/sparse_update.py semantics
            # already match sparse index-value application)
            bits = 8 if comm == "topk8" else 4
            blk = int(payload.get("blk", HOST_BLOCK))
            code_b, scale_b = blockwise_stream_bytes(n, self.dim, bits,
                                                     blk)
            if "dw" in payload:
                # sorted-run delta key stream (i64 base + narrow gaps —
                # ops/quantized_comm codec); frames self-describe, so a
                # plain-width pusher interoperates
                dw = int(payload["dw"])
                key_b = delta_stream_bytes(n, dw)
                if blob is None or dw not in (1, 2, 4, 8) or blk < 1 \
                        or len(blob) != key_b + scale_b + code_b:
                    self._drop("malformed", sender, "bad topk push blob")
                    return
                keys = decode_key_deltas(blob[:key_b], n, dw)
            else:
                kw = int(payload.get("kw", 8))
                key_b = n * kw
                if blob is None or kw not in (2, 4, 8) or blk < 1 \
                        or len(blob) != key_b + scale_b + code_b:
                    self._drop("malformed", sender, "bad topk push blob")
                    return
                kdt = {2: np.uint16, 4: np.int32, 8: np.int64}[kw]
                keys = np.frombuffer(blob[:key_b], kdt).astype(np.int64)
            scales = np.frombuffer(blob[key_b: key_b + scale_b],
                                   np.float32)
            grads = dequantize_blockwise(
                blob[key_b + scale_b:], scales, n, self.dim, bits,
                block=blk)
            self._count_serve(push_frames=1)
        else:
            row_bytes = (4 + self.dim) if comm == "int8" \
                else 4 * self.dim
            if blob is None or len(blob) != n * (8 + row_bytes):
                self._drop("malformed", sender, "bad push blob size")
                return  # malformed frame from a stale run
            keys = np.frombuffer(blob[: 8 * n], np.int64)
            self._count_serve(push_frames=1)
            if comm == "int8":
                scale = np.frombuffer(blob[8 * n: 12 * n], np.float32)
                codes = np.frombuffer(blob[12 * n:], np.int8
                                      ).reshape(n, self.dim)
                grads = dequantize_rows_int8(codes, scale)
            else:
                grads = np.frombuffer(blob[8 * n:], np.float32)
        if self._rb is not None:
            # classify under the CURRENT table: apply what is mine,
            # forward what migrated away, park what outruns my epoch
            self._ingest_push(keys, grads.reshape(n, self.dim),
                              int(payload.get("ep", 0)))
        else:
            offs = keys - self.shard_lo
            if n and (offs.min() < 0
                      or offs.max() >= self.part.shard_size):
                self._drop("misrouted", sender,
                           "push keys outside my range")
                return
            self._apply_rows(offs, grads)  # read-only view: never written
        if "hfr" in payload and self._hier is not None:
            # floor claims ride the SAME frame as the aggregated mass
            # (per-link FIFO: mass applied above before the claim is
            # honored here), then parked pulls re-check admission
            self._hier_merge_floors(payload)
            self.serve_parked()
        if tr is not None:
            # flow finish AFTER validation, next to the apply span: a
            # dropped (misrouted/config/malformed) frame must not draw
            # a completed cross-rank arrow for a discarded gradient
            if payload.get("seq") is not None:
                tr.flow("f", _trc.flow_id(f"push:{self.name}", sender,
                                          int(payload["seq"])), "push")
            tr.complete("push", "push_apply", t_apply0,
                        {"from": sender, "n": n})

    def _handle_push_range(self, sender: int, payload: dict) -> None:
        blob = payload.get("__blob__")
        lo = int(payload.get("lo", -1))
        comm = payload.get("comm", "float32")
        if not self._check_peer_config(sender, payload):
            return
        if blob is None:
            self._drop("malformed", sender, "range push without blob")
            return
        if comm == "int8":
            row_bytes = 4 + self.dim  # f32 scale + int8 codes per row
            if len(blob) % row_bytes:
                self._drop("malformed", sender,
                           "range blob not row-aligned")
                return
            k = len(blob) // row_bytes
            scale = np.frombuffer(blob[: 4 * k], np.float32)
            codes = np.frombuffer(blob[4 * k:], np.int8).reshape(k,
                                                                 self.dim)
            grads = dequantize_rows_int8(codes, scale)
        else:
            # validate BEFORE decoding: a torn frame must land in the
            # malformed-drop accounting, not escape as a raised ValueError
            if len(blob) % (4 * self.dim):
                self._drop("malformed", sender,
                           "range blob not row-aligned")
                return
            grads = np.frombuffer(blob, np.float32)
            k = grads.size // self.dim
        lo_local = lo - self.shard_lo
        if lo_local < 0 or lo_local + k > self.part.shard_size:
            self._drop("misrouted", sender, "range outside my shard")
            return
        self._count_serve(push_frames=1)
        if self._rb is not None and (self.router._overlay
                                     or not self.rebalance_settled()):
            # some of this home range may live elsewhere now: fall back
            # to the keyed ingest (forwards the migrated rows) — range
            # pushes are rare in rebalanced (sparse-hot) workloads, so
            # the key materialization is paid only when it must be
            self._ingest_push(np.arange(lo, lo + k, dtype=np.int64),
                              grads.reshape(k, self.dim),
                              int(payload.get("ep", 0)))
            return
        self._apply_range(lo_local, grads)

    def _on_pull(self, sender: int, payload: dict) -> None:
        blob = payload.get("__blob__")
        req = int(payload.get("req", -1))
        if not self._check_peer_config(sender, payload):
            return  # requester times out loudly; my next tick raises
        if blob is None:
            self._drop("malformed", sender, "pull without key blob")
            return
        keys = np.frombuffer(blob, np.int64)
        clk = int(payload.get("clk", 0))
        ep = int(payload.get("ep", 0))
        if self._sv is not None and not self._sv.admit_request(
                sender, req, keys, payload):
            return  # shed to a replica (svS) or refused loudly (svB)
        if self._rb is not None:
            owners = self.router.shard_of(keys)
            if keys.size and ((owners < 0)
                              | (owners >= self.num_processes)).any():
                self._drop("misrouted", sender,
                           "pull keys outside key space")
                return
            v = self._pull_verdict(keys, ep, owners=owners)
            if v == "refuse":
                self._send_epoch_nack(sender, req)
                return
            admitted = self._admit_clk(clk)
            if v == "park" or not admitted:
                tr = _trc.TRACER
                if tr is not None:
                    tr.instant("serve", "pull_park",
                               {"from": sender, "rid": req, "clk": clk,
                                "why": v if v == "park" else "admission"})
                with self._park_lock:
                    self._parked.append((sender, req, keys, clk, ep,
                                         time.monotonic()))
                # re-check (park/drain race, same as the seed path):
                # adoption/unfence/clock between verdict and append
                # would have drained an empty buffer and never retried
                if self._pull_verdict(keys, ep) == "serve" \
                        and self._admit_clk(clk):
                    self.serve_parked()
                return
            self._serve_pull(sender, req, keys, clk)
            return
        offs = keys - self.shard_lo
        if keys.size and (offs.min() < 0
                          or offs.max() >= self.part.shard_size):
            self._drop("misrouted", sender, "pull keys outside my range")
            return
        if not self._admit_clk(clk):
            tr = _trc.TRACER
            if tr is not None:
                tr.instant("serve", "pull_park",
                           {"from": sender, "rid": req, "clk": clk,
                            "why": "admission"})
            with self._park_lock:  # reference PendingBuffer: park the Get
                self._parked.append((sender, req, keys, clk, 0,
                                     time.monotonic()))
            # re-check: a clock change between the admission test and the
            # append would have drained an empty buffer and never retried
            if self._admit_clk(clk):
                self.serve_parked()
            return
        self._serve_pull(sender, req, keys, clk)

    def _serve_stamp(self, sender: int, clk: int) -> int:
        """The freshness certificate stamped on every pull reply: my view
        of every OTHER worker's applied clock (gossip min excluding the
        requester — its own pushes are certified by per-link FIFO, see
        ClockGossip.min_excluding). The requester's row cache admits the
        delivered rows at a later clock ``c`` iff ``admits(stamp, c, s)``
        — exactly the admission this serve just passed, re-evaluated at
        read time. Falls back to the request clock when no trainer is
        bound (raw-table tests): admission was vacuous there too."""
        sc = getattr(self._cons, "serving_clock", None)
        stamp = int(sc(sender)) if callable(sc) else int(clk)
        fm = self._hier_floor_min()
        if fm is not None:
            # hier contributors' pushes ride two links (member ->
            # leader -> owner), so min_excluding's FIFO self-exemption
            # no longer covers them — the certificate folds the floors,
            # SENDER INCLUDED: its own cross-host mass rides its leader
            stamp = min(stamp, int(fm))
        return stamp

    def _reply_head_blob(self, req: int, rows: np.ndarray) -> tuple:
        """Encode a pull reply on MY configured pull wire. Frames
        self-describe the format (like push frames), so a mixed fleet —
        one owner compressed, another not — decodes correctly per frame;
        the done-line echo + bench assert catch flag-plumbing drift."""
        if self.pull_wire == "int8":
            codes, scale = quantize_rows_int8(rows)  # nearest: no rng
            return ({"req": req, "wire": "int8", "n": rows.shape[0]},
                    _cat_blob(scale, codes))
        # zero-copy: `rows` is always freshly materialized by the serve
        # path (fancy index / .copy()), so the view is alias-safe
        return {"req": req, "wire": "f32"}, _as_blob(
            np.asarray(rows, np.float32))

    def _serve_pull(self, sender: int, req: int, keys: np.ndarray,
                    clk: int = 0) -> None:
        t_serve0 = time.monotonic()
        # stamp BEFORE reading state: the certificate must be a lower
        # bound on what the rows contain, and clocks only advance
        stamp = self._serve_stamp(sender, clk)
        if self._rb is not None:
            # re-verify ownership/fences ATOMICALLY with the read: a
            # concurrent adoption between the caller's verdict and here
            # may have shipped a block away (its xtra gone, or a home
            # block's slab copy now dead) — serving would be stale or
            # crash. A failed re-check re-parks; the parked path
            # re-evaluates (including refusal) on the next event.
            with self._mig_cond:
                owners = self.router.shard_of(keys)
                ok = bool((owners == self.rank).all())
                if ok and (self._fenced or self._pending_state):
                    blocks = {int(x) for x in
                              np.unique(self.router.blocks_of(keys))}
                    ok = not (blocks & (self._fenced.keys()
                                        | self._pending_state.keys()))
                if ok:
                    with self._state_lock:
                        rows = self._read_rows_locked(keys)
            if not ok:
                with self._park_lock:
                    self._parked.append((sender, req, keys, clk, 0,
                                         time.monotonic()))
                self.serve_parked()
                return
            self._heat.touch(self.router.blocks_of(keys))
        else:
            offs = keys - self.shard_lo
            with self._state_lock:
                rows = self._w[offs]  # fancy indexing: a fresh array
            if self._heat is not None:  # serve plane armed, rb off
                self._heat.touch(self.router.blocks_of(keys))
        self._count_serve(pull_requests=1, pull_rows=keys.size)
        head, blob = self._reply_head_blob(req, rows)
        head["stamp"] = stamp
        acks = self._drain_acks_for(sender)
        if acks:
            head["acks"] = acks  # piggyback: the free ack ride home
        self.bus.send(sender, f"psr:{self.name}", head, blob=blob)
        self.hist_serve.record_s(time.monotonic() - t_serve0)
        tr = _trc.TRACER
        if tr is not None:
            # the flow finish pairs with the requester's 's' event —
            # both derive the id from (requester rank, wire rid)
            tr.flow("f", _trc.flow_id(f"pull:{self.name}", sender, req),
                    "pull")
            tr.complete("serve", "serve_pull", t_serve0,
                        {"from": sender, "rid": req,
                         "rows": int(keys.size), "stamp": stamp})

    def _on_pull_all(self, sender: int, payload: dict) -> None:
        req = int(payload.get("req", -1))
        if not self._check_peer_config(sender, payload):
            return  # requester times out loudly; my next tick raises
        clk = int(payload.get("clk", 0))
        ep = int(payload.get("ep", 0))
        admitted = self._admit_clk(clk)
        parked = not admitted or (
            self._rb is not None
            and self._pull_all_verdict(ep) == "park")
        if parked:
            # a shard assembly must not ship while a migrated block is
            # in transit: the live copy would be on neither side
            with self._park_lock:
                self._parked.append((sender, req, None, clk, ep,
                                     time.monotonic()))
            if self._admit_clk(clk) and (
                    self._rb is None
                    or self._pull_all_verdict(ep) == "serve"):
                self.serve_parked()  # park/drain race, as above
            return
        self._serve_pull_all(sender, req, clk)

    def _serve_pull_all(self, sender: int, req: int,
                        clk: int = 0) -> None:
        t_serve0 = time.monotonic()
        stamp = self._serve_stamp(sender, clk)
        xb: list[int] = []
        xl: list[int] = []
        if self._rb is not None:
            # settled-check ATOMIC with the read (same race as
            # _serve_pull): a block shipping away between the caller's
            # verdict and this copy would vanish from every reply
            with self._mig_cond:
                ok = not (self._fenced or self._pending_state)
                if ok:
                    with self._state_lock:
                        rows = self._w.copy()
                        if self._xtra:
                            # migrated-in blocks ride along after the
                            # base shard; the assembler overlays them
                            # over every (stale) home copy in pass 2
                            parts = [rows]
                            for b in sorted(self._xtra):
                                arr = self._xtra[b]["w"]
                                xb.append(int(b))
                                xl.append(int(arr.shape[0]))
                                parts.append(arr.copy())
                            rows = np.concatenate(parts)
            if not ok:
                with self._park_lock:
                    self._parked.append((sender, req, None, clk, 0,
                                         time.monotonic()))
                self.serve_parked()
                return
        else:
            with self._state_lock:
                rows = self._w.copy()  # full shard: copy out of the lock
        self._count_serve(pull_requests=1, pull_rows=rows.shape[0])
        head, blob = self._reply_head_blob(req, rows)
        head["lo"] = self.shard_lo
        head["nb"] = int(self.part.shard_size)
        if xb:
            head["xb"] = xb
            head["xl"] = xl
        head["stamp"] = stamp
        acks = self._drain_acks_for(sender)
        if acks:
            head["acks"] = acks
        self.bus.send(sender, f"psr:{self.name}", head, blob=blob)
        self.hist_serve.record_s(time.monotonic() - t_serve0)
        tr = _trc.TRACER
        if tr is not None:
            tr.flow("f", _trc.flow_id(f"pull:{self.name}", sender, req),
                    "pull")
            tr.complete("serve", "serve_pull_all", t_serve0,
                        {"from": sender, "rid": req,
                         "rows": int(rows.shape[0])})

    def serve_parked(self) -> None:
        """Re-check parked pulls against the admission rule — called by the
        trainer on every clock/exclusion change (the PendingBuffer drain,
        reference ``Clock → may unpark others' Gets``, SURVEY.md §3.3).
        Also the opportunistic ack-drain point: flush my pending ack
        batches (liveness when no pull reply is flowing to piggyback
        on) and wake any window/drain waiter so in-flight accounting is
        re-read at every clock event, not only when an ack frame
        lands."""
        if self.bus is not None:
            self._flush_acks()
        with self._push_cond:
            self._push_cond.notify_all()
        self._maybe_release_fences(self.router.epoch)  # exclusions advance
        if self._cons is None and self._rb is None \
                and not self._hier_floor:
            return
        # admission is evaluated ONCE per entry: global_min advances
        # concurrently, and a flip between two evaluations must not let an
        # entry fall between "not ready" and "not kept". With the
        # rebalancer on, an entry additionally waits for its blocks'
        # fences — and a parked slice whose keys MOVED AWAY while it
        # waited is refused with the new table instead of served wrong.
        with self._park_lock:
            ready, still, refuse = [], [], []
            for p in self._parked:
                admitted = self._admit_clk(p[3])
                if self._rb is not None:
                    v = (self._pull_all_verdict(p[4]) if p[2] is None
                         else self._pull_verdict(p[2], p[4]))
                    if v == "refuse":
                        refuse.append(p)
                        continue
                    if v == "park" or not admitted:
                        still.append(p)
                        continue
                elif not admitted:
                    still.append(p)
                    continue
                ready.append(p)
            self._parked = still
        # park-duration accounting happens at UNPARK (serve or refuse):
        # a parked request's cost is the time it sat, however it left
        now = time.monotonic()
        tr = _trc.TRACER
        for sender, req, _keys, _clk, _ep, t_park in refuse:
            self.hist_park.record_s(now - t_park)
            if tr is not None:
                tr.complete("serve", "parked", t_park,
                            {"from": sender, "rid": req,
                             "why": "refused"}, t1=now)
            self._send_epoch_nack(sender, req)
        for sender, req, keys, clk, _ep, t_park in ready:
            self.hist_park.record_s(now - t_park)
            if tr is not None:
                tr.complete("serve", "parked", t_park,
                            {"from": sender, "rid": req,
                             "why": "served"}, t1=now)
            if keys is None:
                self._serve_pull_all(sender, req, clk)
            else:
                self._serve_pull(sender, req, keys, clk)

    def _on_pull_reply(self, sender: int, payload: dict) -> None:
        acks = payload.get("acks")
        if acks:  # piggybacked push acks: settle before anything else
            self._settle_acks(acks)
        blob = payload.get("__blob__")
        rid = int(payload.get("req", -1))
        if blob is None:
            self._drop("malformed", sender, "pull reply without blob")
            return
        wire = payload.get("wire", "f32")
        if wire == "int8":
            n = int(payload.get("n", 0))
            if len(blob) != n * (4 + self.dim):
                self._drop("malformed", sender, "bad int8 reply size")
                return
            scale = np.frombuffer(blob[: 4 * n], np.float32)
            codes = np.frombuffer(blob[4 * n:], np.int8).reshape(n,
                                                                 self.dim)
            rows = dequantize_rows_int8(codes, scale)
        else:
            if len(blob) % (4 * self.dim):
                self._drop("malformed", sender, "bad f32 reply size")
                return
            rows = np.frombuffer(blob, np.float32).reshape(-1, self.dim)
        leg = None
        hedge_role = None  # "won" (hedge beat the owner) | "lost"
        with self._reply_cond:
            gid = self._rid_gid.get(rid)
            if gid is None or gid not in self._replies:
                # straggler past its group's death: the stashed issue
                # stamp (if any) turns it into the slowness sample it
                # is — the slow owner's true round trip, which the
                # hedge that out-raced it must not erase
                leg = self._late_t0.pop(rid, None)
            if gid is not None and gid in self._replies:
                # wire accounting counts ACTUAL bytes received
                # (compressed when compressed) — the pull leg's half of
                # bytes/row-moved. Under the lock (the issue side bumps
                # the same counter from the training thread) and only
                # for live requests: a late reply to a cancelled
                # prefetch must not inflate the counter. A loopback
                # reply (self-shed svP, sender == me) crossed no wire.
                # A hedged pair's LOSER still crossed the wire — both
                # replies' bytes count; that duplication IS the cost
                # hedging pays and the B/row accounting must show it.
                if sender != self.rank:
                    self.bytes_pulled += len(blob)
                # hedged legs: the hedge rid maps back to its PRIMARY
                # leg — the reply (whichever wing it rode) satisfies
                # the primary slot. First-ADMISSIBLE-reply-wins is
                # first-reply-wins here: owners park and replicas
                # refuse until `gate.admits` holds, so any reply that
                # exists is admissible; the second one is the loser,
                # discarded by its rid.
                grp = self._groups.get(gid)
                hmap = grp.get("hedges") if grp is not None else None
                prim = hmap.get(rid, rid) if hmap else rid
                leg = self._leg_t0.pop(rid, None)
                if prim in self._replies[gid]:
                    self._rid_gid.pop(rid, None)
                    self._hedges_live.discard(rid)
                    if leg is not None and hmap \
                            and (rid in hmap
                                 or prim in (grp.get("hedged") or ())):
                        # the hedged pair's second wing — discarded by
                        # rid, counted AT MOST ONCE per pair: `leg`
                        # non-None means this is the wing's FIRST
                        # arrival (the t0 stamp pops exactly once), so
                        # a chaos-DUPLICATED reply of either wing can
                        # never inflate `lost` past `fired`.
                        self.hedge_counters["lost"] += 1
                        hedge_role = "lost"
                else:
                    self._replies[gid][prim] = (
                        rows, int(payload.get("stamp", 0)), payload)
                    self._reply_t[gid] = time.monotonic()
                    if prim != rid:
                        self._hedges_live.discard(rid)
                        self.hedge_counters["won"] += 1
                        hedge_role = "won"
                    self._reply_cond.notify_all()
        if leg is not None:
            if self._slowness is not None and sender != self.rank:
                # the per-peer service-latency feed: issue -> reply,
                # attributed to the rank that actually replied (a
                # hedged pair feeds BOTH wings — the slow owner's
                # eventual reply records the true tail that indicts it)
                self._slowness.note(sender, time.monotonic() - leg[0])
            tr = _trc.TRACER
            if tr is not None:
                tr.complete("pull", "pull_leg", leg[0],
                            {"owner": leg[1], "rid": rid,
                             "bytes": len(blob),
                             **({"hedge": hedge_role}
                                if hedge_role else {})})

    def _on_epoch_nack(self, sender: int, payload: dict) -> None:
        """Client side of the pull-leg epoch fence: the owner I routed a
        slice to no longer owns some of its keys — it refused the WHOLE
        leg and sent its routing table. The leg re-routes IMMEDIATELY
        using the refusal's table (progress must not wait for my next
        tick), but table ADOPTION itself is deferred to the training
        thread (tick / finalize / the pull-wait poll): adoption sends
        the rbA whose per-link ordering promises 'no more stale pushes
        from me', and this handler runs on the bus receive thread —
        concurrent with a possibly mid-flight old-table push send, so
        an ack from HERE could overtake that push and release a fence
        early. Keys the new table makes LOCAL join the group's
        extra-local set and are read at wait() time, under the same
        fence rules."""
        rid = int(payload.get("req", -1))
        ep = int(payload.get("ep", 0))
        ov = {int(b): int(o) for b, o in
              zip(payload.get("ovb", ()), payload.get("ovo", ()))}
        if self._rb is not None and ep > self.router.epoch:
            note = getattr(self._rb, "note_plan", None)
            if note is not None:
                note(self.name, ep, ov)  # training thread adopts it
        sends: list[tuple[int, int, int, np.ndarray]] = []
        tr = _trc.TRACER
        with self._reply_cond:
            gid = self._rid_gid.pop(rid, None)
            self._leg_t0.pop(rid, None)  # refused leg: span abandoned
            self._hedges_live.discard(rid)  # a refused hedge twin's
            #                                 budget slot frees here
            grp = self._groups.get(gid) if gid is not None else None
            if grp is None:
                return  # finished/cancelled group: nothing to re-route
            leg = grp["legs"].pop(rid, None)
            if leg is None:
                return
            _old_owner, idx = leg
            keys = grp["uniq"][idx]
            if ep >= self.router.epoch:  # route by the fresher table
                owners = self.router.shard_of_with(keys, ov)
            else:
                owners = self._owners_of(keys)
            for o in np.unique(owners):
                m = owners == o
                if o == self.rank:
                    grp["extra_local"].append(idx[m])
                    continue
                rid2 = self._next_req()
                grp["legs"][rid2] = (int(o), idx[m])
                self._rid_gid[rid2] = gid
                self.bytes_pulled += keys[m].nbytes
                self._leg_t0[rid2] = (time.monotonic(), int(o))
                sends.append((int(o), rid2, grp["clk"], keys[m]))
            self._reply_cond.notify_all()
        if tr is not None:
            tr.instant("serve", "pull_releg",
                       {"rid": rid, "ep": ep, "relegs": len(sends)})
        for o, rid2, clk, kslice in sends:
            if tr is not None:
                tr.flow("s",
                        _trc.flow_id(f"pull:{self.name}",
                                     self.rank, rid2),
                        "pull", {"owner": o, "rid": rid2})
            self.bus.send(o, f"psG:{self.name}",
                          {"req": rid2, "clk": clk, **self._ep_header(),
                           **self._cfg_header()}, blob=_as_blob(kslice))

    def _resend_leg(self, rid: int, plan) -> None:
        """Detach live wire leg ``rid`` (no reply yet) and re-issue its
        keys as fresh legs — the serving plane's fallback/redirect
        primitive (the epoch-nack re-router above is the hand-rolled
        sibling). ``plan(keys) -> [(target, kind, extra_head, mask)]``
        with boolean masks partitioning the leg's keys; a target equal
        to this rank joins the group's extra-local set and is read at
        ``wait()``. A leg already answered/cancelled is a no-op (late
        svB timers, crossed refusals)."""
        sends: list[tuple] = []
        tr = _trc.TRACER
        with self._reply_cond:
            gid = self._rid_gid.pop(rid, None)
            self._leg_t0.pop(rid, None)
            self._hedges_live.discard(rid)  # an svN-refused hedge twin
            #                                 dies here (leg is None
            #                                 below — primary still out)
            grp = self._groups.get(gid) if gid is not None else None
            if grp is None:
                return
            leg = grp["legs"].pop(rid, None)
            if leg is None:
                return
            _old, idx = leg
            keys = grp["uniq"][idx]
            for target, kind, extra, mask in plan(keys):
                if not mask.any():
                    continue
                if target == self.rank and kind == "psG":
                    # owner reads of my own shard never need a frame;
                    # a non-psG self target (the serve plane's svP
                    # self-shed) is a REAL leg riding the transport's
                    # in-process loopback lane — the plan only names
                    # it on a loopback-capable bus
                    grp["extra_local"].append(idx[mask])
                    continue
                rid2 = self._next_req()
                grp["legs"][rid2] = (int(target), idx[mask])
                self._rid_gid[rid2] = gid
                if target != self.rank:  # loopback legs cross no wire
                    self.bytes_pulled += keys[mask].nbytes
                self._leg_t0[rid2] = (time.monotonic(), int(target))
                sends.append((int(target), kind, rid2, grp["clk"],
                              keys[mask], extra))
            self._reply_cond.notify_all()
        for target, kind, rid2, clk, kslice, extra in sends:
            if tr is not None:
                tr.flow("s", _trc.flow_id(f"pull:{self.name}",
                                          self.rank, rid2),
                        "pull", {"owner": target, "rid": rid2})
            self.bus.send(target, f"{kind}:{self.name}",
                          {"req": rid2, "clk": clk, **extra,
                           **self._ep_header(), **self._cfg_header()},
                          blob=_as_blob(kslice))

    # --------------------------------------------------------- client side
    def bind_consistency(self, cons) -> None:
        """Attach the trainer's admission rule (server-side SSP gate)."""
        self._cons = cons

    @property
    def frames_dropped(self) -> int:
        return sum(self.drops.values())

    def check_fatal(self) -> None:
        """Raise if a config-mismatched peer frame poisoned this table —
        called from the trainer's tick so a bad relaunch fails within one
        step instead of silently discarding that peer's gradients.
        Flight: RECORD-only (no dump) — this runs under _push_cond in
        the enqueue backpressure loop, and the raise propagates to a
        path that dumps lock-free (finalize's dump_now, atexit)."""
        if self._fatal is not None:
            _fl.record("table_fatal",
                       {"table": self.name, "why": self._fatal[:200]})
            raise RuntimeError(self._fatal)

    def _my_clk(self) -> int:
        return self._cons.clock if self._cons is not None else 0

    def _cache_staleness(self) -> float:
        """The staleness bound the cache's validity predicate runs under
        — the TENANT's own ``s`` when one is spec'd (every per-table
        consumer routes through here: cache validity, replica serve
        admission, reply-stamp staleness accounting), else the
        trainer's; 0 (BSP, the strictest) when none is bound."""
        if self._tenant is not None and self._tenant.s is not None:
            return self._tenant.s
        return getattr(self._cons, "staleness", 0) \
            if self._cons is not None else 0

    def cache_age(self) -> None:
        """Drop cache rows that can never be admitted again (tick)."""
        if self._cache is not None:
            self._cache.age(self._my_clk(), self._cache_staleness())

    def cache_clear(self) -> None:
        """Drop the whole cache (finalize: post-finalize agreement is
        exact, not staleness-bounded — a cached row must not outlive
        the quiesce)."""
        if self._cache is not None:
            self._cache.clear()

    def cache_stats(self) -> Optional[dict]:
        return self._cache.stats() if self._cache is not None else None

    def _cache_on_push(self, keys: np.ndarray, deltas: np.ndarray,
                       sorted_keys: np.ndarray) -> None:
        """Keep read-your-own-writes across the cache, ON THE PUSHING
        THREAD (before an async enqueue — a pull issued right after
        push() must already see the maintenance). ``keys``/``deltas``
        are the aligned unique pairs ``push()`` computed (summed when
        the batch had duplicates, the original pairing when it did
        not); ``sorted_keys`` is the same key set sorted, for the
        journal. sgd over a float32 DEDUPED push wire write-throughs
        the exact additive delta the server will apply (the SAME
        summed rows ride the wire, so cache and server move in bitwise
        lock-step); stateful updaters, quantized pushes, and the
        per-occurrence wire (``push_dedup=False`` — the server re-sums
        in f32 there, last-ulp different from our f64 bincount)
        invalidate instead — the client cannot reproduce the server's
        step bit-for-bit. Every op is journaled in the push log so
        in-flight pulls' inserts can drop the keys it touched (see
        __init__)."""
        if self.updater == "sgd" and self.push_comm == "float32" \
                and self.push_dedup:
            self._cache.write_through(keys, -self.lr * deltas)
        else:
            self._cache.invalidate(keys)
        with self._cache_log_lock:
            if self._cache_open:  # journal only while pulls in flight
                self._cache_log.append((self._cache_epoch, sorted_keys))
                if len(self._cache_log) > 1024:
                    # leaked futures (never waited/cancelled) would pin
                    # the log forever; drop it and poison pre-floor
                    # inserts instead (they skip — safe, just cold)
                    self._cache_log.clear()
                    self._cache_broken_floor = self._cache_epoch
            self._cache_epoch += 1

    def _cache_note_issue(self, fut: "PullFuture") -> None:
        with self._cache_log_lock:
            fut._issue_epoch = self._cache_epoch
            self._cache_open[id(fut)] = self._cache_epoch

    def _cache_close_issue(self, fut: "PullFuture") -> None:
        with self._cache_log_lock:
            self._cache_open.pop(id(fut), None)
            floor = min(self._cache_open.values(),
                        default=self._cache_epoch)
            self._cache_log = [e for e in self._cache_log
                               if e[0] >= floor]

    def _cache_insert_guarded(self, fut: "PullFuture", keys: np.ndarray,
                              rows: np.ndarray, stamp: int) -> None:
        """Insert freshly-fetched rows, DROPPING any key a push touched
        between the pull's issue and now: the reply may predate the
        push at the owner (immediate serve) or already include it
        (parked serve after the push applied) — the client cannot tell
        which, so the ambiguous row is not cached at all. The future's
        RESULT is untouched (a pull returns whatever the owner served);
        only the cache refuses rows it cannot certify."""
        with self._cache_log_lock:
            if fut._issue_epoch <= self._cache_broken_floor:
                return  # log overflowed past this pull: no safe insert
            entries = [e for e in self._cache_log
                       if e[0] >= fut._issue_epoch]
        if entries:
            keep = np.ones(keys.size, bool)
            for _, ek in entries:  # ek sorted unique (np.unique)
                pos = np.clip(np.searchsorted(ek, keys), 0, ek.size - 1)
                keep &= ek[pos] != keys
            if not keep.any():
                return
            if not keep.all():
                keys, rows = keys[keep], rows[keep]
        self._cache.insert(keys, rows, stamp)
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("pull", "cache_insert",
                       {"n": int(keys.size), "stamp": int(stamp)})

    def _next_req(self) -> int:
        with self._req_lock:
            self._req += 1
            return self._req

    def _missing_legs_locked(self, gid: int) -> dict[int, int]:
        """Outstanding legs of a pull group: ``rid -> target`` for
        every leg without a reply. Own-shard reads never REGISTER a leg
        (they ride ``extra_local``), so a registered self-rank leg here
        is a loopback leg (the serve plane's svP self-shed) and is
        awaited like any other. Caller holds the reply cond."""
        grp = self._groups.get(gid)
        if grp is None:
            return {}
        got = self._replies.get(gid, {})
        return {rid: o for rid, (o, _i) in grp["legs"].items()
                if rid not in got}

    def _release_hedges_locked(self, grp: dict) -> None:
        """Drop a dying/completed group's hedge twins: a hedge whose
        reply never came must release its budget slot and its rid
        mapping (a late reply then drops at the gid lookup, the same
        path as any post-cleanup straggler). Caller holds the cond."""
        for hrid in grp.get("hedges") or ():
            self._rid_gid.pop(hrid, None)
            self._stash_late_locked(hrid)
            self._leg_t0.pop(hrid, None)
            self._hedges_live.discard(hrid)

    def _stash_late_locked(self, rid: int) -> None:
        """Keep an unanswered leg's issue stamp past its group's death
        so the LATE reply still feeds the slowness monitor (the slow
        owner's true round trip — see ``_late_t0``). Bounded: oldest
        evicted; only armed when a detector is bound."""
        if self._slowness is None:
            return
        t0 = self._leg_t0.get(rid)
        if t0 is None:
            return
        if len(self._late_t0) >= 512:
            self._late_t0.pop(next(iter(self._late_t0)))
        self._late_t0[rid] = t0

    def _cleanup_group_locked(self, gid: int) -> None:
        self._replies.pop(gid, None)
        self._reply_t.pop(gid, None)
        grp = self._groups.pop(gid, None)
        if grp is not None:
            for rid in grp["legs"]:
                self._rid_gid.pop(rid, None)
                self._stash_late_locked(rid)
                self._leg_t0.pop(rid, None)
            self._release_hedges_locked(grp)

    def _take_group(self, gid: int) -> tuple[dict, list]:
        """Detach a completed group's final leg map + extra-local idx
        lists (the psE re-router may have reshaped both since issue)."""
        with self._reply_cond:
            grp = self._groups.pop(gid, None)
            if grp is None:
                return {}, []
            for rid in grp["legs"]:
                self._rid_gid.pop(rid, None)
                # a leg whose slot was satisfied by its hedge twin has
                # NOT replied itself — keep its stamp for the late
                # reply (still in _leg_t0 iff unanswered)
                self._stash_late_locked(rid)
                self._leg_t0.pop(rid, None)
            self._release_hedges_locked(grp)
            return grp["legs"], grp["extra_local"]

    # ------------------------------------------------------- hedged legs
    def _hedge_delay_s(self) -> float:
        """The hedge delay: a fixed ``delay_ms`` when pinned, else the
        p99-derived delay — ``factor`` x the WINDOWED pull-latency p99
        (obs/window.py via the bound trainer), floored at ``min_ms``.
        The floor is what keeps armed-idle runs hedge-free: loopback
        legs answer orders of magnitude under it (SLOW-IDLE)."""
        cfg = self._hedge
        if cfg.delay_ms > 0:
            return cfg.delay_ms / 1e3
        p99 = None
        ow = getattr(self._cons, "obs_window", None)
        if ow is not None:
            p99 = ow.quantile_ms("pull_latency", 0.99)
        if p99 is None:
            return cfg.min_ms / 1e3
        return max(cfg.min_ms, cfg.factor * p99) / 1e3

    def _slow_verdicts(self) -> set[int]:
        """Current fleet slow verdicts (quorum-corroborated, membership
        plane) — a leg aimed at one hedges at the ``min_ms`` FLOOR
        instead of the p99-derived delay (which the sick rank's own
        tail has inflated). Not at zero: a hedge fired the instant of
        issue races the holder's refresh stamp and buys a guaranteed
        svN refusal + fallback (measured — the verdicted arm's p99
        went BACK to the unmitigated tail). Empty without the
        membership plane."""
        mb = self._mb
        if mb is None:
            return set()
        view = getattr(mb, "slow_view", None)
        return view() if view is not None else set()

    def _hedge_due(self, t0: float, target: int, delay: float,
                   slow: set) -> float:
        if target in slow:
            return t0 + min(delay, self._hedge.min_ms / 1e3)
        return t0 + delay

    def _maybe_hedge(self, gid: int) -> None:
        """Fire hedges for this group's overdue legs. Runs ONLY from
        the pull-wait loop (training/reader thread) — never the bus
        receive thread. One hedge per leg, ``budget`` outstanding per
        table; a leg with no replica holder covering its blocks stays
        unhedged (counted — the honest no-replica limit). With NO
        serve plane attached every overdue leg takes the no_holder
        path — marked, counted, never re-probed — so the wait loop
        cannot busy-wake at the 1ms floor forever."""
        sv = self._sv
        cfg = self._hedge
        now = time.monotonic()
        delay = self._hedge_delay_s()
        slow = self._slow_verdicts()
        sends: list[tuple] = []
        tr = _trc.TRACER
        with self._reply_cond:
            grp = self._groups.get(gid)
            if grp is None or grp.get("uniq") is None:
                return  # gone, or a pull_all group (no key space)
            hedged = grp.setdefault("hedged", set())
            hmap = grp.setdefault("hedges", {})
            got = self._replies.get(gid, {})
            for rid, (target, idx) in list(grp["legs"].items()):
                if rid in got or rid in hedged or rid in hmap:
                    continue  # answered, already hedged, or IS a hedge
                t0 = self._leg_t0.get(rid)
                if t0 is None:
                    continue
                due = self._hedge_due(t0[0], target, delay, slow)
                if now < due:
                    continue
                if len(self._hedges_live) >= cfg.budget:
                    # the budget valve is a LOAD SHED, not a queue:
                    # the denied leg is marked hedged (counted once,
                    # never re-probed) — leaving it eligible would
                    # busy-wake the wait loop at the 1ms floor and
                    # inflate `denied` into a wake count
                    self.hedge_counters["denied"] += 1
                    if self._tenant_tid:
                        with self._serve_lock:
                            self.tenant_counters["hedge_denied"] += 1
                    hedged.add(rid)
                    continue
                keys = grp["uniq"][idx]
                holder = (sv.hedge_holder(
                    keys, exclude={int(target), self.rank})
                    if sv is not None else None)
                if holder is None:
                    self.hedge_counters["no_holder"] += 1
                    hedged.add(rid)  # don't re-probe every wake
                    continue
                rid2 = self._next_req()
                hmap[rid2] = rid
                hedged.add(rid)
                self._rid_gid[rid2] = gid
                self._hedges_live.add(rid2)
                self._leg_t0[rid2] = (now, int(holder))
                self.bytes_pulled += keys.nbytes
                self.hedge_counters["fired"] += 1
                sends.append((int(holder), rid2, grp["clk"], keys,
                              int(target)))
        for holder, rid2, clk, kslice, slow_tgt in sends:
            # the hedge rides the svP wire under the SAME clk stamp as
            # the primary — the holder's `admits(stamp, clk, s)` is the
            # identical predicate the owner's park runs, so whichever
            # reply wins satisfies the same staleness bound
            _fl_rec = _fl.FLIGHT
            if _fl_rec is not None:
                fired = self.hedge_counters["fired"]
                if fired <= 8 or fired % 32 == 0:
                    # sampled like sv_shed: a long drill's hedges must
                    # not rotate the post-mortem ring, the cumulative
                    # count in each entry carries the true volume
                    _fl_rec.ev("hedge_fired",
                               {"table": self.name, "owner": slow_tgt,
                                "holder": holder, "rid": rid2,
                                "fired_total": fired})
            if tr is not None:
                tr.instant("pull", "hedge_fired",
                           {"owner": slow_tgt, "holder": holder,
                            "rid": rid2})
                tr.flow("s", _trc.flow_id(f"pull:{self.name}",
                                          self.rank, rid2),
                        "pull", {"owner": holder, "rid": rid2})
            self.bus.send(holder, f"svP:{self.name}",
                          {"req": rid2, "clk": clk,
                           **self._ep_header(), **self._cfg_header()},
                          blob=_as_blob(kslice))

    def _hedge_wait_s(self, gid: int) -> float:
        """Time until the EARLIEST unhedged leg of ``gid`` comes due —
        the wait-loop's timeout so a hedge fires on schedule instead
        of at the next 0.5 s poll. Caller holds the reply cond."""
        grp = self._groups.get(gid)
        if grp is None or grp.get("uniq") is None:
            return 0.5
        delay = self._hedge_delay_s()
        slow = self._slow_verdicts()
        got = self._replies.get(gid, {})
        hedged = grp.get("hedged") or ()
        hmap = grp.get("hedges") or {}
        now = time.monotonic()
        best = 0.5
        for rid, (target, _idx) in grp["legs"].items():
            if rid in got or rid in hedged or rid in hmap:
                continue
            t0 = self._leg_t0.get(rid)
            if t0 is None:
                continue
            due = self._hedge_due(t0[0], target, delay, slow)
            best = min(best, max(due - now, 0.001))
        return best

    def _await_replies(self, gid: int,
                       timeout: Optional[float] = None) -> dict:
        deadline = time.monotonic() + (self.pull_timeout
                                       if timeout is None else timeout)
        while True:
            with self._reply_cond:
                if not self._missing_legs_locked(gid):
                    return self._replies.pop(gid)
                self._reply_cond.wait(
                    timeout=(self._hedge_wait_s(gid)
                             if self._hedge is not None else 0.5))
                miss = self._missing_legs_locked(gid)
                if not miss:
                    return self._replies.pop(gid)
                owners = set(miss.values())
            if self._hedge is not None:
                # hedge overdue legs BEFORE the adoption/death checks:
                # this thread is the pull waiter (training or storm
                # reader), never the bus receive thread — the send-from-
                # recv-thread deadlock class stays impossible here
                self._maybe_hedge(gid)
            # ---- lock released: adoption / monitor / deadline. This
            # runs on the TRAINING thread — the one context where table
            # adoption is race-free against the push path — and a
            # refused leg re-routed mid-migration may be PARKED at its
            # new owner waiting for exactly this rank's adoption ack,
            # so the wait loop must adopt pending plans to make
            # progress (not only tick())
            if self._rb is not None:
                self._rb.adopt_now()
            if self._mb is not None:
                self._mb.poll()  # coordinator: issue a blocking death
            self._hier_poll()  # leader death mid-pull: fall back here
            dead = (set(self.monitor.check())
                    if self.monitor is not None else set())
            dead_owned = dead & owners
            if dead_owned:
                fatal = self._fatal_dead(dead_owned)
                if fatal:
                    with self._reply_cond:
                        self._cleanup_group_locked(gid)
                    _fl.poison("pull_peer_failure",
                               {"table": self.name,
                                "dead": sorted(fatal)})
                    raise PeerFailureError(fatal)
                # survivable death (elastic membership): once the death
                # plan re-homed the corpse's keys, its legs re-issue by
                # the current table; until then keep waiting (bounded
                # by this wait's own deadline)
                self._reroute_dead_legs(gid, dead_owned)
            if time.monotonic() > deadline:
                with self._reply_cond:
                    self._cleanup_group_locked(gid)
                _fl.poison("pull_deadline",
                           {"table": self.name,
                            "owners": sorted(int(o) for o in owners)})
                raise TimeoutError(
                    f"pull({self.name}): owners {sorted(owners)} "
                    "never replied")

    def _read_local(self, gkeys: np.ndarray, clk: int,
                    timeout: Optional[float] = None) -> np.ndarray:
        """Read rows of ``gkeys`` from the LOCAL shard (PullFuture's
        local leg). Seed path: a direct slab gather. With the
        rebalancer on this must honor the same rules a remote owner
        would: blocks fenced or state-pending WAIT (a fenced serve
        could be staler than the bound), and keys that migrated AWAY
        since issue round-trip to their current owner."""
        if self._rb is None:
            self._count_serve(pull_rows=gkeys.size)
            with self._state_lock:
                return self._w[gkeys - self.shard_lo]
        deadline = time.monotonic() + (self.pull_timeout
                                       if timeout is None else timeout)
        t_fence0: Optional[float] = None  # first time the read blocked

        def _trace_fence_wait() -> None:
            tr = _trc.TRACER
            if tr is not None and t_fence0 is not None:
                tr.complete("pull", "fence_wait", t_fence0,
                            {"n": int(gkeys.size)})
        while True:
            # adopt pending plans BEFORE re-evaluating fences (outside
            # the cond — adopt_table takes it): a fence whose releaser
            # died opens only at the death plan's adoption, and that
            # adoption happens on this thread; both calls are no-ops
            # off the driving thread / with nothing pending
            if self._rb is not None:
                self._rb.adopt_now()
            if self._mb is not None:
                self._mb.poll()
            with self._mig_cond:
                owners = self.router.shard_of(gkeys)
                mine = owners == self.rank
                blocked = False
                if mine.any() and (self._fenced or self._pending_state):
                    bl = {int(x) for x in
                          np.unique(self.router.blocks_of(gkeys[mine]))}
                    blocked = bool(bl & (self._fenced.keys()
                                         | self._pending_state.keys()))
                if blocked:
                    if t_fence0 is None:
                        t_fence0 = time.monotonic()
                    if time.monotonic() > deadline:
                        _trace_fence_wait()
                        break  # poison + raise BELOW, outside the lock
                    self._mig_cond.wait(timeout=0.1)
                    continue
                if mine.all():
                    _trace_fence_wait()
                    self._count_serve(pull_rows=gkeys.size)
                    self._heat.touch(self.router.blocks_of(gkeys))
                    with self._state_lock:
                        return self._read_rows_locked(gkeys)
            _trace_fence_wait()
            t_fence0 = None
            # some keys are not mine under MY CURRENT table. Two very
            # different cases hide here:
            #
            # (a) my table is BEHIND — a psE refusal re-routed these
            #     keys into the local set under a PENDING newer table
            #     this rank has not adopted yet. Re-issuing now would
            #     route by the stale table, be refused straight back
            #     into this local set, and recurse without bound (the
            #     wait->_read_local->wait mutual recursion blew the
            #     stack under the serving plane's replica-miss
            #     traffic, which hits this window constantly). Adopt
            #     the pending plan first (push-driving thread), or
            #     WAIT for the driving thread's adoption (reader
            #     threads — adopt_now is thread-guarded), then
            #     re-evaluate ownership.
            # (b) the keys genuinely migrated away since issue and my
            #     table is current: round-trip to the real owner.
            if self._rb is not None:
                self._rb.adopt_now()  # no-op off the driving thread
                pend = getattr(self._rb, "has_pending", None)
                if pend is not None and pend(self.name):
                    if time.monotonic() > deadline:
                        _fl.poison("adopt_deadline",
                                   {"table": self.name})
                        raise TimeoutError(
                            f"pull({self.name}): routing table "
                            "adoption never caught up mid-migration")
                    time.sleep(0.005)
                    continue
                with self._mig_cond:
                    if not np.array_equal(
                            self.router.shard_of(gkeys), owners):
                        continue  # adoption changed routing: re-check
            out = np.empty((gkeys.size, self.dim), np.float32)
            out[~mine] = self._issue_pull(gkeys[~mine], clk).wait(
                timeout=max(deadline - time.monotonic(), 0.1))
            out[mine] = self._read_local(gkeys[mine], clk,
                                         max(deadline - time.monotonic(),
                                             0.1))
            return out
        # only the fence-deadline break reaches here — the flight dump
        # (file I/O + the windowed snapshot hook) must not run under
        # _mig_cond: a reliable-dispatched handler may be waiting on it
        _fl.poison("fence_deadline", {"table": self.name})
        raise TimeoutError(
            f"pull({self.name}): local rows fenced mid-migration and "
            "never released")

    def _wait_local_admission(self, clk: int,
                              timeout: Optional[float] = None) -> None:
        """Block until MY admission view serves clock ``clk`` — the local
        shard's twin of the owner-side park. Synchronous pulls pass
        instantly (their gate already waited); prefetches stamped ahead
        wait here only if consumed before the staleness rule catches up."""
        if self._admit_clk(clk):
            return
        wait_fn = getattr(self._cons, "wait_admit_pull", None)
        deadline = time.monotonic() + (self.pull_timeout
                                       if timeout is None else timeout)
        while not self._admit_clk(clk):
            self._hier_poll()  # a dead leader blocks floors, not clocks
            if wait_fn is not None and not (
                    self._cons is None or self._cons.admit_pull(clk)):
                wait_fn(clk, timeout=0.5)
            else:
                # the gossip min already admits — the hier floor is the
                # blocker, and floor advances land on the recv thread
                # with no condvar to wake this one: short poll
                time.sleep(0.002)
            if self._admit_clk(clk):
                return
            dead = self._fatal_dead(
                self.monitor.check()
                if self.monitor is not None else set())
            if dead:
                _fl.poison("pull_peer_failure",
                           {"table": self.name, "dead": sorted(dead),
                            "where": "local_admission"})
                raise PeerFailureError(dead)
            if time.monotonic() > deadline:
                _fl.poison("admission_deadline",
                           {"table": self.name, "clk": int(clk)})
                raise TimeoutError(
                    f"pull({self.name}): local admission for clock "
                    f"{clk} never opened")

    def _issue_pull(self, keys: np.ndarray, clk: int) -> PullFuture:
        """Send the per-owner UNIQUE-key slices for ``keys`` stamped
        ``clk`` and return the future. Duplicates never ride the wire
        (scatter by ``return_inverse`` at ``wait()``), rows the cache
        can serve under ``admits(stamp, clk, s)`` never ride it either
        — only true misses do. The local slice is read at ``wait()``
        time."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if self.pull_dedup:
            uniq, inv = np.unique(keys, return_inverse=True)
        else:  # the verbatim seed wire (bench A/B arm; cache refused)
            uniq, inv = keys, None
        owners = self._owners_of(uniq)
        out_u = np.empty((uniq.size, self.dim), np.float32)
        need = np.ones(uniq.size, bool)  # rows still to fetch over wire
        local_idx = None
        lmask = owners == self.rank
        if lmask.any():
            local_idx = np.nonzero(lmask)[0]
            need[lmask] = False
        if self._sv is not None and need.any():
            # zero-wire replica read: keys whose block THIS rank holds
            # as a replica (live lease, stamp admits clk) serve from
            # the local snapshot — no leg, no frame (serve/plane.py)
            self._sv.serve_local(uniq, out_u, need, clk)
        hits = lookups = 0
        if self._cache is not None and need.any():
            ridx = np.nonzero(need)[0]
            rows, miss = self._cache.lookup(uniq[ridx], clk,
                                            self._cache_staleness())
            lookups = ridx.size
            hit_idx = ridx[~miss]
            hits = hit_idx.size
            if hits:
                out_u[hit_idx] = rows[~miss]
                need[hit_idx] = False
        # client-side replica fan-out (serve plane): keys in replicated
        # hot blocks may route to a replica holder instead of the owner
        # — a REPLICA leg rides the svP wire (the holder serves from
        # its snapshot or refuses and the leg falls back to the owner)
        targets, rep_mask = owners, None
        if self._sv is not None and need.any():
            targets, rep_mask = self._sv.route_targets(uniq, owners,
                                                       need)
        remote: list[tuple[int, np.ndarray]] = []
        rep_legs: set[int] = set()  # positions in `remote` riding svP
        wire_rows = 0
        for o in range(self.num_processes):
            tmask = need & (targets == o)
            if not tmask.any():
                continue
            if rep_mask is None:
                remote.append((o, np.nonzero(tmask)[0]))
                continue
            for isrep in (False, True):  # owner + replica legs split:
                m = tmask & (rep_mask == isrep)  # different wire kinds
                if m.any():
                    if isrep:
                        rep_legs.add(len(remote))
                    remote.append((o, np.nonzero(m)[0]))
        gid = 0  # a fully-local pull (own shard + cache hits) allocates
        if remote:  # no request slot and touches no wire state at all
            gid = self._next_req()
            with self._reply_cond:
                self._replies[gid] = {}
                grp = {"clk": clk, "uniq": uniq, "legs": {},
                       "extra_local": []}
                self._groups[gid] = grp
            tr = _trc.TRACER
            for li, (o, idx) in enumerate(remote):
                # one wire request id PER LEG, registered BEFORE the
                # send (a reply must never beat its bookkeeping); the
                # psE re-router re-splits a refused leg mid-flight
                rid = self._next_req()
                kslice = uniq[idx]
                with self._reply_cond:
                    grp["legs"][rid] = (o, idx)
                    self._rid_gid[rid] = gid
                    # under the reply lock: replies land on the receive
                    # thread and bump the same counter (non-atomic RMW)
                    self.bytes_pulled += kslice.nbytes
                    self._leg_t0[rid] = (time.monotonic(), o)
                if tr is not None:
                    tr.flow("s",
                            _trc.flow_id(f"pull:{self.name}",
                                         self.rank, rid),
                            "pull", {"owner": o, "rid": rid})
                kind = "svP" if li in rep_legs else "psG"
                self.bus.send(o, f"{kind}:{self.name}",
                              {"req": rid, "clk": clk,
                               **self._ep_header(), **self._cfg_header()},
                              blob=_as_blob(kslice))
                wire_rows += idx.size
        self.timers.record_pull_rows(requested=keys.size, wire=wire_rows,
                                     hits=hits, lookups=lookups)
        fut = PullFuture(self, gid, keys, uniq, inv, out_u, remote,
                         local_idx, clk)
        if self._cache is not None and remote:
            self._cache_note_issue(fut)  # push-log replay anchor
        return fut

    def pull(self, keys: np.ndarray) -> np.ndarray:
        """Gather rows for global ``keys`` from their owners —
        KVClientTable::Pull with RangeManager routing (SURVEY.md §3.3).
        A pending ``prefetch_pull`` for the SAME keys is consumed instead
        of issuing a second round trip — but only if its clock stamp is
        current: a dangling prefetch from an earlier step was admitted
        under an OLDER global-min view, and consuming it now would read
        rows staler than a synchronous pull at my present clock is
        allowed to see. A stale stamp is cancelled and the pull
        round-trips fresh — the staleness bound outranks the saved
        RTT."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        with self._prefetch_lock:
            fut = self._prefetched.pop(keys.tobytes(), None)
        if fut is not None:
            if fut.clk >= self._my_clk():
                return fut.wait()
            fut.cancel()
        return self._issue_pull(keys, self._my_clk()).wait()

    def _serving_clk(self) -> int:
        c = getattr(self._cons, "gated_clock", None)
        return int(c) if c is not None else self._my_clk()

    def pull_serving(self, keys: np.ndarray) -> np.ndarray:
        """Read-only client pull at the last GATED clock — the serving
        plane's read clock (docs/serving.md). A training pull stamps
        the IN-FLIGHT clock, which nobody fleet-wide has proven
        admissible yet: owners park it until gossip catches up and
        replicas refuse it — correct, but the read pays a wait either
        way. The last gated clock is the newest stamp whose admission
        the local gate already PROVED (``global_min >= gated − s`` held
        when its tick completed), so owners serve it immediately and
        replica snapshots refreshed at the same boundary admit it —
        the read still sees every peer's updates through
        ``gated_clock − s``, one step behind the trainer's in-flight
        step, which is exactly the SSP serving contract. Falls back to
        the training clock when no trainer is bound."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        return self._issue_pull(keys, self._serving_clk()).wait()

    def prefetch_pull(self, keys: np.ndarray, *,
                      clock_ahead: int = 1) -> PullFuture:
        """Double-buffered pull: issue the NEXT batch's pull now, stamped
        with the clock the consuming step will run at (``_my_clk() +
        clock_ahead``), so owners park it under exactly the admission
        rule a synchronous pull at that step would face — overlap never
        weakens BSP/SSP. Returns the future; a later ``pull()`` with the
        same keys consumes it (or call ``wait()`` directly). One
        registry slot per distinct key set: re-prefetching the same keys
        points the slot at the NEW future, and the displaced one stays
        WAITABLE — the double-buffer pattern holds batch t's future
        while issuing batch t+1's, so two consecutive batches drawing
        byte-identical keys must not invalidate the handle in the
        caller's hand (cancelling it here made ``fut.wait()`` raise)."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        fut = self._issue_pull(keys, self._my_clk() + int(clock_ahead))
        kb = keys.tobytes()
        fut._pf_key = kb
        with self._prefetch_lock:
            old = self._prefetched.get(kb)
            self._prefetched[kb] = fut
        if old is not None:
            old._pf_key = None  # displaced, not cancelled
        return fut

    def pull_all(self) -> np.ndarray:
        """Assemble the full table (dense pulls / finalize / eval): each
        owner ships its shard once — an all-gather over the bus. With
        the rebalancer on, every owner's reply additionally carries its
        migrated-IN blocks, and assembly runs two passes: base shards
        first, then every overlay block over its (stale) home copy —
        the overlay entry is the authoritative one by construction
        (exactly one current owner per block). A rank dying mid-
        assembly (elastic membership) re-issues the whole gather at
        the post-death epoch — survivors' replies then carry the
        restored blocks (owners park future-epoch psA requests until
        their own adoption, so no reply can predate the plan)."""
        for _attempt in range(4):
            try:
                return self._pull_all_once()
            except _ReissuePullAll:
                continue
        _fl.poison("pull_all_churn", {"table": self.name})
        raise TimeoutError(
            f"pull_all({self.name}): shard assembly kept losing owners "
            "mid-gather (membership churn outran the retry budget)")

    def _pull_all_once(self) -> np.ndarray:
        if self._rb is not None:
            self._rb.adopt_now()  # a plan landing post-last-tick still
            self._wait_settled(self.pull_timeout)  # needs my rbA; and my
            # own in-transit blocks must land before I can assemble
        # the assembly's peer set is the CURRENT ROUTING TABLE's owner
        # set, not the gossip view: every row lives at exactly one
        # block owner, so polling the owners covers the table by
        # construction — a rank my table routes nothing to contributes
        # nothing (its home range is in other owners' xtra), and a
        # rank my table DOES route to must be polled even if my gossip
        # hasn't re-included it yet (a freshly-admitted joiner's live
        # announce rides a different link than the admit plan — using
        # the exclusion set here silently dropped its range from the
        # gather in that window). The rb-off path keeps the exclusion
        # rule: no overlay exists to re-home a corpse's rows, and
        # exclusions only appear once a death already doomed the run.
        if self._rb is not None:
            peers = {int(o)
                     for o in np.unique(self.router.owner_of_blocks())
                     } - {self.rank}
        else:
            peers = (set(range(self.num_processes)) - {self.rank}
                     - self._excluded_ranks())
        gid = 0
        legs: dict[int, tuple] = {}
        if peers:
            gid = self._next_req()
            with self._reply_cond:
                self._replies[gid] = {}
                grp = {"clk": self._my_clk(), "uniq": None, "legs": {},
                       "extra_local": []}
                self._groups[gid] = grp
            for o in sorted(peers):
                rid = self._next_req()
                with self._reply_cond:
                    grp["legs"][rid] = (o, None)
                    self._rid_gid[rid] = gid
                self.bus.send(o, f"psA:{self.name}",
                              {"req": rid, "clk": self._my_clk(),
                               **self._ep_header(), **self._cfg_header()})
        out = np.empty((self.part.padded, self.dim), np.float32)
        with self._state_lock:
            out[self.shard_lo:self.shard_lo + self.part.shard_size] = self._w
        self._count_serve(pull_rows=self.part.shard_size)
        if peers:
            # wire bytes are counted at reply receipt (_on_pull_reply),
            # actual bytes — an int8 wire's replies count compressed.
            # Shards deliberately bypass the row cache: a full-table
            # assembly would evict the working set for rows finalize/
            # eval reads once.
            got = self._await_replies(gid)
            legs, _extra = self._take_group(gid)
            for rid, (o, _none) in legs.items():  # pass 1: base shards
                rows = got[rid][0]
                pl = got[rid][2]
                lo = int(pl.get("lo", o * self.part.shard_size))
                nb = int(pl.get("nb", rows.shape[0]))
                out[lo:lo + nb] = rows[:nb]
        if self._rb is not None:
            # pass 2: overlay blocks (peers' and my own) overwrite the
            # stale home-slab copies pass 1 placed
            for rid, (o, _none) in legs.items():
                rows = got[rid][0]
                pl = got[rid][2]
                off = int(pl.get("nb", rows.shape[0]))
                for b, ln in zip(pl.get("xb") or (), pl.get("xl") or ()):
                    blo, _bln = self.router.block_span(int(b))
                    out[blo:blo + int(ln)] = rows[off:off + int(ln)]
                    off += int(ln)
            with self._state_lock:
                for b, st in self._xtra.items():
                    blo, _bln = self.router.block_span(int(b))
                    out[blo:blo + st["w"].shape[0]] = st["w"]
        with self._reply_cond:
            # _await_replies popped the reply map and _take_group the
            # legs; only the arrival timestamp is left to drop
            self._reply_t.pop(gid, None)
        return out[: self.num_rows]

    # ------------------------------------------------------- push pipeline
    def _take_push_seq(self, owner: int) -> int:
        """Claim an in-flight slot (blocks while the window is full) and
        stamp the send time — the ack latency timer's zero point. A full
        window SOLICITS the owners' pending ack batches while it waits:
        batching must never convert into a stall."""
        deadline = time.monotonic() + self.pull_timeout
        poison = None  # (reason, args): dump OUTSIDE _push_cond below
        try:
            with self._push_cond:
                while len(self._inflight) >= self.push_window:
                    if self._dead_ranks:
                        self._drop_dead_inflight_locked()  # sticky
                    self._solicit_acks_locked()
                    self._push_cond.wait(timeout=0.2)
                    if len(self._inflight) < self.push_window:
                        break
                    dead = self._fatal_dead(
                        self.monitor.check()
                        if self.monitor is not None else set())
                    if dead:
                        poison = ("push_peer_failure",
                                  {"table": self.name,
                                   "dead": sorted(dead)})
                        raise PeerFailureError(dead)
                    if time.monotonic() > deadline:
                        poison = ("ack_window_deadline",
                                  {"table": self.name,
                                   "unacked": len(self._inflight)})
                        raise TimeoutError(
                            f"push({self.name}): ack window jammed "
                            f"({len(self._inflight)} unacked)")
                self._push_seq += 1
                self._inflight[self._push_seq] = (time.monotonic(),
                                                  owner)
                return self._push_seq
        except (PeerFailureError, TimeoutError):
            if poison is not None:
                _fl.poison(*poison)
            raise

    def _solicit_acks_locked(self) -> None:
        """Ask every owner holding an unacked frame of mine to flush its
        pending ack batch (caller holds ``_push_cond``). Per-link FIFO:
        the psQ frame trails the frames it wants acked, so the owner's
        pending list already contains their seqs when it lands."""
        for o in {own for _, own in self._inflight.values()}:
            self.bus.send(o, f"psQ:{self.name}", {})

    def _settle_acks(self, seqs) -> None:
        now = time.monotonic()
        settled = []  # (seq, t_sent, owner)
        with self._push_cond:
            for s in seqs:
                rec = self._inflight.pop(int(s), None)
                if rec is not None:
                    settled.append((int(s), rec[0], rec[1]))
            if settled:
                self._push_cond.notify_all()
        tr = _trc.TRACER
        for seq, t0, owner in settled:
            self.timers.record_push_ack(now - t0)
            if self._slowness is not None and owner != self.rank:
                # push-ack lag per owner: the write path's half of the
                # fail-slow service-latency feed (a sick owner acks
                # late even when its beats land on time)
                self._slowness.note(owner, now - t0)
            if tr is not None:
                tr.complete("push", "push_ack", t0,
                            {"owner": owner, "seq": seq}, t1=now)

    def _on_push_ack(self, sender: int, payload: dict) -> None:
        seqs = payload.get("seqs")
        if seqs is None:  # single-seq spelling kept for compatibility
            seq = payload.get("seq")
            seqs = [] if seq is None else [seq]
        self._settle_acks(seqs)

    def _push_loop(self) -> None:
        """Sender thread (async_push): drains the queue, doing the
        per-owner split / codec / serialize / send OFF the training
        thread. A raised send poisons the table (check_fatal at the next
        tick) rather than dying silently on a daemon thread."""
        while True:
            kind, a = self._push_q.get()
            try:
                if kind == "sparse":
                    self._push_now(a[0], a[1], a[2])
                else:
                    self._push_dense_now(a)
            except Exception as e:  # noqa: BLE001 - surfaced via fatal
                if self._fatal is None:
                    self._fatal = (f"table {self.name}: async push "
                                   f"failed: {e!r}")
            finally:
                with self._push_cond:
                    self._q_pending -= 1
                    self._push_cond.notify_all()

    def flush_pushes(self, timeout: Optional[float] = None, *,
                     acks: bool = True) -> None:
        """Drain the async-push pipeline. Two levels:

        ``acks=False`` — the CLOCK-BOUNDARY drain (trainer ``tick()``):
        wait until every enqueued push has been HANDED TO THE BUS. That
        is exactly the barrier BSP/SSP need: the clock frame is emitted
        after all of step ``k``'s push frames on the same ordered
        per-link stream, so an owner whose view says I reached ``k`` has
        already processed those pushes — the identical FIFO argument the
        synchronous path's staleness proof uses (module docstring), at
        microsecond cost instead of an ack round trip per step.

        ``acks=True`` — the HARD drain (``finalize()``, fault drills):
        additionally wait until every in-flight frame is ACKED as
        received by its owner — the loss-detection point. In between,
        ``push_window`` bounds how many frames can ever be unacked.

        A drain that cannot complete (lost ack, wedged owner) POISONS
        the table instead of hanging — the caller's ``check_fatal()``
        raises."""
        if not self.async_push:
            return
        deadline = time.monotonic() + (self.pull_timeout
                                       if timeout is None else timeout)

        def drained() -> bool:
            return not (self._q_pending
                        or (acks and self._inflight))
        poison = None  # (reason, args): dump OUTSIDE _push_cond below
        try:
            with self._push_cond:
                while not drained():
                    if self._dead_ranks:
                        self._drop_dead_inflight_locked()
                        if drained():
                            break
                    if acks and not self._q_pending:
                        # everything is on the wire; batched acks may
                        # be sitting at the owners below their flush
                        # threshold — solicit them (FIFO: the psQ
                        # trails the frames)
                        self._solicit_acks_locked()
                    self._push_cond.wait(timeout=0.2)
                    if drained():
                        break
                    dead = self._fatal_dead(
                        self.monitor.check()
                        if self.monitor is not None else set())
                    if dead:
                        poison = ("drain_peer_failure",
                                  {"table": self.name,
                                   "dead": sorted(dead)})
                        raise PeerFailureError(dead)
                    if time.monotonic() > deadline:
                        if self._fatal is None:
                            self._fatal = (
                                f"table {self.name}: push drain timed "
                                f"out ({self._q_pending} queued, "
                                f"{len(self._inflight)} unacked — "
                                "lost ack or wedged owner)")
                        poison = ("drain_deadline",
                                  {"table": self.name,
                                   "queued": self._q_pending,
                                   "unacked": len(self._inflight)})
                        break  # the caller sees the poisoned table
        except PeerFailureError:
            if poison is not None:
                _fl.poison(*poison)
            raise
        if poison is not None:  # the drain-deadline (non-raising) exit
            _fl.poison(*poison)

    def _enqueue_push(self, kind: str, arg) -> None:
        """Hand one push to the sender thread, with BACKPRESSURE: at most
        ``push_window`` steps may sit unsent in the queue (on top of the
        unacked-frame window the sender itself honors), so a wedged owner
        stalls the training thread here — bounded memory — until the
        sender's own deadline poisons the table and the fatal check below
        raises instead of hanging."""
        self.check_fatal()
        deadline = time.monotonic() + self.pull_timeout
        poison = None  # (reason, args): dump OUTSIDE _push_cond below
        try:
            with self._push_cond:
                while self._q_pending >= self.push_window:
                    self._push_cond.wait(timeout=0.2)
                    self.check_fatal()  # sender poisoned while we wait
                    if self._q_pending < self.push_window:
                        break
                    dead = self._fatal_dead(
                        self.monitor.check()
                        if self.monitor is not None else set())
                    if dead:
                        poison = ("push_peer_failure",
                                  {"table": self.name,
                                   "dead": sorted(dead),
                                   "where": "send_queue"})
                        raise PeerFailureError(dead)
                    if time.monotonic() > deadline:
                        poison = ("send_queue_deadline",
                                  {"table": self.name,
                                   "queued": self._q_pending})
                        raise TimeoutError(
                            f"push({self.name}): send queue jammed "
                            f"({self._q_pending} steps unsent)")
                self._q_pending += 1
        except (PeerFailureError, TimeoutError):
            if poison is not None:
                _fl.poison(*poison)
            raise
        self._push_q.put((kind, arg))

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        """Route per-owner (keys, grads) slices; owners apply the updater.
        Duplicate keys in one push are summed first (reference Add).
        With ``async_push`` this enqueues (copies, so callers may reuse
        buffers) and returns; the wire work happens on the sender thread
        inside the ack window."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(keys.size, self.dim)
        n_orig = keys.size
        if self.async_push:
            # cache is None here (the constructor refuses the combo),
            # so no maintenance needs this thread — the coalesce rides
            # the sender thread with the rest of the wire work, keeping
            # the step window clean (the point of async push)
            self._enqueue_push("sparse",
                               (keys.copy(), grads.copy(), n_orig))
            return
        keys, grads = self._coalesce_for_wire(keys, grads)
        self._push_now(keys, grads, n_orig, coalesced=True)

    def _coalesce_for_wire(self, keys: np.ndarray,
                           grads: np.ndarray) -> tuple:
        """Client-side dedup + cache maintenance: duplicate keys
        coalesce to ONE summed row BEFORE the codec, so int8
        quantization error is paid once per row, not once per
        occurrence — and the wire ships each row once. The summed row
        IS what the server applies (deduped frames have nothing left to
        sum), so cache write-through and server state stay bitwise in
        lock-step; vs the seed's unsummed wire the result agrees to f32
        rounding (the per-dim bincount accumulates in f64 — at least as
        accurate as the server's old sequential f32 sum, and ~3x faster
        than np.add.at on this hot path). ``push_dedup=False`` restores
        the per-occurrence seed wire (bench A/B baseline; the server
        still sums). Returns the (keys, grads) to ship."""
        n = keys.size
        if not n or not (self.push_dedup or self._cache is not None):
            return keys, grads
        # the shared coalesce kernel keeps the original (keys[i],
        # grads[i]) pairing when there are no duplicates — uniq is
        # SORTED, and re-pairing grads against it would scramble every
        # gradient-row association (regression-tested:
        # test_push_all_unique_unsorted_keys_pair_correctly)
        ckeys, cdeltas, had_dups = sum_duplicate_keys(keys, grads,
                                                      self.dim)
        if had_dups and self.push_dedup:
            keys, grads = ckeys, cdeltas
        if self._cache is not None:
            self._cache_on_push(ckeys, cdeltas,
                                ckeys if had_dups else np.unique(keys))
        return keys, grads

    def _push_now(self, keys: np.ndarray, grads: np.ndarray,
                  n_rows: Optional[int] = None,
                  coalesced: bool = False) -> None:
        self.rows_pushed += keys.size if n_rows is None else n_rows
        if not coalesced:  # async path: dedup on the sender thread
            keys, grads = self._coalesce_for_wire(keys, grads)
        self._hier_poll()  # election/fallback on the training thread
        owners = self._owners_of(keys)
        for o in range(self.num_processes):
            mask = owners == o
            if not mask.any():
                continue
            if self._mb is not None and o in self._dead_ranks:
                # pre-plan window: the old table still routes here —
                # the corpse can neither apply nor ack; counted lost
                self.rb_stats["pushes_lost_to_dead"] += 1
                continue
            if o == self.rank:
                # local rows never cross a wire — full precision always
                if self._rb is not None:
                    # the classify-under-lock ingest: a concurrent
                    # adoption may have just shipped these rows away
                    self._ingest_push(keys[mask], grads[mask],
                                      self.router.epoch)
                else:
                    self._apply_rows(keys[mask] - self.shard_lo,
                                     grads[mask])
                continue
            lead = self._hier_route(o)
            if lead is not None:
                # level 1: this (worker, owner) pair rides the tree —
                # the slice goes to my host leader (or straight into my
                # own buckets when I am it), exact f32, and the flat
                # encode below never runs for it
                self._hier_contribute(lead, o, keys[mask],
                                      np.ascontiguousarray(
                                          grads[mask], np.float32))
                continue
            overflow = None
            if self.push_comm in ("topk8", "topk4"):
                # the compressed-push pipeline: fold residuals, select
                # top-k rows by mass, blockwise-quantize, retain the
                # unsent remainder (overflow ships dense right after)
                head0, blob, overflow = self._encode_push_topk(
                    keys[mask], np.ascontiguousarray(grads[mask],
                                                     np.float32))
            elif self.push_comm == "int8":
                codes, scale = quantize_rows_int8(grads[mask], self._q_rng)
                head0 = {"n": int(mask.sum()), "comm": "int8"}
                blob = _cat_blob(keys[mask], scale, codes)
            else:
                head0 = {"n": int(mask.sum()), "comm": "float32"}
                blob = _cat_blob(keys[mask], grads[mask])
            head = {**head0, **self._ep_header(), **self._cfg_header()}
            if self.async_push:
                head["seq"] = self._take_push_seq(o)
                tr = _trc.TRACER
                if tr is not None:
                    tr.flow("s", _trc.flow_id(f"push:{self.name}", self.rank,
                                              head["seq"]), "push",
                            {"owner": o, "seq": head["seq"]})
            self.bus.send(o, f"psP:{self.name}", head, blob=blob)
            self.bytes_pushed += len(blob)
            self._hier_count_tx(o, len(blob))
            if overflow is not None and overflow[0].size:
                # residual-slab overflow: mass the store had no room
                # for ships dense NOW — the byte win shrinks under
                # pressure, correctness never does
                self._send_f32_push(o, overflow[0], overflow[1])

    def _encode_push_topk(self, keys: np.ndarray, grads: np.ndarray,
                          birth_clk: Optional[int] = None,
                          ef=None, rng=None
                          ) -> tuple[dict, bytearray, tuple]:
        """One owner slice through the compressed-push pipeline:

        1. FOLD: stored residuals of this slice's keys join the
           gradient (in place — ``grads`` is a fresh fancy-index copy),
           remembering each key's oldest birth clock;
        2. SELECT: ``topk_rows`` keeps the rows carrying ``topk_mass``
           of the squared mass (capped at ``topk_cap`` of the slice) —
           the wire pays for the mass, not the touch set;
        3. ENCODE: blockwise absmax at 8/4 bits, stochastic rounding
           (the same ``_q_rng`` stream as the int8 wire), emitted as an
           index+code stream — int32 indices when the key space fits;
        4. RETAIN: unselected rows whole, plus the selected rows'
           quantization error, under ``min(birth, clock)`` so age
           survives folding. Slab overflow is returned for an
           immediate dense send — mass is conserved unconditionally.

        Returns ``(head fields, blob, (overflow keys, overflow rows))``.

        ``birth_clk`` overrides the residual birth stamp: a hier leader
        encodes an aggregate whose oldest contributor may be BEHIND
        this rank's clock, and the retained error must age from that
        min stamp or the age-flush bound would silently relax.
        """
        clk = self._my_clk() if birth_clk is None else int(birth_clk)
        ef = self._ef if ef is None else ef
        rng = self._q_rng if rng is None else rng
        bits = 8 if self.push_comm == "topk8" else 4
        births = ef.fold(keys, grads)
        births = np.minimum(births, clk)
        sel = topk_rows(grads, mass=self.topk_mass,
                        frac_cap=self.topk_cap)
        selmask = np.zeros(keys.size, bool)
        selmask[sel] = True
        g_sel = grads[sel]
        codes, scales = quantize_blockwise(g_sel, bits,
                                           block=self.topk_block,
                                           rng=rng)
        sent = dequantize_blockwise(codes, scales, sel.size, self.dim,
                                    bits, block=self.topk_block)
        ovk = np.empty(0, np.int64)
        ovr = np.empty((0, self.dim), np.float32)
        k1, r1 = ef.retain(keys[~selmask], grads[~selmask],
                           births[~selmask])
        k2, r2 = ef.retain(keys[sel], g_sel - sent, births[sel])
        if k1.size or k2.size:
            ovk = np.concatenate([k1, k2])
            ovr = np.concatenate([r1, r2])
        khead, kstream = self._key_stream(keys[sel])
        head = {"n": int(sel.size), "comm": self.push_comm,
                "blk": self.topk_block, **khead}
        return head, _cat_blob(kstream, scales, codes), (ovk, ovr)

    def _key_dtype(self):
        """The narrowest index-stream dtype the key space fits — the
        other half of 'index+code streams' (the seed wire's int64 keys
        cost as much as an 8-bit row at dim 8): u16 under 64Ki rows,
        i32 under 2Gi, i64 beyond."""
        if self.num_rows <= 1 << 16:
            return np.uint16
        if self.num_rows <= np.iinfo(np.int32).max:
            return np.int32
        return np.int64

    def _key_stream(self, k: np.ndarray) -> tuple[dict, bytes]:
        """Index stream for SORTED unique keys, at the cheaper of two
        codecs: the sorted-run delta stream (i64 base + gaps at the
        narrowest unsigned width, ops/quantized_comm.encode_key_deltas
        — hot zipf key sets are near-contiguous, so gaps usually fit a
        byte where absolute keys need 2-8) vs the plain narrowest-width
        stream. The head self-describes (``dw`` delta width vs ``kw``
        plain width), so mixed fleets decode per frame like every other
        wire knob."""
        kw = int(np.dtype(self._key_dtype()).itemsize)
        n = int(k.size)
        if n >= 2:
            try:
                dw, stream = encode_key_deltas(k)
            except ValueError:  # not strictly increasing: plain stream
                pass
            else:
                if delta_stream_bytes(n, dw) < n * kw:
                    return {"dw": dw}, stream
        return {"kw": kw}, k.astype(self._key_dtype()).tobytes()

    def _send_f32_push(self, o: int, k: np.ndarray,
                       g: np.ndarray, *,
                       extra_head: Optional[dict] = None) -> None:
        """A plain full-precision push frame to one owner — the
        residual-flush/overflow sender (seq-stamped under async push
        like any other frame, so the drain and ack machinery cover
        it). ``extra_head`` carries hier step tags / floor claims."""
        if self._mb is not None and o in self._dead_ranks:
            self.rb_stats["pushes_lost_to_dead"] += 1
            return
        blob = _cat_blob(k, np.ascontiguousarray(g, np.float32))
        head = {"n": int(k.size), "comm": "float32",
                **self._ep_header(), **self._cfg_header(),
                **(extra_head or {})}
        if self.async_push:
            head["seq"] = self._take_push_seq(o)
        self.bus.send(o, f"psP:{self.name}", head, blob=blob)
        self.bytes_pushed += len(blob)
        self._hier_count_tx(o, len(blob))

    def residual_flush(self, *, aged_only: bool = False,
                       reason: str = "fence") -> int:
        """Ship retained error-feedback mass, routed by the CURRENT
        table (local rows apply locally, full precision).

        ``aged_only`` is the clock-boundary rule (trainer ``tick``,
        BEFORE the clock frame goes out, so flushed frames precede the
        clock on every per-link stream exactly like the async drain):
        flush entries whose birth clock is ``<= clock - s`` — a
        residual may trail its push by at most the staleness bound,
        the RowCache stamp rule mirrored onto the write path (ASP
        never age-flushes: there is no bound to protect). The aged set
        ships DENSE in keys (no top-k selection — every aged row goes)
        but compressed in value: the blockwise 4-bit stream with
        STOCHASTIC rounding, whose quantization error is dropped, not
        re-retained — exactly the int8 wire's unbiased-noise contract
        (E[decoded] = residual), so aged mass is delivered in
        expectation at ~4 bits/element instead of re-aging a
        second-order error forever (zipf tails age out every window;
        an f32 aged flush measurably cost MORE than the int8 wire it
        was supposed to beat).

        The full flush (``aged_only=False``) is EXACT f32: it runs at
        every epoch fence (``adopt_table``, before the router swap —
        flushed frames ride the old table's links AHEAD of my rbA, so
        fences release only after the mass landed), at membership
        drains, and at ``finalize()`` — post-finalize agreement and
        the migration oracle drills are bitwise, not in-expectation.
        Returns rows flushed."""
        if self._ef is None:
            return 0
        if aged_only:
            s = self._cache_staleness()
            if s == float("inf"):
                return 0
            keys, rows = self._ef.take(self._my_clk() - int(s))
        else:
            keys, rows = self._ef.take()
        if not keys.size:
            return 0
        self._ef.note_flushed(int(keys.size),
                              "age" if aged_only else reason)
        owners = self._owners_of(keys)
        for o in np.unique(owners):
            m = owners == o
            if int(o) == self.rank:
                if self._rb is not None:
                    self._ingest_push(keys[m], rows[m],
                                      self.router.epoch)
                else:
                    self._apply_rows(keys[m] - self.shard_lo, rows[m])
            elif aged_only:
                self._send_blk4_push(int(o), keys[m], rows[m])
            else:
                self._send_f32_push(int(o), keys[m], rows[m])
        return int(keys.size)

    def _send_blk4_push(self, o: int, k: np.ndarray,
                        g: np.ndarray) -> None:
        """The aged-flush frame: the same topk4 index+code stream the
        selected path emits (one wire format, the receiver cannot tell
        a flush from a fresh push), stochastic rounding, error
        dropped — see :meth:`residual_flush`."""
        if self._mb is not None and o in self._dead_ranks:
            self.rb_stats["pushes_lost_to_dead"] += 1
            return
        order = np.argsort(k, kind="stable")  # residual-store order is
        # arbitrary; the delta key codec needs sorted runs, and sorting
        # before the quantize keeps codes/keys paired
        k, g = k[order], np.ascontiguousarray(g[order])
        codes, scales = quantize_blockwise(g, 4, block=self.topk_block,
                                           rng=self._q_rng)
        khead, kstream = self._key_stream(k)
        head = {"n": int(k.size), "comm": "topk4",
                "blk": self.topk_block, **khead,
                **self._ep_header(), **self._cfg_header()}
        if self.async_push:
            head["seq"] = self._take_push_seq(o)
        blob = _cat_blob(kstream, scales, codes)
        self.bus.send(o, f"psP:{self.name}", head, blob=blob)
        self.bytes_pushed += len(blob)
        self._hier_count_tx(o, len(blob))

    def ef_stats(self) -> Optional[dict]:
        """Error-feedback residual counters — None when the compressed
        push wire is off (off vs idle, the done-line convention)."""
        return self._ef.stats() if self._ef is not None else None

    # ---- hierarchical push tree (balance/hier.py, MINIPS_HIER) ------
    #
    # Protocol, one psH wire per table:
    #   "c"  member -> leader   contribution: one owner slice, exact f32
    #   "b"  member -> leader   boundary: "my pushes < f are with you"
    #   "a"  leader -> member   ack: "your steps < f were flushed"
    #   "f"  leader -> owner    floor-only claim (no mass this boundary)
    #   "x"  member -> leader   expel me (sick-leader fallback handshake)
    #   "xa" leader -> member   expel-ack: the floor already flushed
    #   "r"  member -> owner    waive my floor (I am direct again)
    #   "m"  member -> owner    re-arm my floor at f (re-entered a tree)
    # Aggregated MASS rides the ordinary psP wire with head extras:
    # hfr/hfv (per-contributor floor claims, max-merged at the owner)
    # and hmin (min contributor stamp — the aggregate's birth clock).

    def _hier_elect(self) -> Optional[int]:
        """My group's current leader under THE deterministic rule
        (balance/hier.elect: lowest live rank) — every member computes
        it locally from the shared gossip exclusion set."""
        return self._hier_elect_fn(
            self._hier_group,
            self._excluded_ranks() | self._dead_ranks)

    def _hier_route(self, o: int) -> Optional[int]:
        """Level-1 routing for one owner: my group's leader when the
        (me, owner) pair is in hier mode, else None = flat wire.
        In-group owners, singleton groups, the accounting-only arm
        (agg=0), and the direct-fallback latch all stay flat."""
        cfg = self._hier
        if cfg is None or not cfg.agg or cfg.group < 2:
            return None
        if self._hier_direct or len(self._hier_group) < 2:
            return None
        if self._hier_host_of(o) == self._hier_host_of(self.rank):
            return None
        return self._hier_leader  # None while leaderless -> flat

    def _hier_count_tx(self, o: int, nbytes: int) -> None:
        """Per-level byte/frame classification at every push-frame
        send: in-group traffic is level 1, cross-group is level 2 (the
        HIER-WIN gate reads l2 — the leader leg). ``group=1``
        (armed-idle) counts nothing: the tree is degenerate and the
        zeros-when-idle wire_record contract holds."""
        cfg = self._hier
        if cfg is None or cfg.group < 2:
            return
        h = self.hier_counters
        if self._hier_host_of(o) == self._hier_host_of(self.rank):
            h["l1_tx_bytes"] += nbytes
            h["l1_frames"] += 1
        else:
            h["l2_tx_bytes"] += nbytes
            h["l2_frames"] += 1

    def _hier_floor_min(self) -> Optional[int]:
        """Min floor over LIVE registered hier contributors — None when
        no contributor is registered (hier off, group=1, or a fleet
        with no cross-group multi-rank pusher). Excluded/dead
        contributors stop gating: their mass either landed or is
        counted lost, exactly like the gossip min's exclusion rule."""
        fl = self._hier_floor
        if not fl:
            return None
        exc = self._excluded_ranks() | self._dead_ranks
        vals = [f for r, f in fl.items() if r not in exc]
        return min(vals) if vals else None

    def _admit_clk(self, clk: int) -> bool:
        """THE owner-side pull admission: the gossip staleness rule AND
        the per-contributor hier floors. A hier contributor's clock
        frame no longer certifies its cross-host pushes (they ride two
        links; per-link FIFO does not compose), so the same
        ``gate.admits`` predicate is re-evaluated against the floor min
        — semantics preserved, evidence source swapped. A tenant with
        its own ``s`` is judged against THAT bound (trainer
        ``admit_pull_s``); stub consistency objects without the
        per-bound entry point keep the fleet-wide rule."""
        ts = self._tenant.s if self._tenant is not None else None
        if self._cons is not None:
            if ts is not None and hasattr(self._cons, "admit_pull_s"):
                if not self._cons.admit_pull_s(clk, ts):
                    return False
            elif not self._cons.admit_pull(clk):
                return False
        fm = self._hier_floor_min()
        if fm is None:
            return True
        return admits(int(fm), int(clk), self._cache_staleness())

    def _hier_contribute(self, lead: int, o: int, k: np.ndarray,
                         g: np.ndarray) -> None:
        """Ship one owner slice up the tree (or straight into my own
        buckets when I am the leader). The slice is RETAINED until the
        leader acks its flush — the fallback's replay source, so a
        leader death costs bytes (an exact re-push), never steps."""
        step = self._my_clk()
        if lead == self.rank:
            with self._hier_lock:
                self._hier_buckets.setdefault(int(o), []).append(
                    (k, g, step, self.rank))
            return
        blob = _cat_blob(k, g)
        head = {"op": "c", "o": int(o), "n": int(k.size),
                "clk": int(step), **self._cfg_header()}
        with self._hier_lock:
            self._hier_retained.append((step, int(o), k, g))
        self.bus.send(lead, f"psH:{self.name}", head, blob=blob)
        h = self.hier_counters
        h["contribs"] += 1
        h["l1_frames"] += 1
        h["l1_tx_bytes"] += len(blob)

    def _on_hier(self, sender: int, payload: dict) -> None:
        """The psH wire handler (bus recv thread) — see the protocol
        table above. Mutates hier state under ``_hier_lock``; the only
        sends it issues are replies/flushes, never waits."""
        op = payload.get("op")
        if op == "c":
            if not self._check_peer_config(sender, payload):
                return
            if sender in self._hier_expelled:
                return  # late frame from a member that went direct
            n = int(payload.get("n", 0))
            blob = payload.get("__blob__")
            if blob is None or len(blob) != n * (8 + 4 * self.dim):
                self._drop("malformed", sender,
                           "bad hier contribution blob")
                return
            k = np.frombuffer(blob[:8 * n], np.int64)
            g = np.frombuffer(blob[8 * n:], np.float32
                              ).reshape(n, self.dim)
            with self._hier_lock:
                self._hier_buckets.setdefault(
                    int(payload.get("o", -1)), []).append(
                    (k, g, int(payload.get("clk", 0)), sender))
        elif op == "b":
            f = int(payload.get("f", 0))
            with self._hier_lock:
                if sender not in self._hier_expelled:
                    cur = self._hier_member_floor.get(sender, 0)
                    self._hier_member_floor[sender] = max(cur, f)
            # whichever boundary completes the step flushes it: the
            # group-min trigger fires exactly once per boundary in
            # every interleaving, and running it HERE (recv thread)
            # is what keeps two groups' lockstep free of deadlock
            self._hier_maybe_flush()
        elif op == "a":
            f = int(payload.get("f", 0))
            with self._hier_lock:
                self._hier_retained = [e for e in self._hier_retained
                                       if e[0] >= f]
        elif op == "f":
            if sender in (self._excluded_ranks() | self._dead_ranks):
                self.hier_counters["stale_leader_drops"] += 1
                return
            self._hier_merge_floors(payload)
            self.serve_parked()
        elif op == "x":
            with self._hier_lock:
                self._hier_expelled.add(sender)
                self._hier_member_floor.pop(sender, None)
                for o in list(self._hier_buckets):
                    self._hier_buckets[o] = [
                        e for e in self._hier_buckets[o]
                        if e[3] != sender]
                f = int(self._hier_claimed.get(sender, 0))
            self.bus.send(sender, f"psH:{self.name}",
                          {"op": "xa", "f": f})
            self._hier_maybe_flush()  # gmin may advance without them
        elif op == "xa":
            with self._hier_lock:
                self._hier_xa = int(payload.get("f", 0))
        elif op == "r":
            with self._hier_lock:
                if sender in self._hier_floor:
                    self._hier_floor[sender] = RETIRED_CLOCK
            self.serve_parked()
        elif op == "m":
            with self._hier_lock:
                if sender in self._hier_floor:
                    self._hier_floor[sender] = int(payload.get("f", 0))

    def _hier_merge_floors(self, payload: dict) -> None:
        """Max-merge a frame's hfr/hfv floor claims into the owner-side
        floors. Max, monotone: a zombie leader's stale (lower) claim
        can never roll a floor back, and the member's own ``r``/``m``
        frames are the only lowering path (same-link FIFO with its
        re-pushes, so the lowered claim is always true)."""
        hfr = payload.get("hfr") or ()
        hfv = payload.get("hfv") or ()
        with self._hier_lock:
            for r, f in zip(hfr, hfv):
                r, f = int(r), int(f)
                cur = self._hier_floor.get(r)
                if cur is not None and f > cur:
                    self._hier_floor[r] = f

    def _hier_maybe_flush(self, force: bool = False) -> None:
        """Leader flush: fires when the GROUP-MIN boundary floor
        advances past the last flush — per owner, concat + exact f64
        dedup-sum, then ONE frame on the configured push wire with the
        floor claims and the min contributor stamp. ``_hier_flush_lock``
        spans snapshot AND sends: a later flush's floor claim must
        never overtake an earlier flush's mass on an owner link."""
        cfg = self._hier
        if cfg is None or not cfg.agg:
            return
        with self._hier_flush_lock:
            with self._hier_lock:
                if self._hier_leader != self.rank or self._hier_direct:
                    return
                exc = self._excluded_ranks() | self._dead_ranks
                live = [r for r in self._hier_member_floor
                        if r not in exc]
                gmin = min([self._hier_own_floor]
                           + [self._hier_member_floor[r] for r in live])
                if gmin <= self._hier_flushed_floor and not force:
                    return
                self._hier_flushed_floor = gmin
                buckets, self._hier_buckets = self._hier_buckets, {}
                floors = {self.rank: self._hier_own_floor}
                floors.update({r: self._hier_member_floor[r]
                               for r in live})
                self._hier_claimed.update(floors)
            t0 = time.monotonic()
            extra = {"hfr": [int(r) for r in sorted(floors)],
                     "hfv": [int(floors[r]) for r in sorted(floors)]}
            agg = (self._hier_mesh_agg()
                   if cfg.agg == "mesh" else None)
            if agg is not None:
                sent_to = self._hier_mesh_flush(agg, buckets, extra)
            else:
                sent_to = set()
                for o in sorted(buckets):
                    entries = buckets[o]
                    if not entries or o < 0:
                        continue
                    ks = np.concatenate([e[0] for e in entries])
                    gs = np.concatenate([e[1] for e in entries])
                    hmin = min(int(e[2]) for e in entries)
                    k, g, _ = sum_duplicate_keys(ks, gs, self.dim)
                    self._hier_send_agg(int(o), k, g, hmin, extra)
                    sent_to.add(int(o))
            for o in self._hier_cross:
                # owners with no mass this boundary still need the
                # claim, or their admission would stall on my group
                if o in sent_to or o in self._dead_ranks:
                    continue
                self.bus.send(o, f"psH:{self.name}",
                              {"op": "f", **extra})
                self.hier_counters["floor_frames"] += 1
            for m in live:
                self.bus.send(m, f"psH:{self.name}",
                              {"op": "a", "f": int(floors[m])})
            self.hist_hier.record_s(time.monotonic() - t0)

    def _hier_send_agg(self, o: int, k: np.ndarray, g: np.ndarray,
                       hmin: int, extra: dict) -> None:
        """One aggregated frame to one owner on the configured push
        wire (the receiver cannot tell an aggregate from a flat push
        except by its head extras). Level-2 EF folds in the leader's
        DEDICATED store under the aggregate's min stamp."""
        if self._mb is not None and o in self._dead_ranks:
            self.rb_stats["pushes_lost_to_dead"] += 1
            return
        extra = {**extra, "hmin": int(hmin)}
        if self.push_comm in ("topk8", "topk4"):
            head0, blob, overflow = self._encode_push_topk(
                k, np.ascontiguousarray(g, np.float32),
                birth_clk=hmin, ef=self._hier_ef, rng=self._hier_rng)
            if overflow is not None and overflow[0].size:
                # overflow FIRST: the floor claim rides the aggregate,
                # which must be the LAST frame of this flush on the
                # owner link — a claim overtaking its own mass would
                # admit a pull that misses it
                self._send_f32_push(o, overflow[0], overflow[1])
        elif self.push_comm == "int8":
            codes, scale = quantize_rows_int8(g, self._hier_rng)
            head0 = {"n": int(k.size), "comm": "int8"}
            blob = _cat_blob(k, scale, codes)
        else:
            head0 = {"n": int(k.size), "comm": "float32"}
            blob = _cat_blob(k, np.ascontiguousarray(g, np.float32))
        head = {**head0, **self._ep_header(), **self._cfg_header(),
                **extra}
        self.bus.send(o, f"psP:{self.name}", head, blob=blob)
        self.bytes_pushed += len(blob)
        h = self.hier_counters
        h["agg_frames"] += 1
        h["agg_rows"] += int(k.size)
        self._hier_count_tx(o, len(blob))

    def _hier_mesh_agg(self):
        """The leader's lazy MeshAggregator (``agg=mesh``). A build
        failure — no jax devices, bad env — latches a STICKY fallback
        to the host f64 kernel: the tree keeps running with identical
        frames and semantics, only the reduce engine degrades
        (flight-recorded once, never retried this incarnation)."""
        cfg = self._hier
        if cfg is None or cfg.agg != "mesh" or self._hier_mesh_failed:
            return None
        if self._hier_mesh is None:
            try:
                from minips_tpu_torch.train.mesh_plane import MeshAggregator
                comm = (os.environ.get("MINIPS_HIER_MESH_COMM",
                                       "blk8").strip() or "blk8")
                self._hier_mesh = MeshAggregator(
                    self.num_rows, self.dim,
                    slots=max(len(self._hier_group), 1), comm=comm)
            except Exception as e:  # noqa: BLE001 — degrade, not die
                self._hier_mesh_failed = True
                self.hier_counters["mesh_agg_fallbacks"] += 1
                _fl.record("hier_mesh_fallback",
                           {"table": self.name, "err": repr(e)})
                return None
        return self._hier_mesh

    def _hier_mesh_flush(self, agg, buckets: dict,
                         extra: dict) -> set:
        """The ``agg=mesh`` reduce leg of one leader flush: every
        bucket entry deposits into the host's device mesh (one slot
        per group member), ONE reduce-scatter produces the aggregate,
        and the same per-owner ``psP`` frames ship cross-host — the
        wire cannot tell which engine reduced. The device quantizer's
        residual feeds the leader-lane ResidualStore under each
        owner's min contributor stamp (topk wire: the next encode
        folds it back — the unbiased-flush contract end-to-end); exact
        wires repay it straight into the aggregate, so every flush
        ships exact sums. Caller holds ``_hier_flush_lock``."""
        sent_to: set = set()
        hmins: dict[int, int] = {}
        okeys: dict[int, np.ndarray] = {}
        slot_of = {r: i for i, r in enumerate(self._hier_group)}
        for o in sorted(buckets):
            entries = buckets[o]
            if not entries or o < 0:
                continue
            o = int(o)
            hmins[o] = min(int(e[2]) for e in entries)
            # deposit in bucket order — the exact occurrence order the
            # f64 path concatenates, so the degenerate one-device tier
            # is bitwise agg=host
            for k, g, _clk, sender in entries:
                agg.deposit(slot_of.get(int(sender), 0), k, g)
            okeys[o] = np.unique(np.concatenate(
                [e[0] for e in entries]))
        if not hmins:
            return sent_to
        keys, rows, rk, rr = agg.reduce()
        self.hier_counters["mesh_reduces"] += 1
        if rk.size:
            # stamp each residual key with ITS owner's min contributor
            # clock (per-owner bucket membership, not a router re-read:
            # a rebalance mid-flush must not re-home retained error)
            hmin_of = np.full(keys.size, self._my_clk(), np.int64)
            owner_of = np.full(keys.size, -1, np.int64)
            for o, ok in okeys.items():
                idx = np.searchsorted(keys, ok)
                hmin_of[idx] = hmins[o]
                owner_of[idx] = o
            ridx = np.searchsorted(keys, rk)
            if self._hier_ef is not None:
                ovk, ovr = self._hier_ef.retain(rk, rr, hmin_of[ridx])
                if ovk.size:
                    # slab overflow ships dense NOW, before any
                    # aggregate: mass conserved, claims still last
                    ov_owner = owner_of[np.searchsorted(keys, ovk)]
                    for o in np.unique(ov_owner):
                        m = ov_owner == o
                        self._send_f32_push(int(o), ovk[m], ovr[m])
            else:
                rows[ridx] += rr
        for o in sorted(okeys):
            ok = okeys[o]
            g = np.ascontiguousarray(
                rows[np.searchsorted(keys, ok)], np.float32)
            self._hier_send_agg(o, ok, g, hmins[o], extra)
            sent_to.add(o)
        return sent_to

    def _hier_poll(self) -> None:
        """Election/fallback state machine, driven from the training
        thread's natural poll points (push, tick boundary, pull waits):
        re-run THE deterministic election; a convicted leader triggers
        fallback (replay the retained window direct, waive my floors);
        a live-but-sick leader (retained window past ``retain``) is
        expelled via the x/xa handshake; a NEW live leader (myself
        included) re-enters the tree."""
        cfg = self._hier
        if cfg is None or not cfg.agg or cfg.group < 2:
            return
        if (cfg.agg == "mesh" and not self._hier_domain_down
                and len(self._hier_group) >= 2):
            # agg=mesh makes the host ONE failure domain: the mesh
            # plane's collectives span every member, so a single
            # convicted/dead member invalidates the whole reduce
            # group. Latch sticky, demote the group as one unit —
            # everyone (leader included) degrades to direct pushes
            # and nobody re-enters this incarnation
            exc = self._excluded_ranks() | self._dead_ranks
            gone = sorted(r for r in self._hier_group if r in exc)
            if gone:
                self._hier_domain_down = True
                self.hier_counters["domain_demotions"] += 1
                _fl.record("hier_domain_down",
                           {"table": self.name, "rank": self.rank,
                            "gone": [int(r) for r in gone],
                            "group": [int(r) for r in
                                      self._hier_group]})
                self._hier_domain_demote()
        new = self._hier_elect()
        repush = None
        with self._hier_lock:
            old = self._hier_leader
            if new != old:
                self._hier_leader = new
                self.hier_counters["elections"] += 1
                if not self._hier_direct and old is not None \
                        and old != self.rank:
                    # my leader was convicted with my window in flight
                    self._hier_direct = True
                    self._hier_shunned = old
                    repush = list(self._hier_retained)
                    self._hier_retained.clear()
                    self.hier_counters["fallbacks"] += 1
        if new != old:
            _fl.record("hier_leader_elect",
                       {"table": self.name,
                        "old": -1 if old is None else int(old),
                        "new": -1 if new is None else int(new)})
        if repush is not None:
            self._hier_replay(repush, old, "leader_dead")
        with self._hier_lock:
            sick = (not self._hier_direct
                    and self._hier_leader not in (None, self.rank)
                    and len(self._hier_retained) > cfg.retain)
        if sick:
            self._hier_expel_and_go_direct()
        with self._hier_lock:
            direct = self._hier_direct
            shunned = self._hier_shunned
            cur = self._hier_leader
        if (direct and cur is not None and cur != shunned
                and not self._hier_domain_down):
            self._hier_reenter(cur)

    def _hier_domain_demote(self) -> None:
        """Demote my whole host group after the domain latch tripped.
        A live LEADER force-flushes its buckets (its own contributions
        have no retained copy — the flush is their only exit), then
        goes direct and waives its floor; a live MEMBER runs the x/xa
        expel handshake against a live leader (exactly-once handoff)
        or, when the leader is the dead one, lets the election
        fallback replay the retained window — both paths end direct
        with floors waived, zero lost steps."""
        with self._hier_lock:
            lead = self._hier_leader
            direct = self._hier_direct
        if direct:
            return
        if lead == self.rank:
            self._hier_maybe_flush(force=True)
            with self._hier_lock:
                self._hier_direct = True
                self._hier_shunned = self.rank
                self.hier_counters["fallbacks"] += 1
            dead = self._excluded_ranks() | self._dead_ranks
            for o in self._hier_cross:
                if o not in dead:
                    self.bus.send(o, f"psH:{self.name}", {"op": "r"})
        elif lead is not None and lead not in (
                self._excluded_ranks() | self._dead_ranks):
            self._hier_expel_and_go_direct()
        # dead-leader case: _hier_poll's election fallback replays

    def _hier_replay(self, repush: list, old, why: str) -> None:
        """The fallback's second half: re-push the retained window
        DIRECT (exact f32, step-tagged so the owner's floor filter
        dedups anything the dead leader's last flush already
        delivered), then waive my floor at every owner — the ``r``
        rides AFTER the re-pushes on each owner link, so the waiver is
        true when it lands. Zero lost steps; the cost is bytes."""
        _fl.record("hier_fallback",
                   {"table": self.name,
                    "leader": -1 if old is None else int(old),
                    "why": why, "steps": len(repush)})
        h = self.hier_counters
        for step, o, k, g in repush:
            self._send_f32_push(o, k, g, extra_head={"hst": int(step)})
            h["repushed_steps"] += 1
        dead = self._excluded_ranks() | self._dead_ranks
        for o in self._hier_cross:
            if o not in dead:
                self.bus.send(o, f"psH:{self.name}", {"op": "r"})

    def _hier_expel_and_go_direct(self) -> None:
        """Sick-leader fallback against a LIVE leader: the x/xa
        handshake makes the handoff exactly-once — the leader discards
        my pending bucket mass (I will re-push it), stops claiming my
        floor, and tells me the floor it already flushed so I replay
        only the steps above it. A leader too sick to even ack within
        the grace degrades to the dead-leader replay (floor filter
        still dedups whatever it managed to flush)."""
        with self._hier_lock:
            lead = self._hier_leader
            if self._hier_direct or lead in (None, self.rank):
                return
            self._hier_xa = None
        self.bus.send(lead, f"psH:{self.name}", {"op": "x"})
        t_end = time.monotonic() + 2.0
        f = 0
        while time.monotonic() < t_end:
            with self._hier_lock:
                if self._hier_xa is not None:
                    f = int(self._hier_xa)
                    break
            if lead in (self._excluded_ranks() | self._dead_ranks):
                break
            time.sleep(0.005)
        with self._hier_lock:
            self._hier_direct = True
            self._hier_shunned = lead
            repush = [e for e in self._hier_retained if e[0] >= f]
            self._hier_retained.clear()
            self.hier_counters["fallbacks"] += 1
        self._hier_replay(repush, lead, "expelled")

    def _hier_reenter(self, lead: int) -> None:
        """Re-enter the tree under a NEW live leader (myself included:
        a surviving lowest rank starts leading its remaining members).
        The ``m`` frame re-arms my floor at the current clock — valid
        because everything below it went direct on the same owner link
        while I was fallen back."""
        f = int(self._my_clk())
        with self._hier_lock:
            self._hier_direct = False
            self._hier_shunned = None
            if lead == self.rank:
                self._hier_own_floor = max(self._hier_own_floor, f)
        dead = self._excluded_ranks() | self._dead_ranks
        for o in self._hier_cross:
            if o not in dead:
                self.bus.send(o, f"psH:{self.name}",
                              {"op": "m", "f": f})

    def hier_boundary(self) -> None:
        """The trainer-tick hook, called AFTER the step's pushes and
        residual flushes and BEFORE the clock frame goes out (the same
        per-link-FIFO slot the async drain uses): members hand the
        leader a boundary certifying this step's contributions are
        complete; the leader advances its own floor and flushes if that
        completes the group."""
        cfg = self._hier
        if cfg is None or not cfg.agg or cfg.group < 2:
            return
        self._hier_poll()
        f = int(self._my_clk()) + 1
        with self._hier_lock:
            lead = self._hier_leader
            direct = self._hier_direct
        if direct or lead is None:
            return
        if lead == self.rank:
            with self._hier_lock:
                self._hier_own_floor = max(self._hier_own_floor, f)
            self._hier_maybe_flush()
            self._hier_residual_boundary()
        else:
            self.bus.send(lead, f"psH:{self.name}",
                          {"op": "b", "f": f})
            self.hier_counters["l1_frames"] += 1

    def _hier_residual_boundary(self) -> None:
        """Leader-lane aged residual flush — the level-2 twin of
        ``residual_flush(aged_only=True)``: retained aggregate error
        older than the staleness bound ships as the blk4 stream,
        straight to its owner (leader -> owner IS the hier lane)."""
        if self._hier_ef is None:
            return
        s = self._cache_staleness()
        if s == float("inf"):
            return
        with self._hier_flush_lock:
            keys, rows = self._hier_ef.take(self._my_clk() - int(s))
            if not keys.size:
                return
            self._hier_ef.note_flushed(int(keys.size), "age")
            owners = self._owners_of(keys)
            for o in np.unique(owners):
                m = owners == o
                if int(o) == self.rank:
                    if self._rb is not None:
                        self._ingest_push(keys[m], rows[m],
                                          self.router.epoch)
                    else:
                        self._apply_rows(keys[m] - self.shard_lo,
                                         rows[m])
                else:
                    self._send_blk4_push(int(o), keys[m], rows[m])

    def hier_finalize(self, timeout: float = 20.0) -> None:
        """Quiesce the tree BEFORE the psFlush barrier: a member's
        psFlush no longer certifies its cross-host mass (it may sit in
        the leader's buckets), so the member hands the leader a RETIRED
        boundary and waits for its retained window to drain — falling
        back (bytes, not loss) if the leader dies or hangs — and the
        leader drives its floor to RETIRED, flushing as the members'
        RETIRED boundaries land, so its own psFlush rides AFTER the
        last aggregated frame on every owner link."""
        cfg = self._hier
        if cfg is None or not cfg.agg or cfg.group < 2:
            return
        deadline = time.monotonic() + timeout
        self._hier_poll()
        with self._hier_lock:
            lead = self._hier_leader
            direct = self._hier_direct
        if not direct and lead not in (None, self.rank):
            self.bus.send(lead, f"psH:{self.name}",
                          {"op": "b", "f": int(RETIRED_CLOCK)})
            while True:
                with self._hier_lock:
                    if not self._hier_retained or self._hier_direct:
                        break
                self._hier_poll()  # a death here falls back + replays
                if time.monotonic() > deadline:
                    self._hier_expel_and_go_direct()
                    break
                time.sleep(0.005)
        with self._hier_lock:
            lead = self._hier_leader
            direct = self._hier_direct
        if lead == self.rank and not direct:
            # a demoted (domain-down) leader has nothing to drive: its
            # members went direct and will never send RETIRED
            # boundaries — waiting here would just burn the timeout
            with self._hier_lock:
                self._hier_own_floor = int(RETIRED_CLOCK)
            while True:
                self._hier_maybe_flush()
                with self._hier_lock:
                    exc = (self._excluded_ranks()
                           | self._dead_ranks)
                    waiting = [
                        r for r in self._hier_member_floor
                        if r not in exc
                        and self._hier_member_floor[r] < RETIRED_CLOCK]
                if not waiting:
                    break
                if time.monotonic() > deadline:
                    _fl.record("hier_finalize_timeout",
                               {"table": self.name,
                                "waiting": sorted(waiting)})
                    break
                time.sleep(0.005)
            self._hier_maybe_flush(force=True)
            self._hier_residual_fence()

    def _hier_residual_fence(self) -> None:
        """Exact f32 fence flush of the leader-lane residual store —
        the finalize twin of ``residual_flush(reason="fence")``:
        post-finalize agreement is bitwise, so no leader-side error
        mass may outlive the run."""
        if self._hier_ef is None:
            return
        with self._hier_flush_lock:
            keys, rows = self._hier_ef.take()
            if not keys.size:
                return
            self._hier_ef.note_flushed(int(keys.size), "fence")
            owners = self._owners_of(keys)
            for o in np.unique(owners):
                m = owners == o
                if int(o) == self.rank:
                    if self._rb is not None:
                        self._ingest_push(keys[m], rows[m],
                                          self.router.epoch)
                    else:
                        self._apply_rows(keys[m] - self.shard_lo,
                                         rows[m])
                else:
                    self._send_f32_push(int(o), keys[m], rows[m])

    def hier_stats(self) -> Optional[dict]:
        """Hier counters + live tree state — None when hier is off
        (the off-vs-idle done-line convention; ``group=1`` keeps every
        byte/frame counter at zero)."""
        if self._hier is None:
            return None
        out = {k: int(v) for k, v in self.hier_counters.items()}
        with self._hier_lock:
            out["retained_steps"] = len(self._hier_retained)
            out["leader"] = (-1 if self._hier_leader is None
                             else int(self._hier_leader))
            out["direct"] = int(self._hier_direct)
        fm = self._hier_floor_min()
        out["floor_min"] = -1 if fm is None else int(fm)
        if self._hier_ef is not None:
            out["ef_rows"] = int(
                self._hier_ef.stats()["resident_rows"])
        out["domain_down"] = int(self._hier_domain_down)
        if self._hier_mesh is not None:
            out["mesh"] = self._hier_mesh.stats()
        return out

    def push_dense(self, grad: np.ndarray) -> None:
        """Whole-vector gradient push, split into per-owner contiguous
        ranges (no key lists on the wire) — the dense-table fast path.
        Async mode enqueues like :meth:`push`."""
        grad = np.asarray(grad, np.float32).reshape(-1, self.dim)
        if grad.shape[0] != self.num_rows:
            raise ValueError(
                f"push_dense expects [{self.num_rows}, {self.dim}]")
        if self._cache is not None:
            # a dense push touches every row: conservatively drop the
            # cache (dense workloads read via pull_all, which bypasses
            # it anyway) rather than write through a whole table — and
            # poison IN-FLIGHT pulls' inserts too (broken floor): their
            # replies may sit on either side of this push, and clearing
            # alone would let them re-cache pre-push rows
            self._cache.clear()
            with self._cache_log_lock:
                self._cache_broken_floor = self._cache_epoch
                self._cache_epoch += 1
                self._cache_log.clear()
        if self.async_push:
            self._enqueue_push("dense", grad.copy())
            return
        self._push_dense_now(grad)

    def _push_dense_now(self, grad: np.ndarray) -> None:
        sz = self.part.shard_size
        for o in range(self.num_processes):
            lo, hi = o * sz, min((o + 1) * sz, self.num_rows)
            if hi <= lo:
                continue
            if o == self.rank:
                if self._rb is not None and (self.router._overlay
                                             or not
                                             self.rebalance_settled()):
                    # part of my home range may live elsewhere now: the
                    # keyed ingest forwards migrated rows instead of
                    # writing them into the dead slab copy (the same
                    # fallback _handle_push_range applies on receive)
                    self._ingest_push(np.arange(lo, hi, dtype=np.int64),
                                      grad[lo:hi], self.router.epoch)
                else:
                    self._apply_range(0, grad[lo:hi])
                continue
            if self.push_comm != "float32":
                # the range fast path has no key stream to sparsify:
                # the topk tiers fall back to the per-row int8 codec
                # here (dense pushes touch every row anyway — there is
                # no top-k win, and EF residuals would just be the
                # whole table; docs/api.md wire-ladder note)
                codes, scale = quantize_rows_int8(grad[lo:hi], self._q_rng)
                gb = scale.tobytes() + codes.tobytes()
                wire_comm = "int8"
            else:
                gb = grad[lo:hi].tobytes()
                wire_comm = "float32"
            head = {"lo": lo, "comm": wire_comm,
                    **self._ep_header(), **self._cfg_header()}
            if self.async_push:
                head["seq"] = self._take_push_seq(o)
            self.bus.send(o, f"psR:{self.name}", head, blob=gb)
            self.bytes_pushed += len(gb)
        self.rows_pushed += self.num_rows

    # ------------------------------------------------------------- accounting
    def local_bytes(self) -> int:
        """Bytes of table + optimizer state THIS process holds — the ~1/N
        sharding claim the smoke test asserts (migrated-in blocks count:
        they are live state only this process holds)."""
        n = self._w.nbytes
        if self._acc is not None:
            n += self._acc.nbytes
        if self._m is not None:
            n += self._m.nbytes + self._v.nbytes + self._steps.nbytes
        with self._state_lock:
            for st in self._xtra.values():
                n += sum(a.nbytes for a in st.values() if a is not None)
        return n

    # ------------------------------------------------------------- state I/O
    def shard_state_dict(self) -> dict:
        if self._rb is not None:
            # a checkpoint must never capture a block mid-flight (the
            # old owner already shipped it, the new owner has not
            # installed it: the step would restore without that state)
            self._wait_settled(self.pull_timeout)
        with self._state_lock:
            out = {"w": self._w.copy(), "lo": np.asarray(self.shard_lo)}
            if self._acc is not None:
                out["acc"] = self._acc.copy()
            if self._m is not None:
                out["m"] = self._m.copy()
                out["v"] = self._v.copy()
                out["steps"] = self._steps.copy()
            ep, ov = self.router.table()
            if ov or self._xtra:
                # the ROUTING EPOCH + overlay + migrated-in block state
                # ride the checkpoint, so a restored fleet routes (and
                # serves) exactly like the live peers it rejoins. An
                # EMPTY overlay (every block back home) is deliberately
                # not recorded even at epoch > 0: the layout is exactly
                # the base partition again, so the checkpoint stays
                # elastic-reshardable and restores epoch-0 everywhere
                # (consistent fleet-wide — all ranks restore one step)
                out["ep"] = np.asarray(ep)
                out["rb_block"] = np.asarray(self.router.block_size)
                out["ovb"] = np.asarray(sorted(ov), np.int64)
                out["ovo"] = np.asarray([ov[b] for b in sorted(ov)],
                                        np.int64)
                out["xtra"] = {
                    str(b): {k: v.copy() for k, v in st.items()
                             if v is not None}
                    for b, st in self._xtra.items()}
        return out

    def load_shard_state_dict(self, state: dict) -> None:
        if int(state["lo"]) != self.shard_lo:
            raise ValueError(
                f"shard checkpoint lo={int(state['lo'])} belongs to a "
                f"different rank/partition (mine starts at {self.shard_lo})")
        ep = int(state["ep"]) if "ep" in state else 0
        if ep and self._rb is None:
            raise ValueError(
                "checkpoint was saved with a rebalanced (epoch "
                f"{ep}) routing table; restoring it requires "
                "MINIPS_REBALANCE so the overlay routing/serving "
                "machinery is armed")
        with self._state_lock:
            self._w[...] = state["w"]
            if self._acc is not None:
                if "acc" not in state:
                    raise ValueError("checkpoint lacks adagrad accumulator")
                self._acc[...] = state["acc"]
            if self._m is not None:
                if not {"m", "v", "steps"} <= set(state):
                    raise ValueError(
                        "checkpoint lacks adam moments/step counters")
                self._m[...] = state["m"]
                self._v[...] = state["v"]
                self._steps[...] = state["steps"]
            if ep:
                blk = int(state.get("rb_block", self.router.block_size))
                if blk != self.router.block_size:
                    # the overlay's block ids are meaningless at another
                    # granularity — rebuild the router at the saved one,
                    # and the heat accountant with it (its counters are
                    # indexed by the router's block id space)
                    from minips_tpu_torch.balance.heat import HeatAccountant

                    self.router = BlockRouter(self.part, blk)
                    self._heat = HeatAccountant(self.router.num_blocks,
                                                self._heat.decay)
                ov = {int(b): int(o) for b, o in
                      zip(np.asarray(state["ovb"]).tolist(),
                          np.asarray(state["ovo"]).tolist())}
                if self.router.apply(ep, ov) is None and \
                        self.router.epoch != ep:
                    raise ValueError(
                        f"checkpoint routing epoch {ep} is older than "
                        f"the live table's {self.router.epoch}")
                self._xtra = {
                    int(b): {k: np.array(v) for k, v in st.items()}
                    for b, st in (state.get("xtra") or {}).items()}

    # Checkpointer-protocol aliases: each process checkpoints ITS OWN
    # shard (the reference dumps per-server KVTable state, SURVEY.md §3.5)
    # into a rank-scoped directory — recovery = relaunch at the same world
    # size, every rank reloading its range (ckpt/checkpoint.py interface).
    state_dict = shard_state_dict
    load_state_dict = load_shard_state_dict


def tables_hist_stats(tables) -> dict:
    """The done-line ``hist`` block over a set of tables: client-side
    pull latency / blocked time / push-ack latency (CommTimers) plus
    server-side serve duration / park duration, each as a log2-bucket
    p50/p95/p99 summary. Shared by the trainer and the bench worker's
    standalone (no-trainer) path so the layout cannot fork."""
    tables = list(tables)
    tsnap = CommTimers.merge_snapshots(
        [t.timers.snapshot() for t in tables])
    serve = merge_counts([t.hist_serve.snapshot() for t in tables])
    park = merge_counts([t.hist_park.snapshot() for t in tables])
    fence = merge_counts([t.hist_fence.snapshot() for t in tables])
    # replica serve durations (serve/plane.py): merge_counts([]) is all
    # zeros, so plane-off runs report {"count": 0} like every idle
    # quantity here — the serve plane's own off-vs-idle distinction
    # lives in the done line's serve.replica block (None = off)
    replica = merge_counts([t._sv.hist_replica.snapshot()
                            for t in tables if t._sv is not None])
    return {
        "pull_latency_ms": summarize_counts(
            tsnap["hists"]["pull_latency"]),
        "pull_blocked_ms": summarize_counts(
            tsnap["hists"]["pull_blocked"]),
        "push_ack_ms": summarize_counts(tsnap["hists"]["push_ack"]),
        "serve_ms": summarize_counts(serve),
        "park_ms": summarize_counts(park),
        "fence_ms": summarize_counts(fence),
        "replica_serve_ms": summarize_counts(replica),
    }


class ShardedPSTrainer:
    """Clock/gate/finalize driver over a set of ShardedTables — the Engine-
    side loop of the sharded PS (pull → compute → push → clock → gate).

    The app owns the compute (jitted model math on pulled rows); this class
    owns consistency (StalenessGate), the finalize barrier, and aggregate
    wire/memory accounting.
    """

    def __init__(self, tables: dict[str, ShardedTable], bus,
                 num_processes: int, *, staleness: float = 0,
                 gate_timeout: float = 60.0, monitor=None,
                 rebalance: Optional[str] = None,
                 serve: Optional[str] = None,
                 elastic: Optional[str] = None,
                 reshard: Optional[str] = None,
                 autoscale: Optional[str] = None,
                 hedge: Optional[str] = None,
                 slow: Optional[str] = None,
                 hier: Optional[str] = None,
                 plane: Optional[str] = None,
                 tenant: Optional[str] = None,
                 slo: Optional[str] = None):
        # data-plane selection at the same altitude as the bus backends
        # (train/mesh_plane.resolve_plane: explicit wins, else
        # $MINIPS_MESH): this bus-backed trainer IS the host-wire plane;
        # plane="mesh" names the in-mesh collective plane, which has no
        # bus or per-process tables to drive — construct it via
        # train/mesh_plane.MeshPlane (apps route on the same knob,
        # e.g. sharded_ps_bench --plane mesh)
        from minips_tpu_torch.train.mesh_plane import resolve_plane

        self.plane = resolve_plane(plane)
        if self.plane == "mesh":
            raise ValueError(
                "plane='mesh' selects the in-mesh collective data plane "
                "(one process, device gang) — build it with "
                "minips_tpu_torch.train.mesh_plane.MeshPlane(num_ranks, ...) "
                "instead of the bus-backed ShardedPSTrainer. Entrypoints "
                "with mesh support route on this knob themselves "
                "(sharded_ps_bench --plane mesh); one without it refuses "
                "HERE rather than silently publishing host-wire numbers "
                "under a mesh selection — unset MINIPS_MESH to run this "
                "app on the host wire")
        self.tables = tables
        self.bus = bus
        self.num_processes = num_processes
        self.staleness = staleness
        self.monitor = monitor
        self.clock = 0
        # the newest clock whose gate has PASSED — the serving plane's
        # read stamp (pull_serving): admission for it is already proven
        # fleet-wide, so serving reads never park on the in-flight step
        self.gated_clock = 0
        _trc.maybe_init(bus.my_id)  # MINIPS_TRACE: arm the wire tracer
        _fl.maybe_init(bus.my_id)   # flight recorder: ON unless =0
        self.gossip = ClockGossip(bus, num_processes, workers_per_process=1)
        self.gate = StalenessGate(self.gossip, staleness,
                                  timeout=gate_timeout, monitor=monitor)
        self._flushed: set[int] = set()
        self._acked: set[int] = set()
        self._byes: set[int] = set()
        self._fin_cond = threading.Condition()
        bus.on("psFlush", self._on_flush)
        bus.on("psFlushAck", self._on_flush_ack)
        bus.on("psBye", self._on_bye)
        # server-side admission: tables park pulls until my view of the
        # global min clock admits them; every clock/exclusion change drains
        for t in tables.values():
            t.bind_consistency(self)
        self.gossip.add_listener(self._drain_parked)
        # multi-tenant tables (tenant/registry.py): OFF by default —
        # explicit spec wins, else $MINIPS_TENANT. Bound FIRST among
        # the optional layers: the registry's per-tenant block/rate/
        # burst/replica/hedge budgets override the fleet-wide knobs
        # inside attach_rebalancer / the serve plane / attach_hedge,
        # so every table must carry its tenant id before those arm.
        # bind() assigns deterministic 1-based ids (spec order; the
        # bare-"1" default takes sorted table-name order) — every rank
        # computes the same assignment, and the per-frame "tb" stamp
        # poisons the table if one didn't.
        from minips_tpu_torch.tenant.registry import maybe_registry as _mt

        self.tenant_registry = _mt(tenant)
        if self.tenant_registry is not None:
            self.tenant_registry.bind(tables)
            for name, t in tables.items():
                t.attach_tenant(self.tenant_registry.spec_for(name))
        # heat-aware shard rebalancing (balance/): OFF by default —
        # explicit spec wins, else $MINIPS_REBALANCE, else disabled.
        # The elastic membership plane (below) needs the migration
        # MACHINERY either way: when only MINIPS_ELASTIC is armed the
        # rebalancer is constructed with its heat planner disabled —
        # here, not later, because attach_rebalancer rebuilds the
        # router/heat that the serve plane must see final.
        spec = rebalance if rebalance is not None \
            else os.environ.get("MINIPS_REBALANCE", "")
        espec = elastic if elastic is not None \
            else os.environ.get("MINIPS_ELASTIC", "")
        if espec == "0":
            espec = ""
        self.rebalancer = None
        if (spec and spec != "0") or espec:
            from minips_tpu_torch.balance.rebalancer import (
                RebalanceConfig, Rebalancer)

            heat_on = bool(spec and spec != "0")
            self.rebalancer = Rebalancer(
                self, RebalanceConfig.parse(spec if heat_on else ""),
                plan_heat=heat_on)
        # read-mostly serving plane (serve/): OFF by default — explicit
        # spec wins, else $MINIPS_SERVE, else disabled. Constructed
        # AFTER the rebalancer: attach_rebalancer rebuilds router+heat
        # at its block granularity and the serve plane must see the
        # final ones.
        sspec = serve if serve is not None \
            else os.environ.get("MINIPS_SERVE", "")
        self.serve_plane = None
        if sspec and sspec != "0":
            from minips_tpu_torch.serve.plane import ServeConfig, ServePlane

            self.serve_plane = ServePlane(self, ServeConfig.parse(sspec))
        # elastic membership (balance/membership.py): OFF by default —
        # ranks join/leave the live job, deaths restore from the
        # elastic checkpoint onto survivors. Constructed LAST: it rides
        # the rebalancer (armed above) and hooks the monitor/gate.
        self.membership = None
        if espec:
            from minips_tpu_torch.balance.membership import (
                Membership, MembershipConfig)

            self.membership = Membership(self,
                                         MembershipConfig.parse(espec))
            self.gate.membership = self.membership
            for t in tables.values():
                t.attach_membership(self.membership)
        # planned collective redistribution (balance/redistribute.py):
        # OFF by default — explicit spec wins, else $MINIPS_RESHARD.
        # Armed, every migration state ship (rebalance plans, demote
        # drains, membership evacuations) runs as cap-bounded slice
        # ROUNDS instead of whole-block point-to-point snapshots; the
        # plan is a pure function of the overlay diff, so arming rides
        # the migration machinery above.
        from minips_tpu_torch.balance import redistribute as _rd

        self.reshard_cfg = _rd.maybe_config(reshard)
        if self.reshard_cfg is not None:
            if self.rebalancer is None:
                raise ValueError(
                    "MINIPS_RESHARD schedules the epoch-fenced "
                    "migration's state rounds — arm MINIPS_REBALANCE "
                    "or MINIPS_ELASTIC too (there is no migration "
                    "wire to plan without them)")
            for t in tables.values():
                t.attach_reshard(self.reshard_cfg)
        # closed-loop autoscaler (balance/autoscaler.py): OFF by
        # default — a decision loop on the coordinator lease holder
        # that watches serve-plane shed counters / SERVE-SLO p99 /
        # heat imbalance off the rbH wire and drives mbJ admits + mbDr
        # drains with hysteresis. Rides the membership plane.
        aspec = autoscale if autoscale is not None \
            else os.environ.get("MINIPS_AUTOSCALE", "")
        self.autoscaler = None
        if aspec and aspec != "0":
            if self.membership is None:
                raise ValueError(
                    "MINIPS_AUTOSCALE drives elastic membership "
                    "transitions — arm MINIPS_ELASTIC too (the "
                    "autoscaler has nothing to scale without it)")
            from minips_tpu_torch.balance.autoscaler import (
                AutoscaleConfig, Autoscaler)

            self.autoscaler = Autoscaler(
                self, self.membership, AutoscaleConfig.parse(aspec))
        # fail-slow plane (serve/hedge.py + obs/slowness.py): OFF by
        # default — explicit specs win, else $MINIPS_HEDGE /
        # $MINIPS_SLOW. Hedging is pure client-side read mitigation
        # (it needs the serve plane's replica holders to have a target
        # — armed without one it only ever counts no_holder, the
        # documented limit). The SlownessMonitor is the detection
        # rung: per-peer latency fed from the leg/ack paths, rolled at
        # every clock boundary; with the membership plane armed its
        # suspicions gossip on heartbeats (slw ballots) and convict by
        # the same strict-majority quorum as death — bind AFTER
        # membership so the hook wiring sees it.
        from minips_tpu_torch.obs import slowness as _slw
        from minips_tpu_torch.serve import hedge as _hg

        self.hedge_cfg = _hg.maybe_config(hedge)
        if self.hedge_cfg is not None:
            for t in tables.values():
                t.attach_hedge(self.hedge_cfg)
        # hierarchical push tree (balance/hier.py): OFF by default —
        # explicit spec wins, else $MINIPS_HIER. Armed AFTER
        # bind_consistency (the tables' _my_clk/_excluded_ranks feeds)
        # and checked against the heat rebalancer: a mid-run routing
        # overlay would re-home keys whose mass sits in a leader's
        # buckets, and the leader flushes by the MEMBER's routing —
        # elastic membership stays allowed (death plans only move a
        # corpse's keys, and a dead leader's members fall back first).
        from minips_tpu_torch.balance import hier as _hr

        self.hier_cfg = _hr.maybe_config(hier)
        if self.hier_cfg is not None:
            if self.hier_cfg.agg and self.hier_cfg.group > 1 \
                    and self.rebalancer is not None \
                    and getattr(self.rebalancer, "plan_heat", False):
                raise ValueError(
                    "MINIPS_HIER aggregation is incompatible with the "
                    "heat rebalancer (MINIPS_REBALANCE): a routing "
                    "overlay adopted mid-boundary would re-route keys "
                    "already bucketed at a leader under the old table. "
                    "Run hier with MINIPS_ELASTIC only, or keep the "
                    "flat wire under rebalancing")
            for t in tables.values():
                t.attach_hier(self.hier_cfg)
            if (self.hier_cfg.agg == "mesh"
                    and self.hier_cfg.group > 1
                    and self.membership is not None):
                # hybrid plane: a mesh host is ONE failure domain —
                # slow verdicts demote the whole host group
                self.membership.bind_failure_domains(
                    self.hier_cfg.group)
            if self.hier_cfg.agg and self.hier_cfg.group > 1:
                _fl.record("hier_leader_elect", {
                    "table": "*", "old": -1,
                    "new": -1 if (lead := _hr.elect(
                        _hr.group_ranks(bus.my_id, self.hier_cfg.group,
                                        num_processes))) is None
                    else int(lead)})
        self.slowness = _slw.maybe_build(bus.my_id, num_processes, slow)
        if self.slowness is not None:
            for t in tables.values():
                t.bind_slowness(self.slowness)
            self.gate.on_behind = self.slowness.note_behind
            if self.membership is not None:
                self.membership.bind_slowness(self.slowness,
                                              self.slowness.cfg)
        if self.rebalancer is not None:
            # adopt plans (and, at the coordinator, issue pending death
            # transitions) while GATE-blocked too, not just while
            # pull-blocked: the gate runs on the push-driving thread at
            # the clock boundary (post-drain), so adoption here is the
            # same fence point as the next tick's — and without it a
            # rank gate-blocked on a lagging peer can deadlock against
            # that peer's epoch-parked pull (gate.py poll_hook note)
            self.gate.poll_hook = self._gate_poll
        # seeded process-death injection (comm/chaos.py,
        # $MINIPS_CHAOS_KILL): armed per-rank, checked at every tick —
        # the launcher-level kill drill every sharded app inherits
        from minips_tpu_torch.comm.chaos import install_chaos_kill

        self._kill_check = install_chaos_kill(bus.my_id, num_processes)
        # step-windowed partition injection (comm/chaos.py part=
        # entries): the injector keys its windows on the RECEIVER's
        # clock, fed from the same tick point as the kill check — None
        # when chaos is off or carries no partition entries, so the
        # common tick pays one attribute load
        ch = getattr(bus, "chaos", None)
        self._chaos_clock = (ch.on_clock if ch is not None
                             and ch.spec.partitions else None)
        # windowed metrics layer (obs/window.py): ALWAYS ON
        # (MINIPS_OBS=0 only for the OBS-TAX honesty arm) — rolled at
        # every clock boundary, it is what turns the cumulative hists/
        # counters above into "now" signals: the autoscaler's p99
        # arming reads it (balance/rebalancer._send_heat), the done
        # line's "window" block reports it, and the flight recorder
        # snapshots it into every dump. Built LAST so registration can
        # see every armed subsystem.
        self.obs_window = _ow.maybe_build()
        if self.obs_window is not None:
            self._register_window_signals()
        # per-tenant SLO burn-rate accounting (obs/slo.py): OFF by
        # default — explicit spec wins, else $MINIPS_SLO. Built after
        # the windowed layer (both its windows read windowed counts;
        # SloTracker refuses a None window itself) and after tenancy
        # bound (tenants are the keying). Its burning set feeds the
        # serve plane's promotion budget and the autoscaler's arming
        # pressure — both read ``trainer.slo_tracker`` lazily, so
        # construction order against them does not matter.
        from minips_tpu_torch.obs import slo as _slo

        slo_cfg = _slo.maybe_config(slo)
        self.slo_tracker = None
        if slo_cfg is not None:
            tenants = (list(self.tables)
                       if self.tenant_registry is not None else [])
            self.slo_tracker = _slo.SloTracker(
                slo_cfg, self.obs_window, tenants)
        fl = _fl.FLIGHT
        if fl is not None:
            # the black box's final windowed-metrics snapshot: every
            # dump carries the fleet's last K intervals, not the
            # since-boot aggregate (None when the window layer is off)
            fl.snapshot_hook = (self.window_stats
                                if self.obs_window is not None
                                else None)

    def _register_window_signals(self) -> None:
        """Point the windowed layer at every cumulative signal the
        stack already keeps — no second recording path anywhere: the
        hot paths keep feeding the one histogram/counter, the window
        snapshots deltas once per clock boundary. Layers that are off
        simply never register (their done-line window entries are
        absent, matching their None top-level blocks)."""
        ow = self.obs_window

        def _hist_fn(hists):
            if len(hists) == 1:
                # the common one-table shape: hand the ROLL the live
                # counts list — roll's own list(fn()) is the only copy
                # (reading int buckets under the GIL is safe; a racing
                # increment lands in the next interval's delta). The
                # roll runs once per clock boundary, but a 3-way
                # oversubscribed host still notices every extra lock
                # hop and copy in it.
                h = hists[0]
                return lambda: h.counts
            return lambda: merge_counts([h.snapshot() for h in hists])

        tables = list(self.tables.values())
        for name in ("pull_latency", "pull_blocked", "push_ack"):
            ow.register_hist(name, _hist_fn(
                [t.timers.hists[name] for t in tables]))
        ow.register_hist("serve",
                         _hist_fn([t.hist_serve for t in tables]))
        ow.register_hist("park",
                         _hist_fn([t.hist_park for t in tables]))
        ow.register_hist("fence",
                         _hist_fn([t.hist_fence for t in tables]))
        ow.register_counter("frames_dropped",
                            lambda: self.frames_dropped)
        ow.register_counter("wire_frames_lost",
                            lambda: self.wire_frames_lost)
        ow.register_counter("gate_waits",
                            lambda: self.gate.gate_waits)
        if self.serve_plane is not None:
            ow.register_hist("replica_serve", lambda: merge_counts(
                [t._sv.hist_replica.snapshot() for t in tables
                 if t._sv is not None]))

            def _sv_sig(key):
                return lambda: sum(
                    t._sv.load_signal()[key] for t in tables
                    if t._sv is not None)

            ow.register_counter("shed", _sv_sig("shed"))
            ow.register_counter("backpressure", _sv_sig("bp"))
            # push-visible-at-replica lag (obs/freshness.py): the
            # fleet's windowed freshness quantiles — per-tenant twins
            # register below with the other per-tenant signals
            ow.register_hist("freshness", lambda: merge_counts(
                [t._sv.fresh.hist.snapshot() for t in tables
                 if t._sv is not None]))
        if getattr(self, "tenant_registry", None) is not None:
            # per-tenant SLO telemetry: each tenant's own windowed
            # pull tail (the heat report's p99 reads
            # ``pull_latency:{table}`` instead of the fleet blend —
            # balance/rebalancer._send_heat) plus its attributed deny
            # counters, so "who is being shed" is a window read
            for name, t in self.tables.items():
                ow.register_hist(f"pull_latency:{name}", _hist_fn(
                    [t.timers.hists["pull_latency"]]))
                ow.register_counter(
                    f"shed:{name}",
                    lambda t=t: t.tenant_counters["shed"])
                ow.register_counter(
                    f"throttle:{name}",
                    lambda t=t: t.tenant_counters["throttle"])
                if t._sv is not None:
                    # the tenant's own freshness tail — what its SLO
                    # burn (obs/slo.py) is judged on
                    ow.register_hist(f"freshness:{name}", _hist_fn(
                        [t._sv.fresh.hist]))
        if self.hedge_cfg is not None:
            ow.register_counter(
                "hedges_fired",
                lambda: sum(t.hedge_counters["fired"]
                            for t in tables))
        if self.hier_cfg is not None:

            def _hier_sig(key):
                return lambda: sum(t.hier_counters[key]
                                   for t in tables)

            ow.register_counter("hier_l2_bytes",
                                _hier_sig("l2_tx_bytes"))
            ow.register_counter("hier_agg_frames",
                                _hier_sig("agg_frames"))
            ow.register_counter("hier_fallbacks",
                                _hier_sig("fallbacks"))
            ow.register_hist("hier_flush", _hist_fn(
                [t.hist_hier for t in tables]))
        rel = getattr(self.bus, "reliable", None)
        if rel is not None:
            ow.register_counter(
                "retransmits", lambda: rel.stats["retransmits_got"])
            ow.register_counter(
                "gave_up", lambda: rel.stats["gave_up"])
            ow.register_gauge("gap_age_s", rel.oldest_gap_age)
        if self.monitor is not None and hasattr(self.monitor,
                                                "stall_forgiven"):
            ow.register_counter(
                "hb_stall_forgiven",
                lambda: self.monitor.stall_forgiven)

    def _gate_poll(self) -> None:
        """Gate-wait poll (StalenessGate.poll_hook): the adoption and
        death-transition work the pull-wait loops already do, run from
        inside a blocked gate so a plan landing mid-wait is adopted on
        the push-driving thread instead of waiting for a tick that may
        never come."""
        if self.membership is not None:
            self.membership.poll()
        self.rebalancer.adopt_now()

    def admit_pull(self, clk: int) -> bool:
        """Reference ``model->Get`` admission: serve a pull stamped with
        requester clock ``clk`` iff global_min >= clk - staleness — the
        shared ``consistency.gate.admits`` predicate, which the client
        row cache also runs as its validity rule."""
        return admits(self.gossip.global_min(), clk, self.staleness)

    def admit_pull_s(self, clk: int, s: float) -> bool:
        """:meth:`admit_pull` under an explicit staleness bound — the
        per-tenant entry point (tenant/registry.py): a tenant with its
        own ``s`` is judged against THAT bound over the same gossip
        min, so one tenant's looser contract never loosens another's.
        ``ShardedTable._admit_clk`` probes for this method by name and
        falls back to :meth:`admit_pull` on stub consistency objects."""
        return admits(self.gossip.global_min(), clk, s)

    def serving_clock(self, requester: int) -> int:
        """The freshness certificate a table stamps on pull replies to
        ``requester``: my view of every OTHER worker's applied clock
        (``ClockGossip.min_excluding`` — per-link FIFO certifies the
        requester's own pushes separately, and the client keeps
        read-your-own-writes via push write-through/invalidation)."""
        return int(self.gossip.min_excluding(requester))

    def wait_admit_pull(self, clk: int,
                        timeout: Optional[float] = None) -> bool:
        """Condition-variable wait for :meth:`admit_pull` — the local-
        shard admission hook PullFuture.wait uses instead of polling."""
        if self.staleness == float("inf"):
            return True
        return self.gossip.wait_global_min(clk - int(self.staleness),
                                           timeout=timeout)

    def _drain_parked(self) -> None:
        for t in self.tables.values():
            t.serve_parked()

    def _on_flush(self, sender: int, payload: dict) -> None:
        # FIFO per link: every push `sender` addressed to me precedes its
        # flush broadcast, so by now my shards hold all its updates.
        with self._fin_cond:
            self._flushed.add(sender)
            self._fin_cond.notify_all()
        self.bus.send(sender, "psFlushAck", {})

    def _on_flush_ack(self, sender: int, payload: dict) -> None:
        with self._fin_cond:
            self._acked.add(sender)
            self._fin_cond.notify_all()

    def _on_bye(self, sender: int, payload: dict) -> None:
        with self._fin_cond:
            self._byes.add(sender)
            self._fin_cond.notify_all()

    # ------------------------------------------------------------------ api
    def table(self, name: str) -> ShardedTable:
        return self.tables[name]

    def tick(self) -> None:
        """Advance my clock, gossip it, and gate (BSP/SSP/ASP rule) —
        ``KVClientTable::Clock()``. With async push under a FINITE
        staleness bound the clock boundary DRAINS the send queue first:
        every step-``k`` push frame must be on the wire BEFORE my
        clock-``k`` frame so per-link FIFO keeps the staleness proof
        intact (an undrained queue would silently widen staleness past
        the bound). Under ASP (``staleness=inf``) there is no bound for
        the drain to protect — admission always passes — so the clock
        frame goes out immediately and the sender keeps draining behind
        the next step's compute: the fully-overlapped pipeline the bench
        measures. Ack settlement — pure loss detection — stays off the
        step path in both regimes: the window/queue backpressure bounds
        it and finalize() hard-drains it."""
        if self._kill_check is not None:
            # seeded death drill: SIGKILL lands HERE, before the drain
            # and before the clock frame — the corpse's last published
            # clock is the previous step's, exactly a mid-step loss
            self._kill_check(self.clock)
        if self._chaos_clock is not None:
            # partition windows advance on the same boundary currency
            # as the kill drill: "at=8" cuts from the moment this rank
            # reaches clock 8
            self._chaos_clock(self.clock)
        if self.obs_window is not None:
            # close the previous step's metrics interval BEFORE any
            # control decision below (autoscaler signals, rbH reports)
            # reads a windowed value — the roll is this boundary's one
            # snapshot pass over the cumulative hists/counters
            self.obs_window.roll()
            if self.slo_tracker is not None:
                # burn evaluation rides the roll it just closed: the
                # fast window always includes the newest interval, and
                # the burning set is settled BEFORE the autoscaler
                # below reads it as pressure (and before the serve
                # plane's post-gate promotion reads the boost)
                self.slo_tracker.on_roll()
        if self.slowness is not None:
            # the fail-slow judgment rolls on the same boundary, BEFORE
            # the membership/rebalancer decisions below read verdicts:
            # a suspicion raised here rides this boundary's heartbeat
            # ballot, and the planner's demotion bias sees the freshest
            # quorum view. Dead/left ranks leave the judged set first —
            # a corpse's tail is the death path's business.
            for p in self.gossip.excluded:
                self.slowness.exclude(p)
            self.slowness.roll()
        drain = self.staleness != float("inf")
        for t in self.tables.values():
            if drain:
                t.flush_pushes(acks=False)  # a jammed drain poisons…
            # aged error-feedback residuals ship BEFORE the clock frame
            # (same per-link ordering argument as the drain above): a
            # withheld write may trail its push by at most `staleness`
            # boundaries — the compressed wire's half of the SSP story
            t.residual_flush(aged_only=True)
            # hier boundary LAST in the per-table block and ALWAYS
            # (ASP included — floors advance even when admission is
            # vacuous): this step's contributions and residual flushes
            # are on their links, so the boundary certificate is true,
            # and it precedes my clock frame like everything above
            t.hier_boundary()
            t.check_fatal()                 # …and this raises, no hang
        if self.autoscaler is not None:
            # BEFORE the membership queues run: an admit credit granted
            # here is consumed by membership.on_tick at this same
            # boundary on the lease holder (non-holders no-op)
            self.autoscaler.on_tick()
        if self.membership is not None:
            # BEFORE the rebalancer's adoption point: a transition plan
            # issued here is adopted in this same tick at the
            # coordinator, at the next boundary everywhere else
            self.membership.on_tick()
        if self.rebalancer is not None:
            # THE clock boundary: step-k pushes are drained to the bus
            # above, the clock frame has not gone out yet — adopt any
            # pending routing table here (epoch fence point), decay +
            # gossip heat, and (coordinator) maybe plan a migration
            self.rebalancer.on_tick()
        self.clock += 1
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("clock", "tick", {"clock": self.clock})
        self.gossip.publish_local([self.clock])
        self.gate.wait(self.clock)
        self.gated_clock = self.clock
        if self.serve_plane is not None:
            # AFTER the gate on purpose: the gate just proved
            # global_min >= clock - s, so a replica refresh stamped
            # HERE is admissible at the current clock for the whole
            # upcoming step window — refreshing before the gate ships
            # stamps one step staler and replicas refuse most reads
            # (measured: the storm's replica hit rate collapses)
            self.serve_plane.on_tick()
        for t in self.tables.values():
            t.cache_age()  # rows un-admittable at the new clock die here

    def retire(self) -> None:
        """Out of data: the shared sentinel clock (gate.py RETIRED_CLOCK)
        so peers' gates (and owner-side pull admission) never wait on this
        finished worker — dynamic block assignment makes per-worker step
        counts unequal."""
        from minips_tpu_torch.consistency.gate import publish_clock

        self._retired = True
        publish_clock(self.gossip, self.clock, True)

    def finalize(self, timeout: float = 30.0) -> None:
        """Two-sided quiesce: my pushes applied at all owners (their acks)
        AND all peers' pushes applied at my shards (their flushes). After
        this, pull/pull_all return identical rows on every live process."""
        if self.membership is not None:
            self.membership.quiesce()  # no further transitions
        if self.rebalancer is not None:
            # no further plans; a plan that landed after my last tick
            # still gets adopted + acked here so peers' fences release
            self.rebalancer.stop()
            self.rebalancer.adopt_now()
        if self.serve_plane is not None:
            # post-finalize agreement is EXACT, not staleness-bounded:
            # stop granting and stop routing my own pulls to replicas
            # (their leases go dark by expiry; no revoke frames race
            # the shutdown barrier)
            self.serve_plane.quiesce()
        for t in self.tables.values():
            # order matters (the adopt_table pattern): quiesce the hier
            # tree FIRST — a member's cross-host mass may sit in its
            # leader's buckets, and the psFlush below only certifies
            # MY links, so the tree must drain (leader flush or member
            # fallback) before the flush broadcast means anything —
            # then drain the async queue (a queued topk push encodes
            # on the sender thread and RETAINS fresh residuals, so
            # flushing before the drain would strand exactly the mass
            # the flush exists to ship), then flush the whole store
            # (post-finalize agreement is exact), then the hard ack
            # drain covers the flush frames too
            t.hier_finalize(timeout=timeout * 0.66)
            t.flush_pushes(acks=False)
            t.residual_flush(reason="fence")
            t.flush_pushes()  # async tail: drained before the flush frame
            t.check_fatal()
            t.cache_clear()   # post-finalize reads are exact, not bounded
        self.bus.publish("psFlush", {"clock": self.clock})
        from minips_tpu_torch.consistency.gate import publish_clock

        publish_clock(self.gossip, self.clock,
                      getattr(self, "_retired", False))
        peers = set(range(self.num_processes)) - {self.bus.my_id}
        deadline = time.monotonic() + timeout
        try:
            while True:
                if self.rebalancer is not None:
                    # a plan the coordinator issued after my adopt_now
                    # above: adopt it here, or my rbA never goes out and
                    # peers' fences (and their pulls parked on my stale
                    # epoch) hold to their deadlines
                    self.rebalancer.adopt_now()
                with self._fin_cond:
                    live = peers - self.gossip.excluded
                    if live <= self._flushed and live <= self._acked:
                        return
                    self._fin_cond.wait(timeout=0.5)
                dead = (self.monitor.check()
                        if self.monitor is not None else set())
                for p in dead:
                    self.gossip.exclude(p)
                if time.monotonic() > deadline:
                    with self._fin_cond:
                        live = peers - self.gossip.excluded
                        missing = sorted((live - self._flushed)
                                         | (live - self._acked))
                    _fl.poison("finalize_deadline",
                               {"missing": missing})
                    raise TimeoutError(
                        f"finalize: peers {missing} never quiesced")
        finally:
            # the per-rank trace AND the flight box survive the run
            # either way: a clean finalize dumps here, a poisoned one
            # dumps here AND again at atexit (idempotent) with
            # whatever events followed
            _trc.dump_now()
            _fl.dump_now()

    def shutdown_barrier(self, timeout: float = 10.0) -> None:
        """Rendezvous before closing the bus: finalize() only quiesces
        PUSHES; a peer's post-finalize pull_all still needs my server
        alive. Everyone announces 'bye' after its last pull and waits for
        all live peers' byes — then nobody's close() can strand a peer's
        in-flight pull. A timeout is tolerated (the straggler is either
        dead, which the monitor reports, or about to finish without us)."""
        self.bus.publish("psBye", {})
        peers = set(range(self.num_processes)) - {self.bus.my_id}
        deadline = time.monotonic() + timeout
        while True:
            with self._fin_cond:
                if peers - self.gossip.excluded <= self._byes:
                    return
                self._fin_cond.wait(timeout=0.25)
            dead = self.monitor.check() if self.monitor is not None else set()
            for p in dead:
                self.gossip.exclude(p)
            if time.monotonic() > deadline:
                return

    # ------------------------------------------------------------ checkpoint
    # The trainer is a "table" to ckpt.Checkpointer — PS state includes the
    # clock (SURVEY.md §5.4 "checkpointing optimizer state + clock vector").
    def state_dict(self) -> dict:
        return {"clock": np.asarray(self.clock)}

    def load_state_dict(self, state: dict) -> None:
        from minips_tpu_torch.consistency.gate import publish_clock

        self.clock = int(state["clock"])
        self.gated_clock = self.clock  # restored state is settled state
        # publish the restored clock NOW (not at the first tick): a resumed
        # rank's first pull is stamped with this clock, and owners park it
        # until their view of every peer reaches clock - s — peers that
        # haven't announced their restored clocks still read as 0. All
        # ranks restore before stepping, so these publishes un-park each
        # other; without them resume deadlocks at the first pull.
        publish_clock(self.gossip, self.clock,
                      getattr(self, "_retired", False))

    # ------------------------------------------------------------- metrics
    @property
    def gate_waits(self) -> int:
        return self.gate.gate_waits

    @property
    def max_skew_seen(self) -> int:
        return self.gate.max_skew_seen

    @property
    def frames_dropped(self) -> int:
        return sum(t.frames_dropped for t in self.tables.values())

    @property
    def wire_frames_lost(self) -> int:
        """Bus-level frames provably lost on established streams (zmq HWM
        drops / torn link tails — comm/bus.py FrameLossTracker). Disjoint
        from frames_dropped (frames that ARRIVED but were rejected). With
        the reliable channel on (comm/reliable.py) this is UNRECOVERED
        loss only — a retransmitted frame that landed never counts."""
        return getattr(self.bus, "frames_lost", 0)

    @property
    def wire_frames_malformed(self) -> int:
        """Undecodable control frames dropped at receive — counted, not
        silently swallowed (comm/bus.py dispatch_message); nonzero means
        a stale run's tail or genuine wire corruption."""
        return getattr(self.bus, "frames_malformed", 0)

    def reliable_stats(self) -> Optional[dict]:
        """Retransmission-protocol counters (comm/reliable.py snapshot):
        None when the channel is off, so scrapers can tell 'off' from
        'clean'. nacks/retransmits > 0 with frames_lost == 0 is the
        layer working as designed — loss became latency."""
        rel = getattr(self.bus, "reliable", None)
        return rel.snapshot() if rel is not None else None

    def chaos_stats(self) -> Optional[dict]:
        """Fault-injection counters (comm/chaos.py) when a chaos drill
        is armed; None in production runs."""
        ch = getattr(self.bus, "chaos", None)
        return ch.snapshot() if ch is not None else None

    def drop_detail(self) -> dict:
        out = {"malformed": 0, "misrouted": 0, "config": 0}
        for t in self.tables.values():
            for k, v in t.drops.items():
                out[k] += v
        return out

    def comm_timing(self) -> dict:
        """Aggregate per-leg wire timing over all tables: pull issue→
        reply latency, blocked time, overlap fraction, push ack latency,
        plus rows-requested/rows-wire and cache hit counters
        (utils/timing.CommTimers.summary fields)."""
        return CommTimers.aggregate(
            [t.timers for t in self.tables.values()])

    def hist_stats(self) -> dict:
        """Log2 latency histograms over all tables, as p50/p95/p99
        summary blocks (obs/hist.py) — the done-line ``hist`` field.
        Always a dict (the layer is always on); a quantity with no
        samples yet reports ``{"count": 0}`` — idle, not off."""
        return tables_hist_stats(self.tables.values())

    def window_stats(self) -> Optional[dict]:
        """The done-line ``window`` block (obs/window.py record): per-
        signal quantiles/rates over the last K clock boundaries. None
        when the layer is OFF (``MINIPS_OBS=0``); an armed-but-idle
        window reports ``{"count": 0}`` per hist — the obs
        off-vs-idle convention, pinned by the schema test."""
        return (self.obs_window.record()
                if self.obs_window is not None else None)

    def heartbeat_stats(self) -> Optional[dict]:
        """Liveness-layer counters (comm/heartbeat.py stats): the
        ``stall=`` forgiveness window's arming and HITS — a forgiven
        stall is detection latency the operator traded for and must be
        visible, not silent. None when no monitor is attached."""
        mon = self.monitor
        if mon is None or not hasattr(mon, "stats"):
            return None
        return mon.stats()

    def hedge_stats(self) -> Optional[dict]:
        """Hedged-pull counters summed over tables (serve/hedge.py):
        None when hedging is OFF, all-zero when armed-but-idle — the
        off-vs-idle done-line convention. ``fired``/``won``/``lost``
        prove engagement; ``no_holder`` counts the honest no-replica
        ceiling; ``denied`` the budget valve."""
        if self.hedge_cfg is None:
            return None
        out = {k: 0 for k in ("fired", "won", "lost", "no_holder",
                              "denied")}
        for t in self.tables.values():
            for k, v in t.hedge_counters.items():
                out[k] += v
        out["delay_ms"] = self.hedge_cfg.delay_ms or None
        out["budget"] = self.hedge_cfg.budget
        return out

    def hier_stats(self) -> Optional[dict]:
        """Two-level push-tree counters summed over tables
        (balance/hier.py): None when MINIPS_HIER is off, all-zero
        byte/frame counters when armed-but-idle (``group=1``) — the
        off-vs-idle done-line convention. ``l1_*``/``l2_*`` split the
        wire by level (the HIER-WIN gate reads l2, the leader leg);
        ``elections``/``fallbacks``/``repushed_steps`` tell the
        leader-death story; ``stale_leader_drops``/``repush_drops``
        count the exactly-once fences doing their job."""
        if self.hier_cfg is None:
            return None
        out: dict = {}
        for t in self.tables.values():
            for k, v in t.hier_counters.items():
                out[k] = out.get(k, 0) + int(v)
        out["group"] = self.hier_cfg.group
        out["agg"] = self.hier_cfg.agg
        out["retain"] = self.hier_cfg.retain
        for t in self.tables.values():
            # every table elects from the same gossip inputs — one
            # table's live tree state speaks for the trainer (the
            # leader-death drill reads the post-heal leader here)
            st = t.hier_stats()
            out["leader"] = st["leader"]
            out["direct"] = st["direct"]
            break
        return out

    def hybrid_stats(self) -> Optional[dict]:
        """Hybrid data plane (``agg=mesh``) block for ``wire_record``:
        None when hier is off or the host f64 backend is configured,
        ALL-ZERO when armed but idle (``group=1`` never flushes) — the
        off-vs-idle convention, and all-NUMERIC by contract so sweep
        tooling can diff any two arms field-by-field (schema test)."""
        if self.hier_cfg is None or self.hier_cfg.agg != "mesh":
            return None
        out = {"backend_mesh": 0, "mesh_reduces": 0,
               "rows_reduced": 0, "mesh_collective_bytes": 0,
               "peak_stage_bytes": 0, "mesh_agg_fallbacks": 0,
               "domain_demotions": 0, "domain_down": 0}
        for t in self.tables.values():
            out["mesh_reduces"] += int(
                t.hier_counters["mesh_reduces"])
            out["mesh_agg_fallbacks"] += int(
                t.hier_counters["mesh_agg_fallbacks"])
            out["domain_demotions"] += int(
                t.hier_counters["domain_demotions"])
            out["domain_down"] = max(out["domain_down"],
                                     int(t._hier_domain_down))
            m = t._hier_mesh
            if m is not None:
                out["backend_mesh"] = max(out["backend_mesh"],
                                          int(m.m >= 2))
                out["rows_reduced"] += int(m.rows_reduced)
                out["mesh_collective_bytes"] += int(
                    m.collective_bytes)
                out["peak_stage_bytes"] = max(
                    out["peak_stage_bytes"], int(m.peak_stage_bytes))
        return out

    def slowness_stats(self) -> Optional[dict]:
        """Fail-slow detection state (obs/slowness.py): None when
        MINIPS_SLOW is off; armed runs carry the suspect set, per-peer
        windowed p99s, streaks, and — with the membership plane armed
        — the quorum's slow-verdict view."""
        if self.slowness is None:
            return None
        out = self.slowness.stats()
        mb = self.membership
        if mb is not None and hasattr(mb, "slow_stats"):
            out.update(mb.slow_stats())
        return out

    def serve_stats(self) -> dict:
        """Per-owner serve-load counters summed over tables (always on):
        requests/rows THIS process served as an owner — the done-line
        field sweeps compute max/mean per-shard serve load from, i.e.
        the partition-imbalance observable the rebalancer acts on.
        The ``replica`` sub-block carries the serving plane's counters
        (replica-served rows, shed/backpressure, lease refusals, SLO):
        None when the plane is OFF, all-zero counters when armed but
        idle — the obs off-vs-idle convention."""
        out = {"pull_requests": 0, "pull_rows": 0,
               "push_frames": 0, "push_rows": 0}
        for t in self.tables.values():
            with t._serve_lock:
                for k in out:
                    out[k] += t.serve[k]
        out["replica"] = (self.serve_plane.stats_record()
                          if self.serve_plane is not None else None)
        return out

    def tenant_stats(self) -> Optional[dict]:
        """Per-tenant SLO evidence (tenant/registry.py) — None when
        tenancy is off, zero counters when armed but idle (the
        off-vs-idle convention; the TENANT-IDLE gate pins the zeros).
        One block per tenant: its id, its spec'd overrides, the deny
        counters the serve plane attributed to ITS budget (shed =
        svS redirects, throttle = svB backpressure, stale_reads =
        replies its own ``s`` refused, hedge_denied = its hedge-budget
        valve), and its own serve-load counters — the per-tenant
        split of the fleet-summed signals, which could not separate them."""
        reg = getattr(self, "tenant_registry", None)
        if reg is None:
            return None
        by: dict = {}
        for name, t in self.tables.items():
            sp = t._tenant
            if sp is None:
                continue
            with t._serve_lock:
                tc = dict(t.tenant_counters)
                sv = dict(t.serve)
            by[name] = {"tid": sp.tid, **tc,
                        "pull_rows": sv["pull_rows"],
                        "push_rows": sv["push_rows"],
                        "overrides": sp.overrides()}
        return {"shared": int(reg.shared), "tenants": by}

    def freshness_stats(self) -> Optional[dict]:
        """Push-visible-at-replica lag (obs/freshness.py) — None when
        the serving plane is OFF (no replicas, nothing to be visible
        at), ``{"count": 0}`` lag summaries + zero counters when armed
        but idle (the off-vs-idle convention). ``fleet`` merges every
        table's tracker; ``tenants`` carries the per-table split (one
        tenant per table under tenancy) so the done line shows each
        tenant's freshness p50/p99 next to its read p99."""
        if self.serve_plane is None:
            return None
        from minips_tpu_torch.obs.freshness import merge_freshness

        trackers = {name: t._sv.fresh
                    for name, t in self.tables.items()
                    if t._sv is not None}
        return {"fleet": merge_freshness(list(trackers.values())),
                "tenants": {name: tr.record()
                            for name, tr in trackers.items()}}

    def slo_stats(self) -> Optional[dict]:
        """SLO burn-rate accounting (obs/slo.py) — None when MINIPS_SLO
        is off, zero counters and an empty burning set when armed but
        idle. Carries the fast/slow window shape, per-tenant burn
        ratios, the flight-evented burn/clear edge counts, and the
        promotion-budget proof (``boost_ticks``, per-tenant
        ``max_budget``)."""
        return (self.slo_tracker.record()
                if self.slo_tracker is not None else None)

    def rebalance_stats(self) -> Optional[dict]:
        """Rebalancer counters (balance/rebalancer.py) — None when the
        subsystem is off, so scrapers can tell 'off' from 'idle'."""
        return (self.rebalancer.stats()
                if self.rebalancer is not None else None)

    def reshard_stats(self) -> Optional[dict]:
        """Planned-redistribution counters summed over tables (peak
        staging is a MAX — the cap bounds each rank's worst round, not
        a sum) — None when MINIPS_RESHARD is off, zero counters when
        armed but idle (the off-vs-idle convention)."""
        per = [s for s in (t.reshard_table_stats()
                           for t in self.tables.values())
               if s is not None]
        if not per:
            return None
        out = {k: sum(s[k] for s in per)
               for k in ("plans", "rounds", "slices", "dup_slices",
                         "aborts", "blocks_inflight")}
        out["peak_stage_bytes"] = max(s["peak_stage_bytes"]
                                      for s in per)
        out["cap"] = per[0]["cap"]
        out["fanout"] = per[0]["fanout"]
        return out

    def membership_stats(self) -> Optional[dict]:
        """Elastic-membership counters (balance/membership.py): the
        live/standby/dead/left sets, the coordinator lease (term,
        holder, successions, fenced frames), transition counts, and
        restored blocks — None when MINIPS_ELASTIC is off (off vs
        idle)."""
        return (self.membership.stats()
                if self.membership is not None else None)

    def autoscale_stats(self) -> Optional[dict]:
        """Closed-loop autoscaler counters (balance/autoscaler.py):
        admits/drains, hot/calm tick streaks, pre/post-admit shed
        rates, p99 watermarks — None when MINIPS_AUTOSCALE is off
        (off vs idle)."""
        return (self.autoscaler.stats()
                if self.autoscaler is not None else None)

    def ef_stats(self) -> Optional[dict]:
        """Merged error-feedback residual counters over all tables —
        the done-line ``ef`` field (None when no table runs a
        compressed push wire; zero counters = armed but idle)."""
        per = [s for s in (t.ef_stats() for t in self.tables.values())
               if s is not None]
        if not per:
            return None
        return {k: sum(s[k] for s in per) for k in per[0]}

    def cache_stats(self) -> Optional[dict]:
        """Merged row-cache counters over all tables (None when every
        table runs cache-off) — the done-line 'cache' field."""
        per = [s for s in (t.cache_stats() for t in self.tables.values())
               if s is not None]
        if not per:
            return None
        out = {k: sum(s[k] for s in per)
               for k in ("hits", "lookups", "evictions", "invalidations",
                         "write_throughs", "rows", "bytes")}
        out["hit_rate"] = (round(out["hits"] / out["lookups"], 4)
                           if out["lookups"] else None)
        return out

    @property
    def bytes_pushed(self) -> int:
        return sum(t.bytes_pushed for t in self.tables.values())

    @property
    def bytes_pulled(self) -> int:
        return sum(t.bytes_pulled for t in self.tables.values())

    def local_bytes(self) -> int:
        return sum(t.local_bytes() for t in self.tables.values())
