"""Decayed per-key-block heat accounting on the PS serve path.

Every owner keeps ONE float64 counter per key block (parallel/partition
``BlockRouter`` granularity) and bumps the blocks a pull serve or push
apply touched — a single ``np.bincount`` per serve, no per-key Python
work, memory bounded by ``num_blocks`` (a few KB at the default ~128
blocks per shard). ``tick()`` multiplies everything by a decay factor,
so heat is an exponential moving count of recent touches: a block that
cooled off stops looking hot within a few clocks, which is what lets
the rebalancer's hysteresis avoid thrashing on transient spikes.

The accountant is a pure counter — it never routes anything. The
rebalancer (balance/rebalancer.py) reads :meth:`report` snapshots; the
done-line observability half (per-owner request/row serve counters)
lives directly on the table and is always on, rebalancer or not.

A copy of ``minips_tpu/balance/heat.py``, which imports no JAX.
"""

from __future__ import annotations

import threading

import numpy as np


class HeatAccountant:
    def __init__(self, num_blocks: int, decay: float = 0.8, *,
                 table_id: int = 0):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if not 0.0 <= decay <= 1.0:
            raise ValueError("decay must be in [0, 1]")
        if table_id < 0:
            raise ValueError("table_id must be >= 0")
        self.num_blocks = int(num_blocks)
        self.decay = float(decay)
        # tenancy namespace (tenant/registry.py): the owning table's
        # 1-based tenant id, 0 = tenancy off. Block ids are table-local
        # — two tenants' block 7 are different key ranges — so every
        # report is stamped with the id and the rebalancer refuses a
        # report whose stamp disagrees with the table it arrived on
        # (a crossed wire must never migrate the wrong tenant's keys).
        self.table_id = int(table_id)
        self._heat = np.zeros(self.num_blocks, np.float64)
        self._lock = threading.Lock()

    def global_key(self, block: int) -> tuple[int, int]:
        """The (table_id, block) pair that names a block fleet-wide —
        the namespaced form any cross-table consumer must key on."""
        return (self.table_id, int(block))

    def touch(self, blocks: np.ndarray, rows: int = 1) -> None:
        """Record served rows per touched block. ``blocks`` is one block
        id per served ROW (duplicates weight naturally); out-of-range
        ids (garbage keys a bounds check upstream already rejected) are
        dropped rather than growing the counter array."""
        blocks = np.asarray(blocks).reshape(-1)
        if blocks.size == 0:
            return
        if blocks.size and (blocks.min() < 0
                            or blocks.max() >= self.num_blocks):
            blocks = blocks[(blocks >= 0) & (blocks < self.num_blocks)]
            if blocks.size == 0:
                return
        counts = np.bincount(blocks, minlength=self.num_blocks)
        with self._lock:
            self._heat += counts * float(rows)

    def tick(self) -> None:
        """Exponential decay at the clock boundary."""
        with self._lock:
            self._heat *= self.decay

    @property
    def total(self) -> float:
        with self._lock:
            return float(self._heat.sum())

    def report(self, owned: np.ndarray, topk: int) -> dict:
        """The heat report an owner gossips to the coordinator: its
        ``topk`` hottest OWNED blocks individually (the movable
        candidates) plus the residual heat of the rest (counts toward
        the shard's load but is not offered for migration — keeps the
        report O(topk) regardless of table size)."""
        owned = np.asarray(owned).reshape(-1)
        with self._lock:
            h = self._heat[owned]
        total = float(h.sum())
        k = min(int(topk), owned.size)
        idx = np.argpartition(h, -k)[-k:] if k else np.empty(0, np.int64)
        idx = idx[np.argsort(-h[idx])]
        blocks = owned[idx]
        heats = h[idx]
        keep = heats > 0.0  # cold blocks are not candidates
        rep = {
            "total": total,
            "blocks": [int(b) for b in blocks[keep]],
            "heat": [float(x) for x in heats[keep]],
        }
        if self.table_id:
            rep["tb"] = self.table_id
        return rep

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._heat.copy()
