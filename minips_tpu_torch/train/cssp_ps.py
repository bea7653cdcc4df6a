"""CollectiveSSPPS — the port of ``minips_tpu/train/cssp_ps.py``: the
consistency axis over the flagship workload.

``train/ssp_spmd.py``'s CollectiveSSP gates collective syncs of a dense
LR table; this module takes the same axis to W&D/DeepFM's hashed
``SparseTable``s and dense deep tower (``PSTrainStep``): sparse embedding
PS shards under BSP/SSP/ASP, each process running the fused step, and so
the row-gather kernel (K1), on its own device.

A sparse table's cross-process delta is TABLE-shaped if merged densely,
but each process only touches the slots its batches hashed to, so the
merge is ROW-SPARSE:

- every process accumulates its touched slot ids host-side (the
  ``hash_to_slots_np`` twin of the device hash);
- at each sync round the processes allgather their touched-id arrays over
  the control bus (``comm.bus.BlobExchange``: host wire, sized by batch
  rows x sync_every) and compute the same sorted UNION;
- ONE ``[C, row]`` delta block per table leaf (embedding + optimizer
  rows) rides the collective plane (``SyncPlane.allreduce_sum``), C = the
  union size rounded up by :func:`sync_block_rows`. Traffic is
  O(touched rows x dim), never O(num_slots x dim).

Per leaf ``new = base + Σ_p (leaf_p − base)`` over the union rows; rows
nobody touched equal base everywhere, so the union merge is exact against
a dense merge. sgd rows are exact, adagrad accumulators (order-free sums)
are exactly a central server's, adam rows merge additively (step counts
exact, moments the documented local-SGD approximation). The deep tower
syncs like CollectiveSSP's dense vector.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable

import numpy as np
import torch

from minips_tpu_torch.comm import cluster
from minips_tpu_torch.comm.bus import BlobExchange
from minips_tpu_torch.consistency.gate import publish_clock
from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import (SparseTable, hash_to_slots_np,
                                            next_pow2)
from minips_tpu_torch.train.ssp_spmd import (SyncPlane, avg_table_opt_state,
                                             check_avg_opt_sync_supported,
                                             done_common, is_avg_leaf,
                                             make_control, staleness_for)

__all__ = ["CollectiveSSPPS", "sync_block_rows"]

PyTree = Any


def sync_block_rows(union_size: int, n_local: int) -> int:
    """Rows of the per-sync delta block: the union size rounded up to a
    power of two (few distinct block shapes) and then up to a MULTIPLE of
    ``n_local``, so that the block splits evenly over a process's
    devices: ``next_pow2`` alone is divisible by a device count that is
    not a power of two only by luck (6 devices, a union of 5: C=8)."""
    c = max(next_pow2(int(union_size)), int(n_local))
    return -(-c // int(n_local)) * int(n_local)


def rows_delta(cur: torch.Tensor, base: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """``(cur - base)`` at rows ``idx``, flattened; an index past the
    table (the padding sentinel ``num_slots``) gathers zeros, so padding
    rows contribute nothing to the sum."""
    valid = idx < cur.shape[0]
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    d = cur[safe] - base[safe]
    mask = valid.view((-1,) + (1,) * (d.dim() - 1))
    return torch.where(mask, d, torch.zeros_like(d)).reshape(-1)


def rows_apply(cur: torch.Tensor, base: torch.Tensor, idx: torch.Tensor,
               merged_flat: torch.Tensor) -> None:
    """``cur[idx] = base[idx] = base[idx] + merged`` in place, for the
    rows of ``idx`` inside the table (padding rows drop; the union is
    unique, so each real row lands once)."""
    rows = merged_flat.reshape((idx.shape[0],) + tuple(cur.shape[1:]))
    valid = idx < cur.shape[0]
    real = idx[valid]
    new_rows = base[real] + rows[valid]
    cur[real] = new_rows
    base[real] = new_rows


class CollectiveSSPPS:
    """Local fused PSTrainStep per process; staleness-gated row-sparse
    collective syncs for its sparse tables, vector syncs for its dense
    tables.

    Parameters
    ----------
    build_fn: ``(device) -> (ps, tables)``: the fused step and its tables
        on this process's device (``group=None``: each process holds its
        whole replica). ``tables`` is a name->table dict of DenseTable
        and SparseTable entries; anything else refuses. Every process
        builds identical tables (same seeds): the additive merge assumes
        a common base.
    staleness / sync_every / bus / monitor: as CollectiveSSP. The bus is
        REQUIRED multi-process: the clock gossip and the touched-row
        union exchange ride it.
    """

    def __init__(
        self,
        build_fn: Callable,
        *,
        staleness: float = 0,
        sync_every: int = 1,
        bus=None,
        monitor=None,
        gate_timeout: float = 60.0,
        exchange_timeout: float = 120.0,
        opt_sync: str = "local",
        device: DeviceLike = None,
    ):
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if opt_sync not in ("local", "avg"):
            raise ValueError(f"opt_sync must be 'local' or 'avg', got "
                             f"{opt_sync!r}")
        self.opt_sync = opt_sync
        self.staleness = staleness
        self.sync_every = int(sync_every)
        self.nprocs = cluster.process_count()
        if self.nprocs > 1 and bus is None:
            raise ValueError(
                "CollectiveSSPPS needs the control bus in multi-process "
                "runs: clock gossip AND the touched-row union exchange "
                "ride it (pass bus= from launch.init_from_env)")
        # register the blob handler BEFORE build_fn: a fast peer may
        # publish its first union while this process still builds
        self.exchange = (BlobExchange(bus, self.nprocs)
                         if bus is not None and self.nprocs > 1 else None)

        self.device = resolve_device(device)
        self.plane = SyncPlane(self.device)
        self.ps, tables = build_fn(self.device)
        for name, t in tables.items():
            if not isinstance(t, (DenseTable, SparseTable)):
                raise TypeError(f"table {name!r} is {type(t).__name__}; "
                                "CollectiveSSPPS syncs DenseTable and "
                                "SparseTable state only")
        self.dense = {k: t for k, t in tables.items()
                      if isinstance(t, DenseTable)}
        self.sparse = {k: t for k, t in tables.items()
                       if isinstance(t, SparseTable)}
        if opt_sync == "avg":
            for t in self.dense.values():
                check_avg_opt_sync_supported(t)
        for name in self.sparse:
            if self.ps.key_fns.get(name) is None:
                raise ValueError(
                    f"sparse table {name!r} has no key_fn on the fused "
                    "step — the host-side touched-slot tracking needs it")

        # ---- base snapshots (params = base + Σ deltas across procs) ----
        self._dense_base = {k: t.params.clone()
                            for k, t in self.dense.items()}
        self._sparse_base = {
            k: {ln: leaf.clone() for ln, leaf in self._leaves(t)}
            for k, t in self.sparse.items()}

        # ---- host-side control plane -----------------------------------
        self.clock = 0
        self.sync_rounds = 0
        self._synced_at = 0
        self._monitor = monitor
        self._xt = float(exchange_timeout)
        self.gossip, self._gate = make_control(
            bus, self.nprocs, staleness, monitor=monitor,
            timeout=gate_timeout)
        self._touched: dict[str, set] = {k: set() for k in self.sparse}
        self.sync_rows_max = 0       # largest padded union C seen
        self.union_rows = 0          # union rows merged, summed over rounds
        self.union_wire_bytes = 0    # host-wire bytes of the id exchange
        self.row_merge_bytes = 0     # collective bytes of the row merges
        self._last_emb_len = 0       # C*dim of the last emb merge

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _leaves(t: SparseTable):
        """(name, tensor) pairs of a sparse table's row-indexed state."""
        return [("emb", t.emb)] + [(k, getattr(t, k))
                                   for k in t._OPT_KEYS[t.updater]]

    # ------------------------------------------------------------ metrics
    @property
    def gate_waits(self) -> int:
        return self._gate.gate_waits if self._gate else 0

    @property
    def max_skew_seen(self) -> int:
        return self._gate.max_skew_seen if self._gate else 0

    def sync_record(self) -> list[dict]:
        """The collective of the LAST embedding-row merge (union-sized by
        construction: ``C*dim`` elements, never ``num_slots*dim``)."""
        if not self._last_emb_len:
            raise RuntimeError("no row merge has run yet")
        return self.plane.plan(self._last_emb_len)

    # ------------------------------------------------------------------ api
    def step(self, batch) -> float:
        """One LOCAL fused step on my batch rows, touched-slot tracking,
        clock tick, SSP gate, then (at sync boundaries) the merges."""
        loss = self.ps(self.ps.shard_batch(batch))
        for name, t in self.sparse.items():
            keys = np.asarray(self.ps.key_fns[name](batch))
            slots = hash_to_slots_np(keys.reshape(-1), t.num_slots,
                                     t.salt, t.identity)
            self._touched[name].update(np.unique(slots).tolist())
        self.clock += 1
        if self._gate is not None:
            publish_clock(self.gossip, self.clock, False)
            self._gate.wait(self.clock)
        if self.clock % self.sync_every == 0:
            self._sync()
        return float(loss)

    def _sync(self) -> None:
        """One merge round: dense vectors then sparse row blocks, every
        table in sorted-name order so all processes launch the same
        collective sequence."""
        rnd = self.sync_rounds
        if self.nprocs == 1:
            # a merge with zero peers is the IDENTITY, and it must be
            # bitwise (``base + (params - base)`` re-rounds in float):
            # only the bases refresh
            for name, t in self.dense.items():
                self._dense_base[name] = t.params.clone()
            for name, t in self.sparse.items():
                self._touched[name].clear()
                self._sparse_base[name] = {
                    ln: leaf.clone() for ln, leaf in self._leaves(t)}
            self.sync_rounds += 1
            self._synced_at = self.clock
            return
        for name in sorted(self.dense):
            t = self.dense[name]
            delta = t.params - self._dense_base[name]
            new = self._dense_base[name] + self.plane.allreduce_sum(delta)
            t.params = new
            self._dense_base[name] = new.clone()
            if self.opt_sync == "avg":
                avg_table_opt_state(t, self.plane)
        for name in sorted(self.sparse):
            self._sync_sparse(rnd, name)
        self.sync_rounds += 1
        self._synced_at = self.clock

    def _sync_sparse(self, rnd: int, name: str) -> None:
        t = self.sparse[name]
        mine = np.asarray(sorted(self._touched[name]), dtype=np.int64)
        self._touched[name].clear()
        # multi-process by construction: nprocs == 1 took _sync's identity
        # path, and __init__ rejected bus=None for nprocs > 1
        if self.exchange is None:
            raise RuntimeError("row-sparse merge without an exchange")
        parts = self.exchange.allgather(rnd, name, mine,
                                        timeout=self._xt,
                                        monitor=self._monitor)
        self.union_wire_bytes += sum(int(p.nbytes) for p in parts)
        union = (np.unique(np.concatenate(parts))
                 if any(p.size for p in parts) else mine)
        if union.size == 0:
            return  # nobody touched this table: replicas already agree
        C = sync_block_rows(union.size, self.plane.n_local)
        self.sync_rows_max = max(self.sync_rows_max, C)
        self.union_rows += int(union.size)
        idx = np.full(C, t.num_slots, np.int64)
        idx[: union.size] = union
        idxd = torch.as_tensor(idx, device=self.device)
        bases = self._sparse_base[name]
        for lname, leaf in self._leaves(t):
            delta = rows_delta(leaf, bases[lname], idxd)
            if lname == "emb":
                self._last_emb_len = int(delta.shape[0])
            self.row_merge_bytes += delta.numel() * delta.element_size()
            merged = self.plane.allreduce_sum(delta)
            rows_apply(leaf, bases[lname], idxd, merged)

    def finalize(self) -> None:
        """Merge any unsynced tail; afterwards every process holds
        identical tables. All processes call this together. Idempotent at
        the same clock."""
        if self.clock != self._synced_at:
            self._sync()

    def fingerprint(self) -> float:
        """One float over ALL synced state: dense params, sparse emb AND
        the sparse optimizer rows, plus dense opt state under
        opt_sync='avg'. Equal across processes after finalize."""
        total = 0.0
        for name in sorted(self.dense):
            t = self.dense[name]
            total += float(t.params.detach().double().sum())
            if self.opt_sync == "avg":
                for leaf in t.opt_state:
                    if is_avg_leaf(leaf, t.padded):
                        total += float(leaf.detach().double().sum())
        for name in sorted(self.sparse):
            for _, leaf in self._leaves(self.sparse[name]):
                total += float(leaf.detach().double().sum())
        return total


def kernel_launches() -> dict:
    """The hand-written kernels' launch counters (K1 and K2-K4), read
    into a done line: each counts the launches on CUDA tensors."""
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.ops.gather import gather_rows

    return {"gather_rows": gather_rows.launches,
            "flash_forward": tfa.flash_forward.launches,
            "flash_bwd_dq": tfa.flash_bwd_dq.launches,
            "flash_bwd_dkv": tfa.flash_bwd_dkv.launches}


# --------------------------------------------------------------- runners
def run_wd_cssp(args, rank: int, nprocs: int, multi: bool,
                watchdog) -> int:
    """multihost_example ``--model wd --mode bsp|ssp|asp``: the flagship
    DeepFM (hashed wide + field embeddings + deep tower) under the
    collective-gated consistency axis, one JSON line with the row-sparse
    traffic observables."""
    from minips_tpu_torch.apps.wide_deep_example import build
    from minips_tpu_torch.core.config import Config, TableConfig, \
        TrainConfig
    from minips_tpu_torch.data import synthetic

    staleness = staleness_for(args.mode, args.staleness)
    if getattr(args, "sync_comm", "float32") != "float32":
        raise SystemExit(
            "--sync-comm compression is not wired for the wd row-sparse "
            "merge (the error-feedback residual is defined over a "
            "per-round-changing row union — per-slot EF bookkeeping is "
            "future work); use --model lr or lm")
    if args.batch % nprocs:
        raise SystemExit(f"--batch {args.batch} must divide by {nprocs} "
                         "processes")
    per = args.batch // nprocs

    def build_fn(device):
        cfg = Config(
            table=TableConfig(name="ctr", kind="sparse",
                              updater=args.updater, lr=args.lr,
                              dim=args.dim, num_slots=args.num_slots),
            train=TrainConfig(batch_size=per, num_iters=args.iters),
        )
        ps, (wide_t, emb_t, deep_t) = build(cfg, use_fm=True,
                                            seed=args.seed, device=device)
        return ps, {"wide": wide_t, "emb": emb_t, "deep": deep_t}

    t0 = time.monotonic()
    trainer = CollectiveSSPPS(
        build_fn, staleness=staleness, sync_every=args.sync_every,
        bus=getattr(watchdog, "bus", None),
        monitor=getattr(watchdog, "monitor", None),
        opt_sync=getattr(args, "opt_sync", "local"), device=args.device)
    watchdog.ready()
    # ONE dataset (one ground truth) on every rank; batches sampled with a
    # shared stream, each rank training on its row slice
    data = synthetic.criteo_like(8192, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    jitter_rng = np.random.default_rng(1000 + rank)
    losses = []
    with watchdog.absorbing():  # dead peer => instant transport error
        for i in range(args.iters):
            sel = rng.integers(0, data["y"].shape[0], size=args.batch)
            if args.slow_ms and rank == args.slow_rank:
                time.sleep(args.slow_ms / 1000.0)
            if args.jitter_ms and jitter_rng.random() < args.jitter_prob:
                time.sleep(args.jitter_ms / 1000.0)
            lo, hi = rank * per, (rank + 1) * per
            losses.append(trainer.step(
                {k: v[sel][lo:hi] for k, v in data.items()}))
        # finalize + fingerprint are collectives too
        trainer.finalize()
        fp = trainer.fingerprint()
    record = trainer.sync_record() if trainer._last_emb_len else []
    watchdog.disarm()
    cluster.barrier("cssp_wd_done")
    print(json.dumps({
        **done_common(trainer, args, staleness, rank, nprocs, multi, t0,
                      losses),
        "model": "wd",
        "param_fingerprint": fp,
        "sync_rows_max": trainer.sync_rows_max,
        "union_rows": trainer.union_rows,
        "num_slots": int(args.num_slots),
        "union_wire_bytes": trainer.union_wire_bytes,
        "row_merge_bytes": trainer.row_merge_bytes,
        "sync_record": record,
        "sync_hlo_has_all_reduce": any(r["op"] == "all_reduce"
                                       for r in record),
        "kernel_launches": kernel_launches(),
    }), flush=True)
    watchdog.close()
    return 0


def run_lm_cssp(args, rank: int, nprocs: int, multi: bool,
                watchdog) -> int:
    """multihost_example ``--model lm --mode bsp|ssp|asp``: the LM family
    on the collective consistency axis. Each process is a data-parallel
    island; the cross-process sync is CollectiveSSP's dense delta merge
    over the transformer's raveled parameters. The model is the
    reference's fixed small one, its attention the plain one of the JAX
    ``tfm.grad_fn`` (``attn_impl="reference"``)."""
    from minips_tpu_torch.models import transformer as tfm
    from minips_tpu_torch.train.ssp_spmd import CollectiveSSP

    staleness = staleness_for(args.mode, args.staleness)
    if args.batch % nprocs:
        raise SystemExit(f"--batch {args.batch} must divide by {nprocs} "
                         "processes")
    per = args.batch // nprocs
    T = args.seq_len
    model = dict(vocab=64, dim=32, heads=2, depth=2, max_len=T)
    dev = resolve_device(args.device)
    template = tfm.init(torch.Generator(device=dev).manual_seed(args.seed),
                        **model, device=dev)

    def grad(p, b):
        return tfm.grad_fn(p, b, heads=model["heads"])

    t0 = time.monotonic()
    trainer = CollectiveSSP(
        template, grad, updater=args.updater, lr=args.lr,
        staleness=staleness, sync_every=args.sync_every,
        bus=getattr(watchdog, "bus", None),
        monitor=getattr(watchdog, "monitor", None), name="lm_cssp",
        opt_sync=getattr(args, "opt_sync", "local"),
        sync_comm=getattr(args, "sync_comm", "float32"), device=dev)
    watchdog.ready()
    rng = np.random.default_rng(args.seed)
    jitter_rng = np.random.default_rng(1000 + rank)
    losses = []
    with watchdog.absorbing():  # dead peer => instant transport error
        for i in range(args.iters):
            toks = rng.integers(0, model["vocab"],
                                size=(args.batch, T + 1)).astype(np.int32)
            if args.slow_ms and rank == args.slow_rank:
                time.sleep(args.slow_ms / 1000.0)
            if args.jitter_ms and jitter_rng.random() < args.jitter_prob:
                time.sleep(args.jitter_ms / 1000.0)
            losses.append(trainer.step(
                {"tokens": toks[rank * per:(rank + 1) * per]}))
        trainer.finalize()
        fp = float(cluster.host_copy(trainer.table.params).sum())
    record = trainer.sync_record()
    watchdog.disarm()
    cluster.barrier("cssp_lm_done")
    print(json.dumps({
        **done_common(trainer, args, staleness, rank, nprocs, multi, t0,
                      losses),
        "model": "lm",
        "sync_comm": getattr(args, "sync_comm", "float32"),
        "param_fingerprint": fp,
        "sync_record": record,
        "sync_hlo_has_all_reduce": any(r["op"] == "all_reduce"
                                       for r in record),
    }), flush=True)
    watchdog.close()
    return 0
