"""Engine — the port of ``minips_tpu/core/engine.py``: the threaded
parameter-server path with the reference programming model.

- ``start_everything`` resolves the device every table lives on
  (``parallel/mesh.py``; the JAX package builds its mesh here). Logical
  workers default to the number of devices: 1, or the size of the process
  group (``group=``), as the JAX package's default is its mesh's data
  size. They may exceed it; they then timeshare the card.
- ``create_table`` allocates a dense or sparse table on that device,
  range-sharded over the group, plus its BSP/SSP/ASP consistency
  controller.
- ``run(MLTask)`` starts one host thread per logical worker, running the
  UDF against an ``Info`` handle whose ``KVClientTable``s pull (gated by
  the controller), push and clock.

**Over a process group of n > 1 ranks, one rank drives and the others
serve.** In the JAX package one process runs every worker thread, and
only the tables span the mesh. Here rank 0 runs all the worker threads
against its card, and ranks 1..n-1 enter a serve loop in ``run()``. A
table op is a collective (``SparseTable.route``, the dense all-gather),
so every rank must issue the same ops in the same order: under rank 0's
one dispatch lock, each op first broadcasts a header (the op, the
table's index, a key count), then every rank calls the same table
method. A serving rank joins a sparse pull or push with no keys of its
own; for a dense push, which applies the same gradient on every rank,
rank 0 also broadcasts the gradient (and for ``push_keys`` the keys). The
order of the collectives is thus rank 0's lock order on every rank. The
consistency controllers and their gate stay on rank 0, as in the JAX
package; a worker waiting at the gate holds no lock and sends nothing.
When the threads have joined, rank 0 sends a STOP header and then hands
its results (or its first error) to every rank, so that what an app does
after ``run()`` (collective pulls for a holdout or a checkpoint) runs
the same on every rank. Under a group of one no header is sent.

The fused path (``DenseTable.make_step``, ``PSTrainStep``) needs none of
this; the Engine exists for the reference's per-worker clocks and bounded
staleness.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from minips_tpu_torch.consistency import ConsistencyController, make_controller
from minips_tpu_torch.core.config import TableConfig
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group, barrier,
                                            broadcast, broadcast_object,
                                            group_device, resolve_device,
                                            world)
from minips_tpu_torch.tables.dense import DenseTable, ravel
from minips_tpu_torch.tables.sparse import SparseTable

# the table ops a header announces to the serving ranks
_STOP, _PULL, _PULL_KEYS, _PUSH, _PUSH_KEYS = range(5)


@dataclass
class MLTask:
    """UDF + worker allocation — reference ``MLTask``."""

    fn: Optional[Callable[["Info"], Any]] = None
    num_workers: int = 0  # 0 = use the engine's worker count

    def set_lambda(self, fn: Callable[["Info"], Any]) -> "MLTask":
        self.fn = fn
        return self

    def set_worker_alloc(self, num_workers: int) -> "MLTask":
        self.num_workers = num_workers
        return self


class KVClientTable:
    """Worker-facing table handle: ``pull``/``push``/``clock``, with the
    consistency gate applied on pull.

    A pull returns device tensors, not host copies, and they are a
    snapshot: a later push from another worker never changes them. A
    sparse pull is a row gather into fresh storage (the sparse push
    updates the table's rows in place, never the gathered copy); a dense
    pull returns views of the table's flat vector, and a dense push
    replaces that vector with a new tensor instead of writing into it.
    Every pull and push runs under the one dispatch lock the Engine shares
    across all tables. All threads launch on the device's current stream,
    so the lock also fixes the order of their launches: a push queued
    after a pull runs after it on the card (and, over a group, the order
    of the collectives on every rank)."""

    def __init__(self, engine: "Engine", index: int,
                 controller: ConsistencyController, worker_id: int):
        self._engine = engine
        self._index = index
        self._controller = controller
        self._worker_id = worker_id

    def pull(self, keys=None, timeout: float = 60.0):
        """Blocks until the consistency model admits this worker."""
        if not self._controller.wait_until_admitted(self._worker_id, timeout):
            raise TimeoutError(
                f"worker {self._worker_id} pull not admitted within "
                f"{timeout}s (min_clock={self._controller.min_clock}, "
                f"my_clock={self._controller.tracker.clock_of(self._worker_id)})")
        with self._engine._dispatch_lock:
            if keys is None:
                return self._engine._dispatch(self._index, _PULL)
            return self._engine._dispatch(self._index, _PULL_KEYS, keys)

    def push(self, grads, keys=None) -> None:
        """The server-side updater applies at push."""
        with self._engine._dispatch_lock:
            if keys is None:
                self._engine._dispatch(self._index, _PUSH, vals=grads)
            else:
                self._engine._dispatch(self._index, _PUSH_KEYS, keys, grads)

    def clock(self) -> None:
        self._controller.clock(self._worker_id)

    @property
    def worker_id(self) -> int:
        return self._worker_id


@dataclass
class Info:
    """Handle passed into the UDF — reference ``Info``."""

    worker_id: int
    num_workers: int
    tables: dict = field(default_factory=dict)

    def table(self, name: str) -> KVClientTable:
        return self.tables[name]


class Engine:
    """Device bootstrap + tables + threaded task runner. ``device`` is
    where every table lives: the card unless the caller says otherwise,
    and under ``group`` this rank's device (its card under NCCL, the CPU
    under gloo). ``group``: the process group every table is
    range-sharded over, one rank per device (see the module docstring);
    ``None`` is one device."""

    def __init__(self, num_workers: Optional[int] = None,
                 device: DeviceLike = None, group: Group = None):
        self._requested_workers = num_workers
        self._requested_device = device
        self.group = group
        self.rank, self.num_ranks = world(group)
        self.device: Optional[torch.device] = None
        self.tables: dict[str, Any] = {}
        self.controllers: dict[str, ConsistencyController] = {}
        # ONE dispatch lock shared by every table: per-table locks would
        # let a pull on table A interleave with a push on table B, and
        # the lock is what orders the workers' launches on the one stream
        # (and their collectives on every rank of a group)
        self._dispatch_lock = threading.Lock()
        self.num_workers = 0
        self._started = False

    # -------------------------------------------------------------- lifecycle
    def start_everything(self) -> "Engine":
        """Device bootstrap (the JAX package builds its mesh here). Logical
        workers default to the number of devices: 1, or the group's size;
        more logical workers than devices is allowed (they timeshare the
        card, on rank 0 under a group)."""
        if self._requested_device is None and self.group is not None:
            self.device = group_device(self.group)
        else:
            self.device = resolve_device(self._requested_device)
        self.num_workers = self._requested_workers or self.num_ranks
        self._started = True
        return self

    def stop_everything(self) -> None:
        for c in self.controllers.values():
            c.stop()
        self._started = False

    # ----------------------------------------------------------------- tables
    def create_table(self, cfg: TableConfig, template=None,
                     tx=None) -> str:
        """Reference ``CreateTable(ModelType, StorageType)``: storage kind
        from cfg.kind, consistency model from cfg.consistency, updater from
        cfg.updater. The table is range-sharded over the engine's group."""
        if not self._started:
            raise RuntimeError("call start_everything() first")
        if cfg.kind == "dense":
            if template is None:
                raise ValueError("dense table needs a parameter template")
            table = DenseTable(template, name=cfg.name, updater=cfg.updater,
                               lr=cfg.lr, tx=tx, device=self.device,
                               group=self.group)
        elif cfg.kind == "sparse":
            table = SparseTable(cfg.num_slots, cfg.dim, name=cfg.name,
                                updater=cfg.updater, lr=cfg.lr,
                                init_scale=cfg.init_scale, device=self.device,
                                group=self.group)
        else:
            raise ValueError(f"unknown table kind {cfg.kind!r}")
        controller = make_controller(
            cfg.consistency, self.num_workers,
            staleness=cfg.staleness, sync_every=cfg.sync_every)
        return self.register_table(cfg.name, table, controller)

    def register_table(self, name: str, table,
                       controller: ConsistencyController) -> str:
        """Register an externally-built table with its controller. Every
        rank of a group registers the same tables in the same order."""
        if not self._started:
            raise RuntimeError("call start_everything() first")
        if getattr(table, "group", None) is not self.group:
            raise ValueError(f"table {name!r} is sharded over another "
                             "process group than the engine's")
        self.tables[name] = table
        self.controllers[name] = controller
        return name

    # ------------------------------------------------------------ table ops
    def _dispatch(self, index: int, op: int, keys=None, vals=None,
                  n: int = 0):
        """One table op on this rank, under the dispatch lock. Over a
        group of more than one rank, rank 0 first broadcasts the header,
        then every rank runs the same table method; a serving rank passes
        no ``keys``/``vals`` and joins with none of its own, or receives
        what the method needs the same on every rank (a dense push's
        gradient, ``push_keys``' keys and values; ``n``: their count, from
        the header)."""
        table = self._order[index]
        grouped = self.num_ranks > 1
        serving = self.rank != 0
        sparse = isinstance(table, SparseTable)
        dev = self.device
        if op == _PUSH_KEYS and not sparse and grouped and not serving:
            keys = torch.as_tensor(keys, device=dev).reshape(-1).long()
            vals = torch.as_tensor(vals, device=dev,
                                   dtype=table.params.dtype).reshape(-1)
            n = keys.numel()
        if grouped and not serving:
            broadcast(torch.tensor([op, index, n], dtype=torch.int64,
                                   device=dev), 0, self.group)
        if op == _PULL:
            return table.pull()
        if op == _PULL_KEYS:
            if serving:
                keys = torch.empty(0, dtype=torch.int64, device=dev)
            return table.pull(keys) if sparse else table.pull_keys(keys)
        if op == _PUSH:
            if grouped:  # every rank applies its range of one gradient
                flat = (torch.empty(table.num_keys, dtype=table.params.dtype,
                                    device=dev) if serving else
                        ravel(vals, dev)[0].to(table.params.dtype))
                vals = table.unravel(broadcast(flat, 0, self.group))
            table.push(vals)
        elif sparse:  # _PUSH_KEYS
            if serving:
                keys = torch.empty(0, dtype=torch.int64, device=dev)
                vals = torch.empty((0, table.dim), dtype=table.emb.dtype,
                                   device=dev)
            table.push(keys, vals)
        else:
            if grouped:
                if serving:
                    keys = torch.empty(n, dtype=torch.int64, device=dev)
                    vals = torch.empty(n, dtype=table.params.dtype,
                                       device=dev)
                broadcast(keys, 0, self.group)
                broadcast(vals, 0, self.group)
            table.push_keys(keys, vals)
        return None

    def _serve(self) -> list[Any]:
        """A serving rank's ``run()``: every table op rank 0 announces,
        until its STOP; then rank 0's results, or its workers' error."""
        header = torch.empty(3, dtype=torch.int64, device=self.device)
        while True:
            op, index, n = broadcast(header, 0, self.group).tolist()
            if op == _STOP:
                break
            self._dispatch(index, op, n=n)
        ok, value = broadcast_object(None, 0, self.group)
        if not ok:
            raise RuntimeError(f"rank 0's workers failed: {value}")
        return value

    # ------------------------------------------------------------------- run
    def run(self, task: MLTask) -> list[Any]:
        """Spawn one host thread per logical worker running the UDF.
        Returns per-worker UDF results in worker order. Over a group of
        more than one rank, rank 0 runs the threads and every other rank
        serves its table ops; every rank returns rank 0's results (keep
        them host values: they are pickled to the other ranks)."""
        if not self._started or task.fn is None:
            raise RuntimeError("run() needs a started engine and a task fn")
        n = task.num_workers or self.num_workers
        if n != self.num_workers:
            raise ValueError(
                f"task wants {n} workers but engine tables/controllers were "
                f"sized for {self.num_workers}")
        for c in self.controllers.values():
            c.reset_stop()  # a previous failed run() must not poison this one
        self._order = list(self.tables.values())  # the headers' indices
        if self.rank != 0:
            return self._serve()
        results: list[Any] = [None] * n
        errors: list[BaseException | None] = [None] * n
        names = list(self.tables)

        def runner(wid: int) -> None:
            if self.device.type == "cuda":  # the current device is per thread
                torch.cuda.set_device(self.device)
            info = Info(
                worker_id=wid,
                num_workers=n,
                tables={
                    name: KVClientTable(self, i, self.controllers[name], wid)
                    for i, name in enumerate(names)
                },
            )
            try:
                results[wid] = task.fn(info)
            except BaseException as e:  # surfaced after join
                errors[wid] = e
                # unblock peers parked on this worker's clock
                for c in self.controllers.values():
                    c.stop()

        threads = [threading.Thread(target=runner, args=(w,), daemon=True)
                   for w in range(n)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            if self.num_ranks > 1:  # a failed run ends the serving ranks too
                broadcast(torch.tensor([_STOP, 0, 0], dtype=torch.int64,
                                       device=self.device), 0, self.group)
        real = [e for e in errors if e is not None]
        # Prefer the root cause: victim TimeoutErrors from the stop()
        # cascade must not mask the worker error that triggered it.
        root = next((e for e in real if not isinstance(e, TimeoutError)),
                    real[0]) if real else None
        if self.num_ranks > 1:
            broadcast_object((root is None, results if root is None else
                              f"{type(root).__name__}: {root}"), 0,
                             self.group)
        if root is not None:
            raise root
        return results

    def make_checkpointer(self, directory: str, **kwargs):
        """Checkpointer over every table and controller this engine owns
        (the reference's Dump/Load); under a group, rank 0 writes."""
        from minips_tpu_torch.ckpt import make_checkpointer

        return make_checkpointer(directory, self.tables, self.controllers,
                                 group=self.group, **kwargs)

    def barrier(self) -> None:
        """The group's barrier; without a group, the multi-host
        cluster's (``comm/cluster.py``, a no-op on one process), as in
        the JAX package (SURVEY.md §3.4)."""
        if self.group is None:
            from minips_tpu_torch.comm.cluster import barrier as cluster_barrier

            cluster_barrier()
            return
        barrier(self.group)
