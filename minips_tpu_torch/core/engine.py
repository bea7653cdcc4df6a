"""Engine — the port of ``minips_tpu/core/engine.py``: the threaded
parameter-server path with the reference programming model.

- ``start_everything`` resolves the device every table lives on
  (``parallel/mesh.py``; the JAX package builds its mesh here). Logical
  workers default to the number of devices, 1, and may exceed it; they
  then timeshare the card, as in the JAX package.
- ``create_table`` allocates a dense or sparse table on that device plus
  its BSP/SSP/ASP consistency controller.
- ``run(MLTask)`` starts one host thread per logical worker, running the
  UDF against an ``Info`` handle whose ``KVClientTable``s pull (gated by
  the controller), push and clock.

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
from minips_tpu_torch.parallel.mesh import (WORLD_SIZE, DeviceLike,
                                            resolve_device)
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable


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
    after a pull runs after it on the card."""

    def __init__(self, table, controller: ConsistencyController,
                 worker_id: int, lock: threading.Lock):
        self._table = table
        self._controller = controller
        self._worker_id = worker_id
        self._lock = lock

    def pull(self, keys=None, timeout: float = 60.0):
        """Blocks until the consistency model admits this worker."""
        if not self._controller.wait_until_admitted(self._worker_id, timeout):
            raise TimeoutError(
                f"worker {self._worker_id} pull not admitted within "
                f"{timeout}s (min_clock={self._controller.min_clock}, "
                f"my_clock={self._controller.tracker.clock_of(self._worker_id)})")
        with self._lock:
            if keys is None:
                return self._table.pull()
            if isinstance(self._table, SparseTable):
                return self._table.pull(keys)
            return self._table.pull_keys(keys)

    def push(self, grads, keys=None) -> None:
        """The server-side updater applies at push."""
        with self._lock:
            if keys is None:
                self._table.push(grads)
            elif isinstance(self._table, SparseTable):
                self._table.push(keys, grads)
            else:
                self._table.push_keys(keys, grads)

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
    """Device bootstrap + tables + threaded task runner. ``device``
    is where every table lives, the card unless the caller says
    otherwise."""

    def __init__(self, num_workers: Optional[int] = None,
                 device: DeviceLike = None):
        self._requested_workers = num_workers
        self._requested_device = device
        self.device: Optional[torch.device] = None
        self.tables: dict[str, Any] = {}
        self.controllers: dict[str, ConsistencyController] = {}
        # ONE dispatch lock shared by every table: per-table locks would
        # let a pull on table A interleave with a push on table B, and
        # the lock is what orders the workers' launches on the one stream
        self._dispatch_lock = threading.Lock()
        self.num_workers = 0
        self._started = False

    # -------------------------------------------------------------- lifecycle
    def start_everything(self) -> "Engine":
        """Device bootstrap (the JAX package builds its mesh here). Logical
        workers default to the number of devices, ``WORLD_SIZE``; more
        logical workers than devices is allowed (they timeshare the
        card)."""
        self.device = resolve_device(self._requested_device)
        self.num_workers = self._requested_workers or WORLD_SIZE
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
        cfg.updater."""
        if not self._started:
            raise RuntimeError("call start_everything() first")
        if cfg.kind == "dense":
            if template is None:
                raise ValueError("dense table needs a parameter template")
            table = DenseTable(template, name=cfg.name, updater=cfg.updater,
                               lr=cfg.lr, tx=tx, device=self.device)
        elif cfg.kind == "sparse":
            table = SparseTable(cfg.num_slots, cfg.dim, name=cfg.name,
                                updater=cfg.updater, lr=cfg.lr,
                                init_scale=cfg.init_scale, device=self.device)
        else:
            raise ValueError(f"unknown table kind {cfg.kind!r}")
        controller = make_controller(
            cfg.consistency, self.num_workers,
            staleness=cfg.staleness, sync_every=cfg.sync_every)
        return self.register_table(cfg.name, table, controller)

    def register_table(self, name: str, table,
                       controller: ConsistencyController) -> str:
        """Register an externally-built table with its controller."""
        if not self._started:
            raise RuntimeError("call start_everything() first")
        self.tables[name] = table
        self.controllers[name] = controller
        return name

    # ------------------------------------------------------------------- run
    def run(self, task: MLTask) -> list[Any]:
        """Spawn one host thread per logical worker running the UDF.
        Returns per-worker UDF results in worker order."""
        if not self._started or task.fn is None:
            raise RuntimeError("run() needs a started engine and a task fn")
        n = task.num_workers or self.num_workers
        if n != self.num_workers:
            raise ValueError(
                f"task wants {n} workers but engine tables/controllers were "
                f"sized for {self.num_workers}")
        for c in self.controllers.values():
            c.reset_stop()  # a previous failed run() must not poison this one
        results: list[Any] = [None] * n
        errors: list[BaseException | None] = [None] * n

        def runner(wid: int) -> None:
            info = Info(
                worker_id=wid,
                num_workers=n,
                tables={
                    name: KVClientTable(tbl, self.controllers[name], wid,
                                        self._dispatch_lock)
                    for name, tbl in self.tables.items()
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
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        real = [e for e in errors if e is not None]
        if real:
            # Prefer the root cause: victim TimeoutErrors from the stop()
            # cascade must not mask the worker error that triggered it.
            root = next((e for e in real if not isinstance(e, TimeoutError)),
                        real[0])
            raise root
        return results

    def make_checkpointer(self, directory: str, **kwargs):
        """Checkpointer over every table and controller this engine owns
        (the reference's Dump/Load)."""
        from minips_tpu_torch.ckpt import make_checkpointer

        return make_checkpointer(directory, self.tables, self.controllers,
                                 **kwargs)

    def barrier(self) -> None:
        raise NotImplementedError(
            "Engine.barrier is multi-host and not ported yet (ROADMAP.md "
            "queue 1 item 16: comm/cluster.py becomes a torch.distributed "
            "bootstrap)")
