"""CollectiveSSP — the port of ``minips_tpu/train/ssp_spmd.py``:
BSP/SSP/ASP whose SYNC is a collective of the process group.

SURVEY.md §7.4.1 as written, the north star's clause "the consistency
controller gates XLA collective barriers" (BASELINE.json:5), on
``torch.distributed``:

- each process drives its OWN fused step (``DenseTable.make_step``) on
  its one device: the local data plane enlists no other process;
- the cross-process sync is an explicit collective the host chooses to
  launch: one ``all_reduce`` of the parameter delta over the world group
  (``comm/cluster.py``), on the device under NCCL, through a pinned host
  buffer under gloo (processes that share a card, or the CPU). No
  parameter bytes ride the control bus;
- the SSP gate is host-side: the clock vector gossips over the control
  bus (``ClockGossip``) and the shared ``StalenessGate`` blocks a fast
  process after local step ``c`` until ``global_min >= c - s`` (s=0 BSP
  lockstep, s>0 SSP, inf ASP never waits).

Sync semantics are the relay path's additive replicated-PS rule
(``train/ssp_trainer.py``): every process applies the SUM of all
processes' deltas since the last sync, so after a sync every replica
holds ``base + Σ_p delta_p``, the same on every process (the all-reduce
hands every participant the same sum). Between syncs replicas drift by
their own updates; the gate bounds that drift in clock distance.

Collective rendezvous constraint (inherent): sync rounds launch at fixed
clocks (every ``sync_every`` local steps), so every process takes the
same number of steps; uneven step counts stay on the host-relay path
(``SSPTrainer``). ASP here is bounded-rendezvous local SGD: the gate
never blocks, the periodic merge still does.

The JAX package returns each sync's compiled HLO (``sync_hlo``) so that a
test can see that the sync IS a collective. PyTorch compiles nothing
here; the port keeps a record of the collectives a sync launches instead
(``SyncPlane.plan``, ``CollectiveSSP.sync_record``): op, group backend,
dtype and bytes of each, and the plane counts what it launched.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from minips_tpu_torch.comm import cluster
from minips_tpu_torch.comm.bus import ClockGossip
from minips_tpu_torch.consistency.gate import StalenessGate, publish_clock
from minips_tpu_torch.ops.quantized_comm import (BLOCK, _check,
                                                 a2a_reduce,
                                                 gather_broadcast)
from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.tables.dense import DenseTable, _host, _tensor_like

__all__ = ["CollectiveSSP", "SyncPlane", "make_control"]

PyTree = Any

_WIRE = {"float32": 4, "bfloat16": 2, "int8": 1}


class SyncPlane:
    """The cross-process sync of every CollectiveSSP-family trainer: the
    world group of ``comm/cluster.py`` (``None`` on one process, where a
    sum over one process is the identity and nothing is launched) and the
    collectives on it: :meth:`allreduce_sum` (dense vector deltas, and the
    row-sparse blocks of ``train/cssp_ps.py``), :meth:`allreduce_sum_ef`
    (the compressed wire with its error-feedback hook) and
    :meth:`allreduce_mean` (``opt_sync='avg'``).

    Each process holds one device, so ``n_local`` is 1: the JAX plane's
    ``(proc, local)`` mesh is ``(nprocs, 1)`` here. Every call blocks
    until its collective is done, one in flight at a time, as the JAX
    plane serializes its merges. ``launches`` and ``bytes`` count what
    went on the wire (nothing on one process)."""

    def __init__(self, device: DeviceLike = None):
        self.nprocs = cluster.process_count()
        self.rank = cluster.process_index()
        self.group = dist.group.WORLD if self.nprocs > 1 else None
        self.backend = cluster.backend()
        self.device = resolve_device(device)
        self.n_local = 1
        self.launches = 0
        self.bytes = 0

    def _count(self, record: list) -> None:
        if self.group is not None:
            self.launches += len(record)
            self.bytes += sum(r["bytes"] for r in record)

    def plan(self, length: int, dtype: torch.dtype = torch.float32,
             comm: str = "float32") -> list[dict]:
        """The collectives one sync of a ``length``-element vector
        launches, each as ``{"op", "backend", "dtype", "bytes"}`` (the
        port's counterpart of the JAX plane's ``sync_hlo``): one
        ``all_reduce`` on the float32 wire; on a compressed wire the
        reduce leg's ``all_to_all`` and the replicate leg's
        ``all_gather`` of the compressed codes (int8 adds each leg's
        float32 block scales)."""
        be = self.backend
        if comm == "float32":
            return [{"op": "all_reduce", "backend": be,
                     "dtype": str(dtype).replace("torch.", ""),
                     "bytes": int(length) * torch.empty(
                         (), dtype=dtype).element_size()}]
        n = self.nprocs
        padded = -(-int(length) // n) * n
        c = padded // n
        out = [{"op": "all_to_all", "backend": be, "dtype": comm,
                "bytes": padded * _WIRE[comm]}]
        if comm == "int8":
            out.append({"op": "all_to_all", "backend": be,
                        "dtype": "float32",
                        "bytes": n * -(-c // BLOCK) * 4})
        out.append({"op": "all_gather", "backend": be, "dtype": comm,
                    "bytes": c * _WIRE[comm]})
        if comm == "int8":
            out.append({"op": "all_gather", "backend": be,
                        "dtype": "float32", "bytes": -(-c // BLOCK) * 4})
        return out

    def allreduce_sum(self, vec: torch.Tensor) -> torch.Tensor:
        """The sum of every process's ``vec`` (a new tensor on ``vec``'s
        device; ``vec`` itself on one process)."""
        self._count(self.plan(vec.numel(), vec.dtype))
        if self.group is None:
            return vec
        w = cluster.to_wire(vec.contiguous())
        if w is vec or w.data_ptr() == vec.data_ptr():
            w = w.clone()  # the all-reduce is in place
        dist.all_reduce(w, group=self.group)
        return cluster.from_wire(w, vec.device)

    def allreduce_sum_ef(self, vec: torch.Tensor, comm: str):
        """Quantized-wire all-reduce with the error-feedback hook: returns
        ``(merged, sent, gap)`` on ``vec``'s device. ``sent`` is this
        process's contribution after the reduce leg's compression,
        ``gap`` the replicate leg's compression error of the chunk this
        process reduced, at its place in the vector: callers keep
        ``residual = send - sent + gap``, so neither leg's bias
        accumulates. Every process dequantizes the same gathered bytes,
        so the merge is the same everywhere. The vector is zero-padded to
        split evenly into per-process chunks (``ops/quantized_comm.py``'s
        ``a2a_reduce`` and ``gather_broadcast``, the pull/push plane's own
        wire)."""
        if comm == "float32":
            raise ValueError("allreduce_sum_ef is for compressed wires; "
                             "use allreduce_sum for float32")
        _check(comm)
        L = int(vec.shape[0])
        n = self.nprocs
        padded = -(-L // n) * n
        c = padded // n
        self._count(self.plan(L, vec.dtype, comm))
        x = cluster.to_wire(vec.contiguous()) if self.group is not None \
            else vec
        if padded != L:
            x = torch.nn.functional.pad(x, (0, padded - L))
        mine, sent = a2a_reduce(x.reshape(n, c), self.group, comm)
        full, gap_c = gather_broadcast(mine, self.group, comm)
        gap = torch.zeros(padded, dtype=torch.float32, device=x.device)
        gap[self.rank * c:(self.rank + 1) * c] = gap_c
        return tuple(cluster.from_wire(o.reshape(-1)[:L].contiguous(),
                                       vec.device)
                     for o in (full, sent, gap))

    def allreduce_mean(self, vec: torch.Tensor) -> torch.Tensor:
        """The mean of a float leaf over processes (``opt_sync='avg'``):
        summed in float32 (bf16 moments lose no mantissa to the
        reduction), divided by the process count, cast back."""
        dt = vec.dtype
        v = vec if dt == torch.float32 else vec.to(torch.float32)
        return (self.allreduce_sum(v) / self.nprocs).to(dt)


def staleness_for(mode: str, ssp_staleness: int) -> float:
    """The one mode->staleness encoding (bsp pins 0, asp pins inf) shared
    by every CollectiveSSP-family runner."""
    return {"bsp": 0, "ssp": ssp_staleness, "asp": float("inf")}[mode]


def make_control(bus, nprocs: int, staleness: float, *,
                 monitor=None, timeout: float = 60.0):
    """(gossip, gate) for the host-side consistency control plane, or
    (None, None) when single-process or bus-less."""
    if bus is None or nprocs <= 1:
        return None, None
    gossip = ClockGossip(bus, nprocs, workers_per_process=1)
    return gossip, StalenessGate(gossip, staleness, timeout=timeout,
                                 monitor=monitor)


def check_avg_opt_sync_supported(table: DenseTable) -> None:
    """opt_sync='avg' refusal for quantized moments: adam8's uint8 codes
    and blockwise scales have no meaningful elementwise mean."""
    if any(x.dtype == torch.uint8 for x in table.opt_state):
        raise ValueError(
            "opt_sync='avg' cannot average adam8's quantized moments; "
            "use opt_sync='local' (drift documented in "
            "docs/consistency.md) or adam/adam_bf16")


def is_avg_leaf(leaf: torch.Tensor, padded: int) -> bool:
    """THE predicate for which opt-state leaves opt_sync='avg' touches:
    float params-length vectors (adam/adam_bf16 moments, adagrad
    accumulators, momentum traces)."""
    return (leaf.dim() == 1 and leaf.shape[0] == padded
            and leaf.is_floating_point())


def avg_table_opt_state(table: DenseTable, plane: SyncPlane) -> None:
    """The ``opt_sync='avg'`` reconciliation for one dense table: every
    ``is_avg_leaf`` opt leaf is averaged across processes; scalar counts
    stay local (sync rounds happen at fixed clocks, so they agree)."""
    table.opt_state = [plane.allreduce_mean(leaf)
                       if is_avg_leaf(leaf, table.padded) else leaf
                       for leaf in table.opt_state]


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


class CollectiveSSP:
    """Local fused steps per process; staleness-gated collective syncs.

    Parameters
    ----------
    template: parameter tree (identical on every process).
    grad_fn: ``(params, batch) -> (loss, grads)`` for the local fused
        step (``DenseTable.make_step`` semantics, on this process's
        device).
    staleness: 0 = BSP lockstep, s = SSP bounded staleness,
        ``float('inf')`` = ASP (gate never blocks; syncs still rendezvous).
    sync_every: launch the collective merge every k local steps.
    bus: the launcher's ControlBus for clock gossip (None single-process).
    monitor: optional HeartbeatMonitor; a gate timeout consults it.
    opt_sync: ``"local"`` keeps each process's optimizer state (exact
        for sgd, a local-SGD heuristic for stateful updaters);
        ``"avg"`` averages every float params-length opt leaf alongside
        the deltas (adam8 refuses).
    sync_comm: the merge's wire, ``"float32"``, ``"bfloat16"`` or
        ``"int8"`` (the latter two with an error-feedback residual).
    device: this process's device (the card by default).
    """

    def __init__(
        self,
        template: PyTree,
        grad_fn: Callable,
        *,
        updater: str = "sgd",
        lr=0.1,
        staleness: float = 0,
        sync_every: int = 1,
        bus=None,
        monitor=None,
        gate_timeout: float = 60.0,
        name: str = "cssp",
        opt_sync: str = "local",
        sync_comm: str = "float32",
        device: DeviceLike = None,
    ):
        if opt_sync not in ("local", "avg"):
            raise ValueError(f"opt_sync must be 'local' or 'avg', got "
                             f"{opt_sync!r}")
        self.opt_sync = opt_sync
        _check(sync_comm)
        self.sync_comm = sync_comm
        if sync_comm != "float32" and opt_sync == "avg":
            raise ValueError(
                "sync_comm compression + opt_sync='avg' is not wired: "
                "the moment average would ride the full-precision plane "
                "while the deltas ride the compressed one — a misleading "
                "half-measure; pick one lever per run")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self.staleness = staleness
        self.sync_every = int(sync_every)
        self.nprocs = cluster.process_count()
        if bus is None and self.nprocs > 1 and staleness < sync_every:
            # without the bus there is NO clock gossip: skew would grow to
            # sync_every while gate_waits/max_skew_seen report zeros
            raise ValueError(
                f"staleness {staleness} < sync_every {sync_every} needs "
                "the control bus for clock gossip in a multi-process "
                "run; pass bus= (launch.init_from_env) or raise "
                "staleness/sync alignment")

        # ---- local data plane: the fused step on MY device only --------
        self.device = resolve_device(device)
        self.plane = SyncPlane(self.device)
        self.table = DenseTable(template, name=name, updater=updater, lr=lr,
                                device=self.device)
        if opt_sync == "avg":
            check_avg_opt_sync_supported(self.table)
        self._step = self.table.make_step(grad_fn)
        # params = base + sum of deltas; base is a separate buffer
        self._base = self.table.params.clone()
        self._residual = None
        if sync_comm != "float32":
            # error-feedback state: what compression dropped last round
            # rides into this round's delta
            self._residual = torch.zeros_like(self.table.params)

        # ---- host-side control plane: clock gossip + staleness gate ----
        self.clock = 0
        self.sync_rounds = 0
        self._synced_at = 0  # clock of the last merge (finalize idempotence)
        self.gossip, self._gate = make_control(
            bus, self.nprocs, staleness, monitor=monitor,
            timeout=gate_timeout)

    # ------------------------------------------------------------ metrics
    @property
    def gate_waits(self) -> int:
        return self._gate.gate_waits if self._gate else 0

    @property
    def max_skew_seen(self) -> int:
        return self._gate.max_skew_seen if self._gate else 0

    @property
    def params(self) -> PyTree:
        return self.table.pull()

    def sync_record(self) -> list[dict]:
        """The collectives one sync launches (``SyncPlane.plan``): the
        port's counterpart of the JAX trainer's ``sync_hlo``."""
        return self.plane.plan(self.table.padded, self.table.params.dtype,
                               self.sync_comm)

    # ------------------------------------------------------------------ api
    def step(self, batch) -> float:
        """One LOCAL step, clock tick, SSP gate, then (at sync-every
        boundaries) the collective merge. ``batch`` is this process's
        rows (numpy or tensors), moved to its device."""
        loss = self.table.step_inplace(self._step, _on(batch, self.device))
        self.clock += 1
        if self._gate is not None:
            publish_clock(self.gossip, self.clock, False)
            self._gate.wait(self.clock)
        if self.clock % self.sync_every == 0:
            self._sync()
        return float(loss)

    def _sync(self) -> None:
        """base + sum_over_processes(delta) -> every replica identical.
        The all-reduce is the rendezvous: a fast process blocks in it
        until every process launches the round."""
        delta = self.table.params - self._base
        if self.sync_comm == "float32":
            merged = self.plane.allreduce_sum(delta)
        else:
            send = delta + self._residual
            merged, sent, gap = self.plane.allreduce_sum_ef(
                send, self.sync_comm)
            self._residual = send - sent + gap
        new_params = self._base + merged
        self.table.params = new_params
        self._base = new_params.clone()
        if self.opt_sync == "avg":
            avg_table_opt_state(self.table, self.plane)
        self.sync_rounds += 1
        self._synced_at = self.clock

    def finalize(self) -> PyTree:
        """Merge any tail of local steps not yet synced; afterwards every
        process holds identical parameters. All processes call this
        together. Idempotent at the same clock: an unmatched extra
        collective on one process would hang the job."""
        if self.clock != self._synced_at:
            self._sync()
        return self.params


def validate_snapshot_schedule(ckpt_dir, save_at: int, restore_from: int,
                               iters: int, sync_every: int) -> int:
    """Snapshots are meaningful only at SYNC boundaries (replicas are
    identical right after a merge). Returns the resolved save step;
    refuses (SystemExit) any schedule that would break that."""
    if ckpt_dir and not save_at and not restore_from:
        # --save-at 0 means "at the end"; here the end must be a sync
        # boundary, so round DOWN
        save_at = (iters // sync_every) * sync_every
        if save_at == 0:
            raise SystemExit(
                f"--checkpoint-dir with --iters {iters} < "
                f"--sync-every {sync_every}: no sync boundary ever "
                "happens, nothing to snapshot")
    for flag, val in (("--save-at", save_at),
                      ("--restore-from", restore_from)):
        if val and val % sync_every:
            raise SystemExit(
                f"{flag} {val} is not a sync boundary (sync-every "
                f"{sync_every}); CollectiveSSP snapshots must land "
                "right after a merge, where replicas are identical")
    if (save_at or restore_from) and not ckpt_dir:
        raise SystemExit("--save-at/--restore-from need --checkpoint-dir")
    return save_at


def _restore_snapshot(trainer: CollectiveSSP, path: str, rank: int,
                      nprocs: int, restore_from: int) -> None:
    if not os.path.exists(path):
        # per-rank snapshots: optimizer moments are rank-private under
        # opt_sync='local', so a new world size has no moments to load
        raise SystemExit(
            f"no CSSP snapshot for rank {rank} at step {restore_from} "
            f"under {os.path.dirname(path)} — CollectiveSSP resumes at the "
            "world size that saved (per-rank optimizer moments cannot be "
            "resharded); relaunch with the original process count or "
            "start fresh")
    state = np.load(path)
    saved_n = int(state["nprocs"]) if "nprocs" in state.files else None
    if saved_n is not None and saved_n != nprocs:
        raise SystemExit(
            f"CSSP snapshot at step {restore_from} was saved by "
            f"{saved_n} processes, this relaunch has {nprocs} — "
            "CollectiveSSP resumes at the world size that saved "
            "(per-rank optimizer moments cannot be resharded)")
    t = trainer.table
    t.params = _tensor_like(state["params"], t.params)
    n_saved = len([k for k in state.files if k.startswith("opt")])
    if n_saved != len(t.opt_state):
        raise SystemExit(
            f"checkpoint carries {n_saved} optimizer leaves but "
            f"this run's --updater produces {len(t.opt_state)} — "
            "resume with the updater the snapshot was saved under")
    for j, cur in enumerate(t.opt_state):
        if tuple(state[f"opt{j}"].shape) != tuple(cur.shape):
            raise SystemExit(
                f"checkpoint optimizer leaf {j} has shape "
                f"{state[f'opt{j}'].shape}, this run expects "
                f"{tuple(cur.shape)} — different updater or model shape")
    t.opt_state = [_tensor_like(state[f"opt{j}"], cur)
                   for j, cur in enumerate(t.opt_state)]
    trainer._base = t.params.clone()
    if trainer._residual is not None:
        # the residual is part of the trajectory: a zeroed one would
        # silently diverge from the uninterrupted run
        if "residual" not in state:
            raise SystemExit(
                "checkpoint has no error-feedback residual but this "
                "run uses --sync-comm compression — it was written "
                "by a float32-wire run; resume with the same "
                "--sync-comm it was saved under")
        trainer._residual = _tensor_like(state["residual"], t.params)
    elif "residual" in state:
        raise SystemExit(
            "checkpoint carries an error-feedback residual (written "
            "under --sync-comm compression) but this run uses the "
            "float32 wire — resume with the same --sync-comm")
    # the clock vector restarts where the snapshot was taken
    trainer.clock = trainer._synced_at = int(state["clock"])
    trainer.sync_rounds = int(state["sync_rounds"])


def _save_snapshot(trainer: CollectiveSSP, path: str, nprocs: int) -> None:
    """Each rank's own copy (its optimizer moments are rank-private);
    atomic tmp+rename, so a crash never leaves a torn snapshot."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = trainer.table
    extra = ({"residual": _host(trainer._residual)}
             if trainer._residual is not None else {})
    np.savez(path + ".tmp.npz", params=_host(t.params), clock=trainer.clock,
             sync_rounds=trainer.sync_rounds, nprocs=nprocs, **extra,
             **{f"opt{j}": _host(leaf) for j, leaf in enumerate(t.opt_state)})
    os.replace(path + ".tmp.npz", path)


def sync_wire_ok(record: list[dict], comm: str) -> bool:
    """The wire proof per format: one float32 all-reduce, or the
    compressed legs' all-to-all and all-gather carrying ``comm``."""
    ops = {(r["op"], r["dtype"]) for r in record}
    if comm == "float32":
        return ops == {("all_reduce", "float32")}
    return {("all_to_all", comm), ("all_gather", comm)} <= ops


def done_common(trainer, args, staleness, rank, nprocs, multi, t0,
                losses) -> dict:
    """The done-line keys every CollectiveSSP-family runner prints."""
    return {
        "rank": rank, "event": "done", "mode": args.mode,
        "wall_s": round(time.monotonic() - t0, 4),
        "multi": multi, "process_count": nprocs,
        "global_devices": nprocs, "local_devices": 1,
        "device": str(trainer.plane.device),
        "staleness": (None if staleness == float("inf")
                      else int(staleness)),
        "sync_every": args.sync_every,
        "opt_sync": getattr(args, "opt_sync", "local"),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": [round(x, 8) for x in losses],
        "gate_waits": trainer.gate_waits,
        "max_skew_seen": trainer.max_skew_seen,
        "sync_rounds": trainer.sync_rounds,
        "sync_backend": trainer.plane.backend,
        "sync_launches": trainer.plane.launches,
        "sync_bytes": trainer.plane.bytes,
        "sync_plane_devices": nprocs,
    }


def run_ssp_spmd(args, rank: int, nprocs: int, multi: bool,
                 watchdog) -> int:
    """The multihost_example ``--model lr --mode bsp|ssp|asp`` runner: LR
    on synthetic data, per-process batch slices, CollectiveSSP training,
    one JSON result line per rank.

    ``--oracle-hosts K`` (single process only) instead SIMULATES K
    processes one after another on this process's device: the same
    local-step math and the same fixed-clock merge schedule, so the loss
    streams the real K-process run must reproduce (the gate changes
    overlap, never math)."""
    from minips_tpu_torch.models import lr as lr_model

    B, D = args.batch, args.dim
    staleness = staleness_for(args.mode, args.staleness)
    rng = np.random.default_rng(args.seed)
    w_true = rng.normal(size=D)

    def next_global():
        x = rng.normal(size=(B, D)).astype(np.float32)
        y = (x @ w_true > 0).astype(np.float32)
        return x, y

    if args.oracle_hosts:
        if getattr(args, "sync_comm", "float32") != "float32":
            raise SystemExit(
                "--oracle-hosts is the BITWISE float32 oracle; the "
                "compressed wire has its own tolerance test — run the "
                "oracle without --sync-comm")
        if nprocs > 1:
            raise SystemExit("--oracle-hosts is a single-process "
                             "simulation; run it without the launcher")
        return _run_oracle(args, next_global)

    if B % nprocs:
        raise SystemExit(f"--batch {B} must divide by {nprocs} processes")
    per = B // nprocs
    t0 = time.monotonic()
    trainer = CollectiveSSP(
        lr_model.init(D, device=args.device), lr_model.grad_fn_dense,
        updater=args.updater, lr=args.lr, staleness=staleness,
        sync_every=args.sync_every, bus=getattr(watchdog, "bus", None),
        monitor=getattr(watchdog, "monitor", None),
        opt_sync=getattr(args, "opt_sync", "local"),
        sync_comm=getattr(args, "sync_comm", "float32"),
        device=args.device)

    watchdog.ready()
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    save_at = validate_snapshot_schedule(
        ckpt_dir, getattr(args, "save_at", 0),
        getattr(args, "restore_from", 0), args.iters, args.sync_every)
    restore_from = getattr(args, "restore_from", 0)

    start = 0
    if restore_from:
        _restore_snapshot(trainer, os.path.join(
            ckpt_dir, f"cssp_step{restore_from}_r{rank}.npz"), rank, nprocs,
            restore_from)
        start = restore_from
        for _ in range(start):      # shared-stream fast-forward
            next_global()

    losses = []
    jitter_rng = np.random.default_rng(1000 + rank)

    def run_steps():
        for i in range(start, args.iters):
            if getattr(args, "kill_at", 0) and rank == args.kill_rank \
                    and i == args.kill_at:
                os._exit(137)
            x, y = next_global()
            if args.slow_ms and rank == args.slow_rank:
                time.sleep(args.slow_ms / 1000.0)
            if args.jitter_ms and jitter_rng.random() < args.jitter_prob:
                time.sleep(args.jitter_ms / 1000.0)
            losses.append(trainer.step(
                {"x": x[rank * per:(rank + 1) * per],
                 "y": y[rank * per:(rank + 1) * per]}))
            if save_at and i + 1 == save_at:
                _save_snapshot(trainer, os.path.join(
                    ckpt_dir, f"cssp_step{save_at}_r{rank}.npz"), nprocs)

    # a dead peer surfaces as an instant transport error in the sync
    # collective, beating the heartbeat watchdog: absorbing() holds for the
    # monitor to name the corpse (peer_failure, exit 42) or re-raises.
    # finalize() and the fingerprint are collectives too.
    with watchdog.absorbing():
        run_steps()
        trainer.finalize()
        fp = float(cluster.host_copy(trainer.table.params).sum())
    record = trainer.sync_record()
    comm = getattr(args, "sync_comm", "float32")
    watchdog.disarm()
    cluster.barrier("cssp_done")
    print(json.dumps({
        **done_common(trainer, args, staleness, rank, nprocs, multi, t0,
                      losses),
        "sync_comm": comm,
        "param_fingerprint": fp,
        "sync_record": record,
        "sync_hlo_has_all_reduce": any(r["op"] == "all_reduce"
                                       for r in record),
        "sync_hlo_wire_ok": sync_wire_ok(record, comm),
        "resumed_from": start,
    }), flush=True)
    watchdog.close()
    return 0


def _run_oracle(args, next_global) -> int:
    """Sequential K-virtual-process simulation (one process, one device):
    K DenseTables run the identical local-step program, and the merge
    applies the delta SUM at the same fixed clocks — the bitwise
    reference for the real K-process run."""
    from minips_tpu_torch.models import lr as lr_model

    K = args.oracle_hosts
    B = args.batch
    if B % K:
        raise SystemExit(f"--batch {B} must divide by {K} oracle hosts")
    per = B // K
    dev = resolve_device(args.device)
    tables, steps, bases = [], [], []
    for h in range(K):
        t = DenseTable(lr_model.init(args.dim, device=dev), name=f"h{h}",
                       updater=args.updater, lr=args.lr, device=dev)
        tables.append(t)
        steps.append(t.make_step(lr_model.grad_fn_dense))
        bases.append(t.params.clone())
    losses = [[] for _ in range(K)]
    for i in range(args.iters):
        x, y = next_global()
        for h in range(K):
            batch = _on({"x": x[h * per:(h + 1) * per],
                         "y": y[h * per:(h + 1) * per]}, dev)
            losses[h].append(float(tables[h].step_inplace(steps[h], batch)))
        if (i + 1) % args.sync_every == 0 or i + 1 == args.iters:
            # merged = base + sum of per-host deltas, like the collective
            deltas = [tables[h].params - bases[h] for h in range(K)]
            total = deltas[0]
            for d in deltas[1:]:
                total = total + d
            for h in range(K):
                tables[h].params = bases[h] + total
                bases[h] = tables[h].params.clone()
            if getattr(args, "opt_sync", "local") == "avg":
                # avg_table_opt_state's rule, simulated
                padded = tables[0].padded
                for j, leaf in enumerate(tables[0].opt_state):
                    if not is_avg_leaf(leaf, padded):
                        continue
                    acc = tables[0].opt_state[j].to(torch.float32)
                    for t in tables[1:]:
                        acc = acc + t.opt_state[j].to(torch.float32)
                    mean = (acc / K).to(leaf.dtype)
                    for t in tables:
                        t.opt_state[j] = mean.clone()
    fps = [float(t.params.detach().cpu().numpy().sum()) for t in tables]
    print(json.dumps({
        "rank": 0, "event": "done", "mode": args.mode, "oracle": True,
        "oracle_hosts": K, "sync_every": args.sync_every,
        "opt_sync": getattr(args, "opt_sync", "local"),
        "device": str(dev),
        "losses_per_host": [[round(x, 8) for x in ls] for ls in losses],
        "param_fingerprints": fps,
    }), flush=True)
    return 0
