"""Shared app scaffolding — the port of the single-process part of
``minips_tpu/apps/common.py``: parse flags, build the config, run, log
metrics; the holdout split and its AUC; the threaded-worker loop.

``app_main`` adds a ``--device`` flag (the card by default, ``cpu`` to run
the plain CPU versions) and ``--ranks N``: 0, the default, runs one
process with no process group; N >= 1 spawns N ranks through
``parallel/mesh.py:run_ranks`` (one card each, NCCL; gloo ranks on the
CPU with ``--device cpu``), each calling the app's ``run(cfg, args,
metrics, group)``, and rank 0 logs the metrics. Every rank draws the same
global data and batches from the same seed: the spmd paths take the
rank's rows of each batch, the threaded paths run their workers on rank
0 while the other ranks serve the tables (``core/engine.py``).

The multi-process helpers (``init_multiproc`` and what follows it) are
the JAX module's, for the apps' ``--exec multiproc``: one process per
launcher rank (``launch.py``), the tables key-range-sharded over them
(``train/sharded_ps.py``), the servers numpy on the host, and each
process's model step on its own device (:func:`multiproc_device`).
``MINIPS_FORCE_CPU`` (the launcher's CPU-pinned ranks) acts as
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from minips_tpu_torch.core.config import (Config, add_config_flags,
                                          config_from_args)
from minips_tpu_torch.core.engine import Engine, MLTask
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group,
                                            broadcast_object, resolve_device,
                                            run_ranks, world)
from minips_tpu_torch.utils.metrics import MetricsLogger

# the spawned ranks of a CLI run: a training run may take days
CLI_TIMEOUT_S = 7 * 24 * 3600.0
# what a spawned rank hands back to the CLI: host values only
RESULT_KEYS = ("losses", "samples_per_sec", "auc", "rmse", "accuracy",
               "skew", "layout", "start_step", "generated")


def app_main(name: str, default_cfg: Config, run, extra_flags=None,
             exec_choices=("spmd", "threaded")):
    parser = argparse.ArgumentParser(prog=name)
    add_config_flags(parser)
    parser.add_argument("--exec", dest="exec_mode", default="spmd",
                        choices=list(exec_choices),
                        help="spmd: one fused step over the whole batch; "
                             "threaded: per-worker threads with the "
                             "consistency gate (reference semantics); "
                             "multiproc (where offered): key-range-sharded "
                             "PS across launcher processes")
    parser.add_argument("--device", default=None,
                        help="torch device for every table and step "
                             "(default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    parser.add_argument("--ranks", type=int, default=0,
                        help="processes to spawn, one device each, the "
                             "tables sharded over them (a card each, NCCL; "
                             "gloo ranks with --device cpu); 0: one "
                             "process, no process group")
    parser.add_argument("--profile_dir", default=None,
                        help="capture a torch.profiler trace of steps "
                             "10-12 (TrainLoop's profile window) into "
                             "this directory (python -m minips_tpu_torch."
                             "utils.trace_analysis DIR reads it)")
    if extra_flags is not None:
        extra_flags(parser)
    args = parser.parse_args()
    if os.environ.get("MINIPS_FORCE_CPU") and args.device is None:
        # the launcher's CPU-pinned ranks (the JAX package's escape hatch
        # pins its platform the same way)
        args.device = "cpu"
    cfg = config_from_args(args, default=default_cfg)
    metrics = MetricsLogger(cfg.train.metrics_path, verbose=True)
    try:
        return run_cli(run, cfg, args, metrics)
    finally:
        metrics.close()


def run_cli(run, cfg: Config, args, metrics, ranks: int | None = None):
    """``run(cfg, args, metrics)`` in this process, or, with ``ranks`` (by
    default ``args.ranks``) >= 1, on that many spawned ranks: rank 0's
    results (its ``RESULT_KEYS``). ``run`` is a module-level function."""
    n = getattr(args, "ranks", 0) if ranks is None else ranks
    if not n:
        return run(cfg, args, metrics)
    cpu = resolve_device(getattr(args, "device", None)).type == "cpu"
    return run_ranks(_rank_run, n, run, cfg, args,
                     device="cpu" if cpu else None,
                     timeout=CLI_TIMEOUT_S)[0]


def _rank_run(group, device, run, cfg, args) -> dict:
    """One spawned rank of a CLI run: rank 0 logs the metrics."""
    rank = world(group)[0]
    args.device = device
    metrics = MetricsLogger(cfg.train.metrics_path if rank == 0 else None,
                            verbose=rank == 0)
    try:
        out = run(cfg, args, metrics, group)
    finally:
        metrics.close()
    return {k: out[k] for k in RESULT_KEYS if k in out}


def global_batch(batch_size: int, group: Group) -> int:
    """``batch_size`` after checking that it splits evenly over the
    group's ranks (each rank trains on its rows of every batch)."""
    n = world(group)[1]
    if batch_size % n:
        raise SystemExit(f"--batch_size {batch_size} must divide by the "
                         f"{n}-way group")
    return batch_size


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def holdout_split(data: dict, frac: float, seed: int = 0):
    """Random row split into (train, holdout). ``frac`` is the holdout
    fraction; 0 disables (returns (data, None)). The same rows as the JAX
    package's split from the same seed."""
    if not 0.0 <= frac < 1.0:
        raise ValueError(f"eval fraction must be in [0, 1), got {frac}")
    n = len(next(iter(data.values())))
    n_hold = int(n * frac)
    if n_hold == 0:
        return data, None
    perm = np.random.default_rng(seed).permutation(n)
    hold, train = perm[:n_hold], perm[n_hold:]
    return ({k: v[train] for k, v in data.items()},
            {k: v[hold] for k, v in data.items()})


def score_holdout(predict, holdout, out: dict, metrics) -> dict:
    """Streaming ROC-AUC of ``predict`` on the holdout rows, recorded in
    both the result dict and the JSONL metrics. No-op when there is no
    holdout (``--eval_frac 0``)."""
    if holdout is not None:
        from minips_tpu_torch.utils.evaluation import evaluate_auc
        out["auc"] = evaluate_auc(predict, holdout)
        metrics.log(holdout_auc=out["auc"], holdout_rows=len(holdout["y"]))
    return out


# steps left out of a threaded run's rate, as TrainLoop's StepTimer leaves
# them out on the spmd path
WARMUP_STEPS = 2


def steady_rate(starts: list, batch_sizes: list, end: float,
                warmup: int = WARMUP_STEPS) -> float:
    """Samples/s of a threaded run on the spmd path's yardstick.
    ``starts[w]`` holds worker w's step start times (``time.perf_counter``)
    and ``batch_sizes[w]`` its batch. The clock starts once every worker has
    finished its first ``warmup`` steps and counts the batches of the steps
    begun since, up to ``end``. A worker begins a step when its previous
    one has ended (loss read on the host, tables clocked). 0.0 if a worker
    took no step after its warm-up, as ``StepTimer`` gives."""
    if any(len(s) <= warmup for s in starts):
        return 0.0
    t0 = max(s[warmup] for s in starts)
    n = sum(b * sum(t >= t0 for t in s) for s, b in zip(starts, batch_sizes))
    return n / (end - t0) if end > t0 else 0.0


def run_rate(engine: Engine, starts: list, batch_sizes: list) -> float:
    """:func:`steady_rate` of a threaded run that ``engine.run`` has just
    ended, with the device drained; under a group, rank 0's (whose
    threads ran the workers), on every rank."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    rate = steady_rate(starts, batch_sizes, time.perf_counter())
    return broadcast_object(rate, 0, engine.group)


def mean_losses(per_worker: list) -> list[float]:
    """The workers' losses averaged step by step, up to the shortest."""
    n = min(len(v) for v in per_worker)
    return [float(np.mean([w[i] for w in per_worker])) for i in range(n)]


def threaded_train(engine: Engine, cfg: Config, data: dict, step_fn,
                   *, clock_tables: list[str],
                   n_iters: int | None = None) -> tuple[list[float], float]:
    """Shared threaded-worker loop (the reference's UDF shape): each worker
    iterates its data shard, calls ``step_fn(info, batch) -> loss`` (which
    pulls and pushes through the consistency gate; step_fn scales grads by
    1/num_workers where the updater expects a mean), clocks the listed
    tables, and per-iteration losses are averaged across workers.

    Returns ``(mean_losses, samples_per_sec)``: the rate is
    :func:`steady_rate` over the workers' step start times, up to the end
    of the run with the device drained (the JAX package reports 0.0).
    Under a group every rank returns rank 0's."""
    n_iters = n_iters or cfg.train.num_iters
    n_rows = len(next(iter(data.values())))
    shards = np.array_split(np.arange(n_rows), engine.num_workers)
    sizes = [min(cfg.train.batch_size, max(len(s) // 2, 1)) for s in shards]

    def udf(info):
        shard = shards[info.worker_id]
        batches = BatchIterator(
            {k: v[shard] for k, v in data.items()},
            sizes[info.worker_id], seed=cfg.train.seed + info.worker_id)
        losses, starts = [], []
        for batch, _ in zip(batches, range(n_iters)):
            starts.append(time.perf_counter())
            losses.append(float(step_fn(info, batch)))
            for t in clock_tables:
                info.table(t).clock()
        return losses, starts

    per_worker = engine.run(MLTask(fn=udf))
    rate = run_rate(engine, [s for _, s in per_worker], sizes)
    return mean_losses([losses for losses, _ in per_worker]), rate


def multiproc_device(device: DeviceLike = None) -> torch.device:
    """The device of a launched rank's model step: ``device`` when given
    (``cpu`` under ``MINIPS_FORCE_CPU``, see ``app_main``), else
    ``cuda:{MINIPS_LOCAL_RANK mod device_count}``, one card per colocated
    rank as ``run_ranks`` places them; raises without CUDA.

    On the CPU the host's cores are divided among its colocated ranks
    (``MINIPS_LOCAL_PROCS``) unless ``OMP_NUM_THREADS`` sets the count:
    each rank's intra-op threads spinning on every core would starve the
    others' receive threads. The count is applied here, not left to the
    import: a forked rank imported torch before the launcher gave it its
    environment. A card's first
    context and cuBLAS handle take long enough to miss a peer's heartbeat
    timeout, so on the card one small forward and backward runs here,
    before ``init_multiproc`` starts the monitor."""
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            local = int(os.environ.get("MINIPS_LOCAL_PROCS", "1"))
            torch.set_num_threads(int(os.environ.get(
                "OMP_NUM_THREADS", max(1, (os.cpu_count() or 1) // local))))
        return dev
    resolve_device(None)  # raises without CUDA
    local = int(os.environ.get("MINIPS_LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    x = torch.ones(8, 8, device=dev, requires_grad=True)
    (x @ x).sum().backward()
    torch.cuda.synchronize(dev)
    return dev


def init_multiproc(consistency: str, staleness: int):
    """Shared launcher-side bootstrap for the sharded-PS apps: env wiring,
    heartbeat monitor, bsp/ssp/asp → staleness value. Exits rc 2 with the
    protocol error line when run without the launcher."""
    import json
    import sys

    from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor
    from minips_tpu_torch.launch import init_from_env

    rank, nprocs, bus = init_from_env()
    if bus is None:
        print(json.dumps({"rank": 0, "event": "error",
                          "err": "multiproc mode needs the launcher "
                                 "(n >= 2)"}), flush=True)
        sys.exit(2)
    # arm the wire tracer (MINIPS_TRACE; no-op when unset) BEFORE the
    # heartbeat monitor starts: the hb receipts it records are the
    # merge tool's clock-alignment samples, earliest beats included
    from minips_tpu_torch.obs import tracer as _trc

    _trc.maybe_init(rank)
    s = {"bsp": 0, "ssp": staleness, "asp": float("inf")}[consistency]
    monitor = HeartbeatMonitor(bus, peer_ids=list(range(nprocs)),
                               interval=0.2, timeout=2.0).start()
    return rank, nprocs, bus, monitor, s


def run_multiproc_body(rank: int, trainer, body) -> int:
    """Run ``body()`` under the smoke/bench failure protocol: a
    PeerFailureError prints the peer_failure event and maps to exit 42, a
    TimeoutError to gate_timeout/43, and a FencedOutError — the fleet
    convicted THIS (alive) rank during a partition and moved on — to
    fenced_out/44 (the codes the fault drills assert)."""
    import json

    from minips_tpu_torch.consistency.gate import (FencedOutError,
                                                   PeerFailureError)

    try:
        body()
        return 0
    except FencedOutError as e:
        print(json.dumps({"rank": rank, "event": "fenced_out",
                          "term": e.term,
                          "at_clock": trainer.clock}), flush=True)
        return 44
    except PeerFailureError as e:
        print(json.dumps({"rank": rank, "event": "peer_failure",
                          "dead": sorted(e.dead),
                          "at_clock": trainer.clock}), flush=True)
        return 42
    except TimeoutError as e:
        print(json.dumps({"rank": rank, "event": "gate_timeout",
                          "err": str(e)}), flush=True)
        return 43


def step_negotiator(bus, nprocs: int):
    """Cross-rank agreement on which checkpoint step to resume from.

    Shard checkpoints are rank-local (each process dumps its own row
    range); a valid resume needs ONE global step every rank can restore —
    shards restored at mixed steps would be a torn table. Ranks exchange
    their FULL held-step lists and take the newest step in the
    intersection: min-of-newest is not enough, because the checkpointer's
    retention GC (keep=N) may already have deleted the straggler's newest
    step on ranks that ran ahead (ASP, or SSP slack, lets survivors save
    several steps past a corpse before detecting it). Returns 0 (fresh
    start) when no common step exists. Call BEFORE ``bus.handshake``
    (handler registration), then invoke the returned ``agree(my_steps)``
    after it.
    """
    import threading
    import time

    held: dict[int, set] = {}
    cond = threading.Condition()

    def on_steps(sender, payload):
        with cond:
            held[sender] = set(int(s) for s in payload["steps"])
            cond.notify_all()

    bus.on("ckptSteps", on_steps)

    ready: set = set()

    def on_ready(sender, payload):
        with cond:
            ready.add(sender)
            cond.notify_all()

    bus.on("ckptReady", on_ready)

    def agree(my_steps, timeout: float = 10.0) -> int:
        bus.publish("ckptSteps", {"steps": [int(s) for s in my_steps]})
        deadline = time.monotonic() + timeout
        with cond:
            while len(held) < nprocs - 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "checkpoint-step negotiation timed out "
                        f"(heard from {sorted(held)} of {nprocs - 1} peers)")
                cond.wait(0.25)
            common = set(int(s) for s in my_steps)
            for s in held.values():
                common &= s
        return max(common, default=0)

    def restore_barrier(timeout: float = 30.0) -> None:
        """Rendezvous AFTER every rank finished restoring its shard and
        BEFORE anyone trains: under ASP (or SSP slack ≥ the restored
        clock) a fast rank's first pushes could otherwise land in a
        peer's shard mid-restore and be wiped by its ``_w[...] =``
        overwrite — unbounded silent update loss unique to resume."""
        bus.publish("ckptReady", {})
        deadline = time.monotonic() + timeout
        with cond:
            while len(ready) < nprocs - 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "post-restore barrier timed out "
                        f"(heard from {sorted(ready)} of {nprocs - 1} "
                        "peers)")
                cond.wait(0.25)

    return agree, restore_barrier


def shard_checkpointing(bus, nprocs: int, checkpoint_dir, rank: int):
    """The sharded-PS apps' whole recovery bootstrap in one place (the
    protocol is subtle enough that hand-synced copies would drift —
    docs/architecture.md "Sharded-PS recovery protocol").

    Call BEFORE ``bus.handshake`` (it registers the negotiation
    handlers). Returns ``resume(tables, every)`` to call AFTER the
    handshake, which negotiates the newest step every rank holds, prunes
    dead-incarnation steps above it, restores, rendezvouses, and returns
    ``(start_iter, save_hook)`` — call ``save_hook(i)`` after each
    ``trainer.tick()`` (clock == i+1 there, which is what gets stamped).
    With no ``checkpoint_dir`` the returned ``resume`` is a no-op
    yielding ``(0, save_hook=no-op)``.
    """
    import os

    if not checkpoint_dir:
        return lambda tables, every=0: (0, lambda i: None)
    agree, restore_barrier = step_negotiator(bus, nprocs)

    def resume(tables: dict, every: int = 0):
        from minips_tpu_torch.ckpt import elastic
        from minips_tpu_torch.ckpt.checkpoint import Checkpointer

        my_dir = os.path.join(checkpoint_dir, f"rank{rank}")
        ck = Checkpointer(my_dir, tables)
        # ---- decision phase: READS ONLY. agree() is a rendezvous, the
        # elastic scan reads the shared dir, and no rank writes until
        # past restore_barrier — so every rank reaches the SAME decision
        # (a pre-barrier prune could race a peer's scan into a divergent
        # one).
        #
        # Negotiate only over steps saved under MY CURRENT partition: a
        # surviving rank relaunched into a different world size still
        # holds old-world steps whose lo/shard_size don't fit this table
        # — offering them would crash (or corrupt) the restore.
        mine = [s for s in ck.list_steps()
                if elastic.step_matches_layout(my_dir, s, tables)]
        common = agree(mine)
        # The newest complete checkpoint wins REGARDLESS of world size:
        # a same-layout common step can be OLDER than another world's
        # newest one (this rank's pre-shrink saves vs the shrunk world's
        # later training) — restoring it would silently roll training
        # back, and the prune below would then delete the newer world's
        # checkpoint.
        found = elastic.find_elastic_step(checkpoint_dir, tables)
        if found is not None and found[0] > common:
            # ELASTIC path (ckpt/elastic.py; requires a shared
            # checkpoint_dir — the reference's HDFS assumption): the
            # newest complete checkpoint belongs to a DIFFERENT world
            # size, so each rank reassembles its row range from the old
            # shards' overlapping slices, optimizer state included.
            step, old_n = found
            clock = elastic.read_saved_clock(checkpoint_dir, step)
            # the MINIPS_RESHARD staging cap bounds the restore's
            # transient chunks too (mover (c) of the planned
            # redistribution); unarmed, the streamer's own 64 MiB
            # default still keeps peak staging shard-independent
            from minips_tpu_torch.balance.redistribute import maybe_config
            rcfg = maybe_config()
            for name, t in tables.items():
                if hasattr(t, "shard_lo"):  # a ShardedTable
                    t.load_shard_state_dict(
                        elastic.reshard_table_state(
                            checkpoint_dir, step, old_n, name,
                            t.num_rows, t.shard_lo, t.part.shard_size,
                            cap_bytes=(rcfg.cap if rcfg is not None
                                       else None)))
                else:  # the trainer: clock vector (publishes it)
                    t.load_state_dict({"clock": np.asarray(clock)})
            common = step
        elif common > 0:
            ck.restore(common)  # trainer restore publishes the clock
        # nobody trains until every rank's shard overwrite is done: an
        # early rank's pushes into a mid-restore peer shard would be wiped
        restore_barrier()
        # ---- write phase. Steps above the chosen one belong to a dead
        # incarnation; left behind they could win a LATER negotiation
        # with mixed-incarnation shards (torn table). With common == 0
        # (fresh start) this wipes all local steps — nothing complete
        # exists anywhere, so they are torn junk. The elastic path
        # deliberately does NOT re-publish the resharded state at the
        # restored step: overwriting the old world's files would be
        # non-atomic across ranks, and a crash mid-republish would
        # destroy the only consistent copy — instead the next crash
        # simply reshards again, until the first post-resume save
        # creates new-layout steps.
        ck.prune_above(common)

        def save_hook(i: int) -> None:
            if every and (i + 1) % every == 0:
                ck.save(i + 1)

        return common, save_hook

    return resume


def loop_profile(args) -> dict:
    """``TrainLoop``'s ``profile_dir`` from ``--profile_dir`` (nothing
    when no directory is given)."""
    log_dir = getattr(args, "profile_dir", None)
    return {"profile_dir": log_dir} if log_dir else {}


def add_push_comm_flag(parser) -> None:
    """The shared --push-comm flag (one canonical definition for every
    sharded-PS app) — the push-wire compression ladder:

    - ``int8``: per-row absmax codes + stochastic rounding (unbiased,
      no residual — ops/quantized_comm.quantize_rows_int8);
    - ``topk8``/``topk4``: sparse top-k index+code streams — magnitude
      selection over the owner-split gradient plus blockwise absmax
      quantization at 8/4 bits, with the unsent mass kept in a
      client-side error-feedback residual store flushed under the
      staleness bound (train/sharded_ps.ResidualStore; docs/api.md
      wire ladder).

    Default None = ``$MINIPS_PUSH_COMM`` (empty = float32), resolved
    by the table so env-armed sweeps need no flag plumbing."""
    parser.add_argument("--push-comm", dest="push_comm", default=None,
                        choices=["float32", "int8", "topk8", "topk4"])


def add_wire_flags(parser) -> None:
    """The full overlapped-pipeline knob set, one canonical definition:
    ``--push-comm`` (compressed push wire, above), ``--pull-wire``
    (int8-compress pull REPLIES — per-row absmax codes, round-to-nearest
    so every puller decodes identical bytes; same dim ≳ 8 economics),
    ``--overlap`` (async ack-windowed pushes + double-buffered pull
    prefetch — the latency levers; consistency is preserved by the hard
    drain at clock boundaries and future-clock-stamped prefetches), and
    ``--push-window`` (max unacked cross-process push frames)."""
    add_push_comm_flag(parser)
    parser.add_argument("--pull-wire", dest="pull_wire",
                        default="f32", choices=["f32", "int8"])
    parser.add_argument("--overlap", action="store_true",
                        help="async push + pull prefetch (overlapped "
                             "PS pipeline)")
    parser.add_argument("--overlap-legs", dest="overlap_legs",
                        default="both", choices=["both", "pull", "push"],
                        help="which overlap levers --overlap enables: "
                             "the levers are independently gated and "
                             "cost differently — pull prefetch is pure "
                             "latency hiding, async push adds a sender "
                             "thread + ack traffic that can cost more "
                             "than it hides on CPU-oversubscribed "
                             "hosts (the bench sweeps both)")
    parser.add_argument("--push-window", dest="push_window",
                        type=int, default=32)
    parser.add_argument("--cache-bytes", dest="cache_bytes",
                        type=int, default=0,
                        help="clock-versioned client row cache, LRU "
                             "byte bound (0 = off): pulls are served "
                             "locally for rows whose reply stamp still "
                             "satisfies the SSP admission rule — a hit "
                             "is provably no staler than a synchronous "
                             "pull (docs/consistency.md)")
    parser.add_argument("--no-pull-dedup", dest="pull_dedup",
                        action="store_false", default=True,
                        help="ship pull requests verbatim (duplicate "
                             "keys and all) instead of unique keys — "
                             "the pre-cache wire, kept as the bench's "
                             "A/B baseline; incompatible with "
                             "--cache-bytes > 0")
    parser.add_argument("--no-push-dedup", dest="push_dedup",
                        action="store_false", default=True,
                        help="ship pushes per-occurrence instead of "
                             "coalescing duplicate keys client-side "
                             "(the seed wire; the server still sums) "
                             "— the bench's A/B baseline")


def table_wire_kwargs(args) -> dict:
    """The ShardedTable kwargs every sharded-PS app derives from
    add_wire_flags — one mapping so a new wire knob can't silently miss
    an app (async_push stays per-app: it also depends on
    --overlap-legs)."""
    return {"push_comm": args.push_comm, "pull_wire": args.pull_wire,
            "push_window": args.push_window,
            "cache_bytes": args.cache_bytes,
            "pull_dedup": args.pull_dedup,
            "push_dedup": args.push_dedup}


def emit_multiproc_done(trainer, rank: int, t0: float, losses,
                        table_bytes: int, fingerprint: float,
                        **extra) -> None:
    """The launcher-protocol result line shared by every sharded-PS app:
    the launcher harvests the LAST JSON line on stdout, smoke tests assert
    these fields (replica agreement via param_fingerprint, 1/N memory via
    local_bytes vs table_bytes, skew bound, wire accounting).

    The wire-health block is ``utils/metrics.wire_record`` SPLATTED, not
    hand-copied: every field it grows (the ``hist`` p50/p95/p99 block,
    the ``timing``/``cache`` sub-records) reaches every app's done line
    the day it lands — hand-synced copies are how the sweep scrapers
    desynced before (tests/test_obs_trace.py pins the layout)."""
    import json
    import time

    import numpy as np

    from minips_tpu_torch.utils.metrics import wire_record

    print(json.dumps({
        "rank": rank, "event": "done",
        "wall_s": round(time.monotonic() - t0, 4),
        "loss_first": losses[0] if losses else None,
        "loss_last": float(np.mean(losses[-5:])) if losses else None,
        "gate_waits": trainer.gate_waits,
        "max_skew_seen": trainer.max_skew_seen,
        # bytes both ways, drop/loss/malformed counters, per-leg timing
        # + histograms, cache/reliable/chaos/serve/rebalance blocks
        # (None = that layer off, {}/zero-count = armed but idle)
        **wire_record(trainer),
        "local_bytes": trainer.local_bytes(),
        "table_bytes": int(table_bytes),
        "param_fingerprint": fingerprint,
        "clock": trainer.clock,
        **extra,
    }), flush=True)
