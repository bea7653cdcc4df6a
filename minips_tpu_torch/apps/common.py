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
0 while the other ranks serve the tables (``core/engine.py``). The
multi-process helpers of the JAX module wait for the sharded PS
(ROADMAP.md queue 1 items 14 and 15).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from minips_tpu_torch.core.config import (Config, add_config_flags,
                                          config_from_args)
from minips_tpu_torch.core.engine import Engine, MLTask
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.parallel.mesh import (Group, broadcast_object,
                                            resolve_device, run_ranks, world)
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
    if extra_flags is not None:
        extra_flags(parser)
    args = parser.parse_args()
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
