"""Shared app scaffolding — the port of the single-process part of
``minips_tpu/apps/common.py``: parse flags, build the config, run, log
metrics; the holdout split and its AUC; the threaded-worker loop.

``app_main`` adds a ``--device`` flag (the card by default, ``cpu`` to run
the plain CPU versions). The multi-process helpers of the JAX module wait
for the sharded PS (ROADMAP.md queue 1 items 14 and 15).
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
from minips_tpu_torch.utils.metrics import MetricsLogger


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
    if extra_flags is not None:
        extra_flags(parser)
    args = parser.parse_args()
    cfg = config_from_args(args, default=default_cfg)
    metrics = MetricsLogger(cfg.train.metrics_path, verbose=True)
    try:
        return run(cfg, args, metrics)
    finally:
        metrics.close()


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
    of the run with the device drained (the JAX package reports 0.0)."""
    n_iters = n_iters or cfg.train.num_iters
    n_rows = len(next(iter(data.values())))
    shards = np.array_split(np.arange(n_rows), engine.num_workers)
    sizes = [min(cfg.train.batch_size, max(len(s) // 2, 1)) for s in shards]
    losses_by_worker: dict[int, list[float]] = {}
    starts: list[list[float]] = [[] for _ in shards]

    def udf(info):
        shard = shards[info.worker_id]
        batches = BatchIterator(
            {k: v[shard] for k, v in data.items()},
            sizes[info.worker_id], seed=cfg.train.seed + info.worker_id)
        losses = []
        for batch, _ in zip(batches, range(n_iters)):
            starts[info.worker_id].append(time.perf_counter())
            losses.append(float(step_fn(info, batch)))
            for t in clock_tables:
                info.table(t).clock()
        losses_by_worker[info.worker_id] = losses

    engine.run(MLTask(fn=udf))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    rate = steady_rate(starts, sizes, time.perf_counter())
    n = min(len(v) for v in losses_by_worker.values())
    return [float(np.mean([losses_by_worker[w][i]
                           for w in losses_by_worker]))
            for i in range(n)], rate
