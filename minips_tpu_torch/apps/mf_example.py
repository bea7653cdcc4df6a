"""mf_example — matrix factorization on MovieLens-shaped data, the port of
``minips_tpu/apps/mf_example.py`` (BASELINE.json:9: "Matrix factorization
on MovieLens-20M, async ASP").

User and item factor rows (rank 8 plus a bias column, D = 9) live in two
SparseTables with identity-mapped keys, so every user and item owns a row.
Two modes:

- ``--exec spmd``: one ``PSTrainStep`` a batch, gathering both tables'
  rows through the row-gather kernel, differentiating the squared error
  and row-updating both tables, the gradients scaled by the batch size;
- ``--exec threaded``: ``--num_workers`` threads under the configured
  consistency model (ASP by default, the reference's), each pulling its
  batch's rows and pushing its gradients scaled by B / NW.

``--data_file`` reads MovieLens ratings (``ratings.csv``, ``ratings.dat``
or ``u.data``); ``--eval_frac`` holds ratings out and scores them by RMSE.
``run(cfg, args, metrics, group)`` runs one rank of a process group (the
CLI's ``--ranks N``), both tables range-sharded over the ranks, each rank
stepping on its rows of every batch (spmd) or serving rank 0's workers
(threaded); every rank scores the holdout (its pulls are collectives).
``--exec multiproc`` runs one launcher rank (``launch.py``) of the
key-range-sharded PS (``train/sharded_ps.py``): exact per-id user and
item rows partitioned over the processes, the servers numpy on the host,
this rank's step by autograd on its device (``multiproc_device``).

Usage: python -m minips_tpu_torch.apps.mf_example --num_iters 300
       MINIPS_FORCE_CPU=1 python -m minips_tpu_torch.launch --n 2 -- \\
    python -m minips_tpu_torch.apps.mf_example --exec multiproc
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          holdout_split, loop_profile,
                                          threaded_train)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.core.engine import Engine
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import mf as mf_model
from minips_tpu_torch.parallel.mesh import Group, resolve_device
from minips_tpu_torch.tables.sparse import SparseTable, next_pow2
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.train.ps_step import PSTrainStep

DEFAULT = Config(
    table=TableConfig(name="factors", kind="sparse", consistency="asp",
                      updater="sgd", lr=0.05, dim=9),  # rank 8 + bias col
    train=TrainConfig(batch_size=1024, num_iters=300),
)
MU = 3.0  # global rating mean offset
REG = 0.02
EVAL_CHUNK = 8192


def make_tables(cfg: Config, users: int, items: int, device,
                group: Group = None):
    """The user and item tables, sharded over ``group``. Capacities round
    up to a power of two (the slot hash masks), and the readers give dense
    0-based ids, so the identity map gives every user and item its own row
    (ML-20M's 138,493 users take 2^18 rows)."""
    mk = functools.partial(SparseTable, updater=cfg.table.updater,
                           lr=cfg.table.lr, init_scale=0.1, identity=True,
                           device=device, group=group)
    return (mk(next_pow2(users, 1 << 10), cfg.table.dim, seed=1, name="user"),
            mk(next_pow2(items, 1 << 11), cfg.table.dim, seed=2, name="item"))


def _load_ratings(cfg, args) -> dict:
    path = getattr(args, "data_file", None)
    if path:  # real MovieLens ratings (csv/dat/u.data)
        from minips_tpu_torch.data.movielens import read_ratings
        raw = read_ratings(path)
        return {k: raw[k] for k in ("user", "item", "rating")}
    return synthetic.movielens_like(seed=cfg.train.seed)


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run (``group``: the run's process group,
    ``None`` for one device); every rank calls it with the same ``cfg``
    and ``args``."""
    mode = getattr(args, "exec_mode", "spmd")
    if mode == "multiproc":
        return _run_multiproc(cfg, args, metrics)
    device = resolve_device(getattr(args, "device", None))
    data = _load_ratings(cfg, args)
    user_t, item_t = make_tables(cfg, int(data["user"].max()) + 1,
                                 int(data["item"].max()) + 1, device, group)
    data, holdout = holdout_split(data,
                                  getattr(args, "eval_frac", None) or 0.0,
                                  seed=cfg.train.seed)
    if mode == "threaded":
        return _run_threaded(cfg, metrics, data, user_t, item_t, holdout,
                             group)

    def loss_fn(dense_params, rows, batch):
        return mf_model.loss(rows["user"], rows["item"], batch["rating"],
                             mu=MU, reg=REG)

    # grad_scale=B: per-sample SGD magnitude (the reference's server-add
    # semantics) in place of the mean loss's 1/B-scaled row gradients
    ps = PSTrainStep(loss_fn, sparse={"user": user_t, "item": item_t},
                     key_fns={"user": lambda b: b["user"],
                              "item": lambda b: b["item"]},
                     grad_scale=cfg.train.batch_size, device=device,
                     group=group)
    batches = BatchIterator(data, global_batch(cfg.train.batch_size, group),
                            seed=cfg.train.seed)
    loop = TrainLoop(lambda b: ps(ps.shard_batch(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size,
                     **loop_profile(args))
    losses = loop.run(cfg.train.num_iters)
    metrics.log(final_loss=losses[-1],
                samples_per_sec=loop.timer.samples_per_sec)
    out = {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
           "tables": (user_t, item_t)}
    return _score_holdout_rmse(out, holdout, user_t, item_t, metrics)


def _score_holdout_rmse(out, holdout, user_t, item_t, metrics,
                        chunk: int = EVAL_CHUNK) -> dict:
    """Holdout RMSE, the MovieLens-standard number. Streams the holdout
    in fixed-size chunks (one row gather per table each), as
    ``evaluate_auc`` does, so a large holdout never makes one giant
    gather."""
    if holdout is None or not len(holdout["rating"]):
        return out
    from minips_tpu_torch.utils.evaluation import padded_chunks

    n = len(holdout["rating"])
    sq_err = 0.0
    with torch.no_grad():
        for batch, n_valid in padded_chunks(holdout, chunk):
            # a SparseTable pulls tensors, a ShardedTable numpy rows
            u, i = (torch.as_tensor(t.pull(batch[k])) for t, k in
                    ((user_t, "user"), (item_t, "item")))
            pred = mf_model.predict(u, i, mu=MU).cpu().numpy()
            err = pred[:n_valid] - batch["rating"][:n_valid]
            sq_err += float(np.sum(err * err))
    out["rmse"] = float(np.sqrt(sq_err / n))
    metrics.log(holdout_rmse=out["rmse"], holdout_rows=n)
    return out


def _run_threaded(cfg, metrics, data, user_t, item_t, holdout,
                  group) -> dict:
    from minips_tpu_torch.consistency import make_controller

    device = user_t.device
    engine = Engine(num_workers=cfg.train.num_workers, device=device,
                    group=group).start_everything()
    for name, t in (("user", user_t), ("item", item_t)):
        # --consistency/--staleness (asp is the reference's configuration)
        engine.register_table(name, t, make_controller(
            cfg.table.consistency, engine.num_workers,
            staleness=cfg.table.staleness, sync_every=0))

    def step_fn(info, batch):
        ut, it_ = info.table("user"), info.table("item")
        u_rows = ut.pull(keys=batch["user"])   # ASP: never blocks
        i_rows = it_.pull(keys=batch["item"])
        loss, gu, gi = mf_model.grad_fn(
            u_rows, i_rows,
            {"rating": torch.as_tensor(batch["rating"], device=device)},
            mu=MU, reg=REG)
        # the sum of per-sample gradients (the mean loss's times B, the
        # spmd path's grad_scale) over the NW workers that push once per
        # clock; the JAX package pushes B x the gradient from every worker,
        # an NW-times learning rate under sgd (see word2vec_example)
        scale = len(batch["rating"]) / info.num_workers
        ut.push(gu * scale, keys=batch["user"])
        it_.push(gi * scale, keys=batch["item"])
        return loss

    mean_losses, samples_per_sec = threaded_train(
        engine, cfg, data, step_fn, clock_tables=["user", "item"])
    engine.stop_everything()
    metrics.log(final_loss=mean_losses[-1], samples_per_sec=samples_per_sec)
    return _score_holdout_rmse(
        {"losses": mean_losses, "samples_per_sec": samples_per_sec,
         "tables": (user_t, item_t)}, holdout, user_t, item_t, metrics)


def _run_multiproc(cfg: Config, args, metrics) -> dict:
    """MF on the key-range-sharded PS: user/item factor tables PARTITIONED
    across launcher processes with EXACT per-key rows — MovieLens ids are
    dense and 0-based, so the range partitioner owns them directly, no
    hashing. The default is ASP (BASELINE.json:9 "async ASP"): pulls are
    never parked, pushes land whenever they arrive — the gate only
    engages under --consistency bsp/ssp."""
    import os
    import sys

    from minips_tpu_torch.apps.common import (emit_multiproc_done,
                                              init_multiproc,
                                              multiproc_device,
                                              run_multiproc_body,
                                              shard_checkpointing)
    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                                   ShardedTable,
                                                   table_state_bytes)

    dev = multiproc_device(getattr(args, "device", None))
    rank, nprocs, bus, monitor, staleness = init_multiproc(
        cfg.table.consistency, cfg.table.staleness)

    full = _load_ratings(cfg, args)
    # user/item universes are GLOBAL (every rank must agree on table
    # sizes); the rating rows are what shards round-robin
    num_users = int(full["user"].max()) + 1
    num_items = int(full["item"].max()) + 1
    data = {k: v[rank::nprocs] for k, v in full.items()}
    frac = getattr(args, "eval_frac", None)
    frac = 0.1 if frac is None else frac
    data, holdout = holdout_split(data, frac, seed=cfg.train.seed)

    updater = cfg.table.updater  # sgd/adagrad/adam all server-side
    dim = cfg.table.dim
    push_comm = getattr(args, "push_comm", "float32")
    mk = lambda name, rows, seed: ShardedTable(  # noqa: E731
        name, rows, dim, bus, rank, nprocs, updater=updater,
        lr=cfg.table.lr, init_scale=0.1, seed=seed, monitor=monitor,
        pull_timeout=30.0, push_comm=push_comm)
    user_t = mk("user", num_users, 1)
    item_t = mk("item", num_items, 2)
    trainer = ShardedPSTrainer({"user": user_t, "item": item_t}, bus,
                               nprocs, staleness=staleness,
                               gate_timeout=30.0, monitor=monitor)
    resume = shard_checkpointing(bus, nprocs, cfg.train.checkpoint_dir,
                                 rank)
    bus.handshake(nprocs)
    start_iter, save_hook = resume(
        {"user": user_t, "item": item_t, "trainer": trainer},
        cfg.train.checkpoint_every)

    B = cfg.train.batch_size
    rng = np.random.default_rng((rank, start_iter))
    losses = []
    rmse = None
    fp = 0.0
    t0 = time.monotonic()

    def body():
        nonlocal rmse, fp
        for i in range(start_iter, cfg.train.num_iters):
            if getattr(args, "kill_at", 0) \
                    and rank == getattr(args, "kill_rank", -1) \
                    and i == args.kill_at:
                os._exit(137)
            sel = rng.integers(0, data["rating"].shape[0], size=B)
            u_keys, i_keys = data["user"][sel], data["item"][sel]
            u_rows = torch.from_numpy(user_t.pull(u_keys)).to(dev)
            i_rows = torch.from_numpy(item_t.pull(i_keys)).to(dev)
            loss, gu, gi = mf_model.grad_fn(
                u_rows, i_rows,
                {"rating": torch.from_numpy(data["rating"][sel]).to(dev)},
                mu=MU, reg=REG)
            # x B: per-sample server-add magnitude (the spmd path's
            # grad_scale)
            user_t.push(u_keys, gu.cpu().numpy() * float(B))
            item_t.push(i_keys, gi.cpu().numpy() * float(B))
            losses.append(float(loss))
            trainer.tick()
            save_hook(i)
            if rank == getattr(args, "slow_rank", -1) \
                    and getattr(args, "slow_ms", 0) > 0:
                time.sleep(args.slow_ms / 1000.0)
        trainer.finalize(timeout=30.0)
        rmse = _score_holdout_rmse({}, holdout, user_t, item_t,
                                   metrics).get("rmse")
        fp = (float(np.sum(user_t.pull_all()))
              + float(np.sum(item_t.pull_all())))
        trainer.shutdown_barrier(timeout=10.0)

    code = run_multiproc_body(rank, trainer, body)
    if code == 0:
        table_bytes = table_state_bytes(num_users + num_items, dim, updater)
        metrics.log(final_loss=losses[-1] if losses else None)
        emit_multiproc_done(
            trainer, rank, t0, losses, table_bytes, fp,
            push_comm=push_comm, rmse=rmse, resumed_from=start_iter,
            device=str(dev))
    monitor.stop()
    bus.close()
    if code:
        sys.exit(code)
    return {"losses": losses, "rmse": rmse}


def _flags(parser):
    parser.add_argument("--data_file", default=None,
                        help="MovieLens ratings file (ratings.csv, "
                             "ratings.dat, or u.data) instead of synthetic")
    parser.add_argument("--eval_frac", type=float, default=None,
                        help="fraction of ratings held out and scored by "
                             "RMSE after training; 0 disables (default: 0 "
                             "for spmd/threaded, 0.1 for multiproc)")
    from minips_tpu_torch.apps.common import add_push_comm_flag

    add_push_comm_flag(parser)
    # multiproc straggler/fault injection (smoke tests)
    parser.add_argument("--slow-rank", dest="slow_rank", type=int,
                        default=-1)
    parser.add_argument("--slow-ms", dest="slow_ms", type=float,
                        default=0.0)
    parser.add_argument("--kill-at", dest="kill_at", type=int, default=0)
    parser.add_argument("--kill-rank", dest="kill_rank", type=int,
                        default=-1)


def main():
    return app_main("mf_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
