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
``--exec multiproc`` (ROADMAP.md queue 1 items 14-15) is not ported yet
and raises.

Usage: python -m minips_tpu_torch.apps.mf_example --num_iters 300
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          holdout_split, threaded_train)
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
        raise SystemExit("--exec multiproc is not ported yet (ROADMAP.md "
                         "queue 1 items 14-15: the sharded PS)")
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
                     batch_size=cfg.train.batch_size)
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
            pred = mf_model.predict(user_t.pull(batch["user"]),
                                    item_t.pull(batch["item"]),
                                    mu=MU).cpu().numpy()
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


def _flags(parser):
    parser.add_argument("--data_file", default=None,
                        help="MovieLens ratings file (ratings.csv, "
                             "ratings.dat, or u.data) instead of synthetic")
    parser.add_argument("--eval_frac", type=float, default=None,
                        help="fraction of ratings held out and scored by "
                             "RMSE after training; 0 disables (the "
                             "default)")


def main():
    return app_main("mf_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
