"""lr_example — logistic regression, the port of
``minips_tpu/apps/lr_example.py`` (BASELINE.json:3,7: LR on a9a/RCV1,
sparse push/pull, BSP).

Modes:

- ``--data dense`` (a9a-like): a DenseTable's fused step; with
  ``--checkpoint_dir`` it saves every ``--checkpoint_every`` steps and a
  restart resumes from the newest checkpoint;
- ``--data sparse`` (RCV1-like): a hashed SparseTable of per-feature
  weights (2^16 slots, D = 1) under ``PSTrainStep``, whose pull is the
  row-gather kernel on the card;
- ``--exec threaded`` (dense): worker threads under the configured
  consistency model (BSP/SSP/ASP).

``--data_file`` reads a libsvm file in place of the synthetic rows;
``--eval_frac`` holds rows out and scores them by streaming ROC-AUC.

``run(cfg, args, metrics, group)`` runs one rank of a process group (the
CLI's ``--ranks N``), the table range-sharded over the ranks: in spmd mode
each rank steps on its rows of every global batch, in threaded mode rank
0 runs the workers and the other ranks serve (``core/engine.py``). A
checkpoint under a group is written by rank 0 and restored by every rank.

Usage: python -m minips_tpu_torch.apps.lr_example --num_iters 200 --lr 0.5
"""

from __future__ import annotations

import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          holdout_split, score_holdout,
                                          threaded_train, to_device)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.core.engine import Engine
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import lr as lr_model
from minips_tpu_torch.parallel.mesh import Group, resolve_device, shard_batch
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.train.ps_step import PSTrainStep
from minips_tpu_torch.utils.tree import tree_map

DEFAULT = Config(
    table=TableConfig(name="weights", kind="dense", consistency="bsp",
                      updater="adagrad", lr=0.5),
    train=TrainConfig(batch_size=512, num_iters=200),
)
SPARSE_SLOTS = 1 << 16


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run (``group``: the run's process group,
    ``None`` for one device); every rank calls it with the same ``cfg``
    and ``args``."""
    device = resolve_device(getattr(args, "device", None))
    dim = getattr(args, "dim", 123)
    path = getattr(args, "data_file", None)
    if getattr(args, "data", "dense") == "dense":
        if path:  # an a9a-style libsvm file, dense-ified
            from minips_tpu_torch.data.libsvm import (densify, read_libsvm,
                                                      shift_one_based)
            data = densify(shift_one_based(read_libsvm(path)), dim)
        else:
            data = synthetic.classification_dense(8192, dim,
                                                  seed=cfg.train.seed)
        return _run_dense(cfg, args, metrics, data, dim, device, group)
    if path:  # an RCV1-style libsvm file, hashed sparse weights
        from minips_tpu_torch.data.libsvm import read_libsvm
        data = read_libsvm(path)
    else:
        data = synthetic.classification_sparse(8192, seed=cfg.train.seed)
    return _run_sparse(cfg, args, metrics, data, device, group)


def _run_dense(cfg, args, metrics, data, dim, device, group) -> dict:
    data, holdout = holdout_split(data, getattr(args, "eval_frac", 0.0),
                                  seed=cfg.train.seed)
    if getattr(args, "exec_mode", "spmd") == "threaded":
        return _run_threaded(cfg, metrics, data, dim, holdout, device, group)
    batches = BatchIterator(data, global_batch(cfg.train.batch_size, group),
                            seed=cfg.train.seed)
    table = DenseTable(lr_model.init(dim, device=device),
                       updater=cfg.table.updater, lr=cfg.table.lr,
                       device=device, group=group)
    step = table.make_step(lr_model.grad_fn_dense)

    ck, start_step = None, 0
    if cfg.train.checkpoint_dir:
        from minips_tpu_torch.ckpt import make_checkpointer
        ck = make_checkpointer(cfg.train.checkpoint_dir, {"weights": table},
                               group=group)
        if ck.list_steps():  # resume from the newest checkpoint
            start_step = ck.restore()
            metrics.log(resumed_from_step=start_step)
            if holdout is not None:
                # the split is deterministic in (--seed, --eval_frac): a
                # resumed run holds out the same rows only if both match
                metrics.log(warning="holdout AUC after resume is only valid "
                                    "if --eval_frac/--seed match the "
                                    "checkpointing run")
    loop = TrainLoop(lambda b: table.step_inplace(
                         step, shard_batch(b, group, device)),
                     batches, metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size, checkpointer=ck,
                     checkpoint_every=cfg.train.checkpoint_every,
                     step_offset=start_step)
    losses = loop.run(max(cfg.train.num_iters - start_step, 0))
    params = table.pull()
    return score_holdout(
        lambda b: lr_model.logits_dense(params, to_device(b, device)["x"]),
        holdout,
        {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
         "table": table}, metrics)


def _run_sparse(cfg, args, metrics, data, device, group) -> dict:
    data, holdout = holdout_split(data, getattr(args, "eval_frac", 0.0),
                                  seed=cfg.train.seed)
    table = SparseTable(SPARSE_SLOTS, 1, updater=cfg.table.updater,
                        lr=cfg.table.lr, init_scale=0.0, device=device,
                        group=group)

    def loss_fn(dense_params, rows, batch):
        return lr_model.loss_sparse(rows["w"], batch)

    ps = PSTrainStep(loss_fn, sparse={"w": table},
                     key_fns={"w": lambda b: b["idx"]}, device=device,
                     group=group)
    batches = BatchIterator(data, global_batch(cfg.train.batch_size, group),
                            seed=cfg.train.seed)
    loop = TrainLoop(lambda b: ps(ps.shard_batch(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size)
    losses = loop.run(cfg.train.num_iters)

    @torch.no_grad()
    def predict(b):
        b = to_device(b, device)
        return lr_model.logits_sparse(table.pull(b["idx"]), b["val"],
                                      b["mask"])

    return score_holdout(
        predict, holdout,
        {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
         "table": table}, metrics)


def _run_threaded(cfg, metrics, data, dim, holdout, device, group) -> dict:
    engine = Engine(num_workers=cfg.train.num_workers, device=device,
                    group=group).start_everything()
    engine.create_table(
        TableConfig(name="w", kind="dense", consistency=cfg.table.consistency,
                    staleness=cfg.table.staleness, updater=cfg.table.updater,
                    lr=cfg.table.lr),
        template=lr_model.init(dim, device=device))

    def step_fn(info, batch):
        tbl = info.table("w")
        loss, grads = lr_model.grad_fn_dense(tbl.pull(),
                                             to_device(batch, device))
        tbl.push(tree_map(lambda x: x / info.num_workers, grads))
        return loss

    mean_losses, samples_per_sec = threaded_train(engine, cfg, data, step_fn,
                                                  clock_tables=["w"])
    skew = engine.controllers["w"].skew
    params = engine.tables["w"].pull()
    engine.stop_everything()
    metrics.log(final_loss=mean_losses[-1], clock_skew=skew,
                samples_per_sec=samples_per_sec)
    return score_holdout(
        lambda b: lr_model.logits_dense(params, to_device(b, device)["x"]),
        holdout, {"losses": mean_losses, "samples_per_sec": samples_per_sec,
                  "skew": skew}, metrics)


def _flags(parser):
    parser.add_argument("--data", default="dense",
                        choices=["dense", "sparse"])
    parser.add_argument("--dim", type=int, default=123)
    parser.add_argument("--data_file", default=None,
                        help="libsvm file (a9a/RCV1) instead of synthetic")
    parser.add_argument("--eval_frac", type=float, default=0.0,
                        help="opt-in: fraction of rows held out and scored "
                             "by streaming ROC-AUC after training")


def main():
    return app_main("lr_example", DEFAULT, run, extra_flags=_flags)


if __name__ == "__main__":
    main()
