"""mlp_example — a 3-layer MLP on MNIST-shaped data, the port of
``minips_tpu/apps/mlp_example.py`` (BASELINE.json:8: "3-layer MLP on
MNIST, dense KVTable, SSP staleness=4").

The default is the reference's SSP with staleness 4. One fused step over
the whole batch (``--exec spmd``) has no clock gap to bound, so it runs
bulk-synchronously; ``--exec threaded`` runs true SSP with worker threads
sharing the card. The tower multiplies in bf16 with float32 weights, as
``models/mlp.py`` does. ``run(cfg, args, metrics, group)`` runs one rank
of a process group (the CLI's ``--ranks N``), the table range-sharded
over the ranks, each rank stepping on its rows of every batch (spmd) or
serving rank 0's workers (threaded).

Usage: python -m minips_tpu_torch.apps.mlp_example --num_iters 300
"""

from __future__ import annotations

import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          loop_profile, threaded_train,
                                          to_device)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.core.engine import Engine
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import mlp as mlp_model
from minips_tpu_torch.parallel.mesh import Group, resolve_device, shard_batch
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.utils.tree import tree_map

DEFAULT = Config(
    table=TableConfig(name="mlp", kind="dense", consistency="ssp",
                      staleness=4, updater="adagrad", lr=0.05),
    train=TrainConfig(batch_size=256, num_iters=300),
)
SIZES = (784, 256, 128, 10)
ACCURACY_ROWS = 2048


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run (``group``: the run's process group,
    ``None`` for one device); every rank calls it with the same ``cfg``
    and ``args``."""
    device = resolve_device(getattr(args, "device", None))
    images = getattr(args, "images", None)
    labels = getattr(args, "labels", None)
    if images:  # real MNIST idx files
        if not labels:
            raise SystemExit("--labels is required with --images")
        from minips_tpu_torch.data.mnist import read_mnist
        data = read_mnist(images, labels)
    else:
        if labels:
            raise SystemExit("--labels without --images would silently "
                             "train on synthetic data; pass both")
        data = synthetic.mnist_like(8192, seed=cfg.train.seed)
    # the JAX package draws from PRNGKey(seed), which torch cannot replay
    template = mlp_model.init(torch.Generator().manual_seed(cfg.train.seed),
                              SIZES, device=device)
    held = to_device({k: v[:ACCURACY_ROWS] for k, v in data.items()},
                     device)

    if getattr(args, "exec_mode", "spmd") == "threaded":
        return _run_threaded(cfg, metrics, data, template, held, group)

    batches = BatchIterator(data, global_batch(cfg.train.batch_size, group),
                            seed=cfg.train.seed)
    table = DenseTable(template, updater=cfg.table.updater, lr=cfg.table.lr,
                       device=device, group=group)
    step = table.make_step(mlp_model.grad_fn)
    loop = TrainLoop(lambda b: table.step_inplace(
                         step, shard_batch(b, group, device)),
                     batches, metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size,
                     **loop_profile(args))
    losses = loop.run(cfg.train.num_iters)
    with torch.no_grad():
        acc = float(mlp_model.accuracy(table.pull(), held))
    metrics.log(final_loss=losses[-1], accuracy=acc)
    return {"losses": losses, "accuracy": acc,
            "samples_per_sec": loop.timer.samples_per_sec, "table": table}


def _run_threaded(cfg, metrics, data, template, held, group) -> dict:
    device = held["x"].device
    engine = Engine(num_workers=cfg.train.num_workers, device=device,
                    group=group).start_everything()
    engine.create_table(
        TableConfig(name="mlp", kind="dense",
                    consistency=cfg.table.consistency,
                    staleness=cfg.table.staleness,
                    updater=cfg.table.updater, lr=cfg.table.lr),
        template=template)

    def step_fn(info, batch):
        tbl = info.table("mlp")
        loss, grads = mlp_model.grad_fn(tbl.pull(), to_device(batch, device))
        tbl.push(tree_map(lambda x: x / info.num_workers, grads))
        return loss

    mean_losses, samples_per_sec = threaded_train(
        engine, cfg, data, step_fn, clock_tables=["mlp"])
    skew = engine.controllers["mlp"].skew
    final_params = engine.tables["mlp"].pull()
    engine.stop_everything()
    with torch.no_grad():
        acc = float(mlp_model.accuracy(final_params, held))
    metrics.log(final_loss=mean_losses[-1], accuracy=acc, clock_skew=skew,
                samples_per_sec=samples_per_sec)
    return {"losses": mean_losses, "accuracy": acc, "skew": skew,
            "samples_per_sec": samples_per_sec}


def _flags(parser):
    parser.add_argument("--images", default=None,
                        help="MNIST images idx3 file (e.g. "
                             "train-images-idx3-ubyte[.gz]); synthetic "
                             "data when omitted")
    parser.add_argument("--labels", default=None,
                        help="MNIST labels idx1 file (required with "
                             "--images)")


def main():
    return app_main("mlp_example", DEFAULT, run, extra_flags=_flags)


if __name__ == "__main__":
    main()
