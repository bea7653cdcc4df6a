"""wide_deep_example — Wide&Deep / DeepFM CTR on Criteo-shaped data, the
port of ``minips_tpu/apps/wide_deep_example.py``: hashed wide weights
(dim 1) and hashed field embeddings in two ``SparseTable``s, whose pulls
go through the row-gather kernel, and a dense deep tower.

Two modes:

- ``--exec spmd``: ``build`` gives a ``PSTrainStep`` over the three
  tables, which ``TrainLoop`` drives one fused step per batch;
- ``--exec threaded``: ``--num_workers`` threads under the ``Engine``,
  each pulling the batch's rows of both hashed tables and the deep tower
  through the BSP/SSP/ASP gate, pushing its gradients (scaled by 1/NW)
  and clocking.

``--data_file`` reads a Criteo TSV file (``data/criteo.py``) in place of
the synthetic rows; with ``--stream`` (spmd only) a producer thread parses
it in chunks while training runs, and the file is never resident.
``--eval_frac`` holds rows out and scores them by streaming ROC-AUC.
``--exec multiproc`` (ROADMAP.md queue 1 item 15) is not ported yet and
raises.

``run(cfg, args, metrics, group)`` runs one rank of a process group (the
CLI's ``--ranks N``): both hashed tables and the deep tower are
range-sharded over the ranks. In spmd mode every rank draws the same
global batch and steps on its rows of it (the batch must divide by the
group size); in threaded mode rank 0 runs the workers and the other ranks
serve their table shards (``core/engine.py``). Every rank scores the
holdout (the pulls are collectives); rank 0 logs it.

Usage: python -m minips_tpu_torch.apps.wide_deep_example --model deepfm \\
    --exec threaded --consistency ssp --staleness 2
       python -m minips_tpu_torch.apps.wide_deep_example --device cpu \\
    --ranks 2 --exec threaded
"""

from __future__ import annotations

import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          holdout_split, score_holdout)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.criteo import (log_transform, read_criteo,
                                          stream_criteo_batches)
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import wide_deep as wd_model
from minips_tpu_torch.parallel.mesh import DeviceLike, Group, resolve_device
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable, collision_stats
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.train.ps_step import PSTrainStep
from minips_tpu_torch.utils.tree import tree_leaves, tree_map, tree_rebuild

DEFAULT = Config(
    table=TableConfig(name="ctr", kind="sparse", consistency="bsp",
                      updater="adagrad", lr=0.05, dim=8,
                      num_slots=1 << 18),
    train=TrainConfig(batch_size=1024, num_iters=200),
)
NUM_DENSE, NUM_CAT = 13, 26


def build(cfg: Config, *, use_fm: bool, seed: int = 0,
          compute_dtype=None, device: DeviceLike = None, group: Group = None):
    """Tables and the fused step for W&D/DeepFM: ``(ps, (wide, emb,
    deep))``, every table sharded over ``group``. The deep tower's weights
    come from a ``torch.Generator`` seeded with ``seed + 2`` (the JAX
    package's ``PRNGKey(seed + 2)`` cannot be replayed; parity tests carry
    its weights across)."""
    device = resolve_device(device)
    emb_dim = cfg.table.dim
    wide_t = SparseTable(cfg.table.num_slots, 1, name="wide",
                         updater=cfg.table.updater, lr=cfg.table.lr,
                         init_scale=0.0, salt=1, seed=seed, device=device,
                         group=group)
    emb_t = SparseTable(cfg.table.num_slots, emb_dim, name="emb",
                        updater=cfg.table.updater, lr=cfg.table.lr,
                        init_scale=0.01, salt=2, seed=seed + 1, device=device,
                        group=group)
    gen = torch.Generator().manual_seed(seed + 2)
    deep_t = DenseTable(
        wd_model.init_deep(gen, NUM_CAT, emb_dim, NUM_DENSE, device=device),
        name="deep", updater="adam", lr=1e-3, device=device, group=group)

    def loss_fn(deep_params, rows, batch):
        return wd_model.loss(rows["wide"], rows["emb"], deep_params, batch,
                             use_fm=use_fm)

    ps = PSTrainStep(loss_fn, dense=deep_t,
                     sparse={"wide": wide_t, "emb": emb_t},
                     key_fns={"wide": lambda b: b["cat"],
                              "emb": lambda b: b["cat"]},
                     compute_dtype=compute_dtype, device=device, group=group)
    return ps, (wide_t, emb_t, deep_t)


def _make_predict(wide_t, emb_t, deep_params, use_fm: bool):
    """Holdout scorer over the live tables and a pulled deep snapshot,
    shared by the spmd and threaded paths."""
    device = wide_t.device

    @torch.no_grad()
    def predict(b):
        cats = torch.as_tensor(b["cat"], device=device)
        return wd_model.logits(
            wide_t.pull(cats), emb_t.pull(cats), deep_params,
            {"dense": torch.as_tensor(b["dense"], device=device)},
            use_fm=use_fm)
    return predict


def _log_collisions(metrics, cats, num_slots) -> dict:
    """Measured key->slot collision rate of the hashed tables over this
    run's key stream (sampled). Both tables hash the same cat keys under
    their own salt."""
    out = {}
    for name, salt in (("wide", 1), ("emb", 2)):
        st = collision_stats(cats, num_slots, salt=salt)
        out[name] = st
        metrics.log(table=name, **{f"collision_{k}": v
                                   for k, v in st.items()})
    return out


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run (``group``: the run's process group,
    ``None`` for one device); every rank calls it with the same ``cfg``
    and ``args``."""
    use_fm = getattr(args, "model", "widedeep") == "deepfm"
    mode = getattr(args, "exec_mode", "spmd")
    stream = getattr(args, "stream", False)
    if stream and mode != "spmd":
        raise SystemExit("--stream is only wired into --exec spmd")
    if mode == "multiproc":
        raise SystemExit("--exec multiproc is not ported yet (ROADMAP.md "
                         "queue 1 item 15: the sharded PS)")
    path = getattr(args, "data_file", None)
    if stream and not path:
        raise SystemExit("--stream needs --data_file (a file to stream)")
    device = resolve_device(getattr(args, "device", None))
    if stream:
        return _run_streaming(cfg, args, metrics, path, use_fm=use_fm,
                              device=device, group=group)
    if path:  # real Criteo TSV through the native or Python reader
        raw = read_criteo(path)
        data = {"dense": log_transform(raw["dense"], raw["dense_mask"]),
                "cat": raw["cat"], "y": raw["y"]}
    else:
        data = synthetic.criteo_like(16384, seed=cfg.train.seed)
    data, holdout = holdout_split(data,
                                  getattr(args, "eval_frac", None) or 0.0,
                                  seed=cfg.train.seed)
    if mode == "threaded":
        return _run_threaded(cfg, args, metrics, data, holdout,
                             use_fm=use_fm, device=device, group=group)
    ps, tables = build(cfg, use_fm=use_fm, seed=cfg.train.seed,
                       compute_dtype=_compute_dtype(args), device=device,
                       group=group)
    _log_collisions(metrics, data["cat"], cfg.table.num_slots)
    batches = BatchIterator(data, global_batch(cfg.train.batch_size, group),
                            seed=cfg.train.seed)
    loop = TrainLoop(lambda b: ps(ps.shard_batch(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size)
    losses = loop.run(cfg.train.num_iters)
    metrics.log(final_loss=losses[-1],
                samples_per_sec=loop.timer.samples_per_sec)
    wide_t, emb_t, deep_t = tables
    return score_holdout(
        _make_predict(wide_t, emb_t, deep_t.pull(), use_fm), holdout,
        {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
         "tables": tables}, metrics)


def _compute_dtype(args):
    return (torch.bfloat16 if getattr(args, "dtype", "float32") == "bfloat16"
            else None)


def _run_streaming(cfg: Config, args, metrics, path: str, *, use_fm: bool,
                   device: torch.device, group: Group) -> dict:
    """One-pass streaming training: a producer thread parses the Criteo
    file in chunks while earlier batches train, and the file is never
    resident (``stream_criteo_batches``). The loop ends at min(num_iters,
    the end of the file). A holdout needs resident rows, so ``--eval_frac``
    is refused here."""
    if getattr(args, "eval_frac", None):
        raise SystemExit("--eval_frac needs resident rows; it is not "
                         "available with --stream (run a separate "
                         "non-stream eval pass)")
    ps, tables = build(cfg, use_fm=use_fm, seed=cfg.train.seed,
                       compute_dtype=_compute_dtype(args), device=device,
                       group=group)

    def xform(d):  # on the producer thread
        return {"dense": log_transform(d["dense"], d["dense_mask"]),
                "cat": d["cat"], "y": d["y"]}

    stream_stats: dict = {}
    batches = stream_criteo_batches(path,
                                    global_batch(cfg.train.batch_size, group),
                                    transform=xform, stats=stream_stats)
    loop = TrainLoop(lambda b: ps(ps.shard_batch(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size)
    losses = loop.run(cfg.train.num_iters)
    metrics.log(final_loss=losses[-1] if losses else None,
                samples_per_sec=loop.timer.samples_per_sec,
                # rows short of one final batch (absent when num_iters
                # ended the loop before the end of the file)
                stream_dropped_rows=stream_stats.get("dropped_rows"),
                streamed=True)
    return {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
            "tables": tables}


def _run_threaded(cfg: Config, args, metrics, data, holdout, *,
                  use_fm: bool, device: torch.device, group: Group) -> dict:
    """Reference-semantics worker threads: each pulls the batch's rows of
    both hashed tables (two row gathers) and the deep tower through the
    consistency gate, takes the gradients by autograd, pushes them and
    clocks. ``samples_per_sec`` is measured as on the spmd path (the JAX
    package reports 0.0 here): see ``threaded_train``. Under a group the
    workers run on rank 0; each pull gathers on every owner's shard."""
    from minips_tpu_torch.apps.common import threaded_train
    from minips_tpu_torch.consistency import make_controller
    from minips_tpu_torch.core.engine import Engine

    if getattr(args, "dtype", "float32") != "float32":
        raise SystemExit("--dtype is only wired into --exec spmd")
    _, (wide_t, emb_t, deep_t) = build(cfg, use_fm=use_fm,
                                       seed=cfg.train.seed, device=device,
                                       group=group)
    engine = Engine(num_workers=cfg.train.num_workers, device=device,
                    group=group).start_everything()
    for name, t in (("wide", wide_t), ("emb", emb_t), ("deep", deep_t)):
        engine.register_table(name, t, make_controller(
            cfg.table.consistency, engine.num_workers,
            staleness=cfg.table.staleness, sync_every=0))

    def grads(wide_rows, emb_rows, deep_params, batch):
        leaves = [x.detach().requires_grad_()
                  for x in [wide_rows, emb_rows] + tree_leaves(deep_params)]
        w, e, *dl = leaves
        loss = wd_model.loss(w, e, tree_rebuild(deep_params, iter(dl)), batch,
                             use_fm=use_fm)
        gw, ge, *gd = torch.autograd.grad(loss, leaves)
        return loss.detach(), gw, ge, tree_rebuild(deep_params, iter(gd))

    NW = engine.num_workers

    def step_fn(info, batch):
        wt, et, dt = (info.table(n) for n in ("wide", "emb", "deep"))
        cats = torch.as_tensor(batch["cat"], device=device)
        w_rows = wt.pull(keys=cats)  # [B, NUM_CAT, 1]
        e_rows = et.pull(keys=cats)  # [B, NUM_CAT, dim]
        deep_params = dt.pull()
        loss, gw, ge, gd = grads(
            w_rows, e_rows, deep_params,
            {"dense": torch.as_tensor(batch["dense"], device=device),
             "y": torch.as_tensor(batch["y"], device=device)})
        # NW workers each push once per clock; /NW keeps the per-round
        # update magnitude equal to the spmd path's single mean-loss push
        # for every updater (adagrad normalizes constants away, sgd does
        # not: unscaled pushes would be an NW-times effective lr)
        wt.push(gw / NW, keys=cats)
        et.push(ge / NW, keys=cats)
        dt.push(tree_map(lambda x: x / NW, gd))
        return loss

    mean_losses, samples_per_sec = threaded_train(
        engine, cfg, data, step_fn, clock_tables=["wide", "emb", "deep"])
    deep_params = deep_t.pull()
    engine.stop_everything()
    metrics.log(final_loss=mean_losses[-1], samples_per_sec=samples_per_sec)
    return score_holdout(
        _make_predict(wide_t, emb_t, deep_params, use_fm), holdout,
        {"losses": mean_losses, "samples_per_sec": samples_per_sec,
         "tables": (wide_t, emb_t, deep_t)}, metrics)


def _flags(parser):
    parser.add_argument("--model", default="widedeep",
                        choices=["widedeep", "deepfm"])
    parser.add_argument("--data_file", default=None,
                        help="Criteo TSV file instead of synthetic data")
    parser.add_argument("--stream", action="store_true",
                        help="one-pass streaming read of --data_file: a "
                             "producer thread parses chunks while training "
                             "runs; the file is never resident. Ends at "
                             "min(num_iters, EOF)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="worker-math precision under --exec spmd "
                             "(master tables stay float32)")
    parser.add_argument("--eval_frac", type=float, default=None,
                        help="fraction of rows held out and scored by "
                             "streaming ROC-AUC after training; 0 disables")


def main():
    return app_main("wide_deep_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
