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

``--exec multiproc`` runs one launcher rank (``launch.py``) of the
key-range-sharded PS (``train/sharded_ps.py``): the wide, emb and deep
tables partitioned over the processes, the servers numpy on the host, and
this rank's model step by autograd on its device (``multiproc_device``:
``cuda:{MINIPS_LOCAL_RANK mod device_count}``, the CPU under
``MINIPS_FORCE_CPU`` or ``--device cpu``). It prints the launcher
protocol's done line.

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
       MINIPS_FORCE_CPU=1 python -m minips_tpu_torch.launch --n 2 -- \\
    python -m minips_tpu_torch.apps.wide_deep_example --exec multiproc
"""

from __future__ import annotations

import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          holdout_split, loop_profile,
                                          score_holdout)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.criteo import (log_transform, read_criteo,
                                          stream_criteo_batches)
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import wide_deep as wd_model
from minips_tpu_torch.parallel.mesh import DeviceLike, Group, resolve_device
from minips_tpu_torch.tables.dense import DenseTable, ravel
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
        return _run_multiproc(cfg, args, metrics, use_fm=use_fm)
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
                     batch_size=cfg.train.batch_size,
                     **loop_profile(args))
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
                     batch_size=cfg.train.batch_size,
                     **loop_profile(args))
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


def _run_multiproc(cfg: Config, args, metrics, *, use_fm: bool) -> dict:
    """The flagship sparse workload on the key-range-sharded PS: N
    launcher processes, each with its own Criteo data shard; wide/emb
    tables partitioned across processes (per-process memory ~1/N), pushes
    ship only the batch's touched rows per owner; the deep tower rides the
    dense range path; BSP/SSP/ASP via the owner-side staleness gate.
    Prints the one-JSON-line launcher protocol."""
    import os
    import sys
    import time

    import numpy as np

    from minips_tpu_torch.apps.common import (emit_multiproc_done,
                                              init_multiproc,
                                              multiproc_device,
                                              run_multiproc_body,
                                              shard_checkpointing)
    from minips_tpu_torch.tables.sparse import hash_to_slots_np
    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                                   ShardedTable,
                                                   table_state_bytes)
    from minips_tpu_torch.utils.evaluation import StreamingAUC, padded_chunks

    # the device first: a card's first context must not stall the
    # heartbeats that init_multiproc starts
    dev = multiproc_device(getattr(args, "device", None))
    rank, nprocs, bus, monitor, staleness = init_multiproc(
        cfg.table.consistency, cfg.table.staleness)

    path = getattr(args, "data_file", None)
    if path:  # real Criteo TSV; round-robin row shard per rank
        raw = read_criteo(path)
        data = {"dense": log_transform(raw["dense"], raw["dense_mask"]),
                "cat": raw["cat"], "y": raw["y"]}
        data = {k: v[rank::nprocs] for k, v in data.items()}
    else:  # per-rank synthetic shard (disjoint seeds, shared signal)
        data = synthetic.criteo_like(8192, seed=100 + rank)
    # explicit --eval_frac 0 disables eval; only an UNSET flag takes the
    # multiproc default of 0.2
    frac = getattr(args, "eval_frac", None)
    frac = 0.2 if frac is None else frac
    data, holdout = holdout_split(data, frac, seed=cfg.train.seed)

    slots = cfg.table.num_slots
    emb_dim = cfg.table.dim
    coll = _log_collisions(metrics, data["cat"], slots)
    updater = cfg.table.updater  # sgd/adagrad/adam all server-side
    push_comm = getattr(args, "push_comm", "float32")

    def mk(name, dim, scale, seed, comm="float32"):
        return ShardedTable(name, slots, dim, bus, rank, nprocs,
                            updater=updater, lr=cfg.table.lr,
                            init_scale=scale, seed=seed, monitor=monitor,
                            pull_timeout=30.0, push_comm=comm)
    # --push-comm compresses only the wide-DIMENSION table (emb): at dim
    # 1 (wide) the per-row f32 scale outweighs the int8 saving
    wide_t = mk("wide", 1, 0.0, 1)
    emb_t = mk("emb", emb_dim, 0.01, 2, comm=push_comm)
    # deep tower: a flat parameter vector on the dense range path (adagrad
    # server-side), in ravel_pytree's layout. Every rank, on the card or
    # the CPU, draws the same initial vector from a CPU generator seeded
    # with seed + 2 (the JAX package's PRNGKey(seed + 2) draws other
    # numbers; tests carry its weights across); the table stores the
    # DELTA from it, so the zero table needs no init broadcast and range
    # pushes stay pure gradients
    deep0 = wd_model.init_deep(torch.Generator().manual_seed(
        cfg.train.seed + 2), NUM_CAT, emb_dim, NUM_DENSE, device="cpu")
    deep_flat0, unravel = ravel(deep0)
    n_deep = deep_flat0.shape[0]
    deep_flat0 = deep_flat0.to(dev)
    deep_t = ShardedTable("deep", n_deep, 1, bus, rank, nprocs,
                          updater="adagrad", lr=0.02, monitor=monitor,
                          pull_timeout=30.0)
    trainer = ShardedPSTrainer(
        {"wide": wide_t, "emb": emb_t, "deep": deep_t}, bus, nprocs,
        staleness=staleness, gate_timeout=30.0, monitor=monitor)
    resume = shard_checkpointing(bus, nprocs, cfg.train.checkpoint_dir,
                                 rank)
    bus.handshake(nprocs)
    start_iter, save_hook = resume(
        {"wide": wide_t, "emb": emb_t, "deep": deep_t, "trainer": trainer},
        cfg.train.checkpoint_every)

    def on_dev(x):
        return torch.from_numpy(x).to(dev)

    def wd_grads(wide_rows, emb_rows, deep_vec, batch):
        leaves = [x.requires_grad_() for x in (wide_rows, emb_rows,
                                               deep_vec)]
        w, e, dv = leaves
        loss = wd_model.loss(w, e, unravel(dv[:, 0] + deep_flat0), batch,
                             use_fm=use_fm)
        return (loss.detach(),) + torch.autograd.grad(loss, leaves)

    B = cfg.train.batch_size
    # resumed runs reseed on (rank, start): sampling is with-replacement,
    # so resume is convergence-equivalent, not bit-exact
    rng = np.random.default_rng((rank, start_iter))
    losses = []
    auc_val = None
    fp = 0.0
    t0 = time.monotonic()

    def body():
        nonlocal auc_val, fp
        for i in range(start_iter, cfg.train.num_iters):
            kill_at = getattr(args, "kill_at", 0)
            if kill_at and rank == getattr(args, "kill_rank", -1) \
                    and i == kill_at:
                os._exit(137)
            sel = rng.integers(0, data["y"].shape[0], size=B)
            cats = data["cat"][sel]
            wide_keys = hash_to_slots_np(cats, slots, 1).reshape(-1)
            emb_keys = hash_to_slots_np(cats, slots, 2).reshape(-1)
            wide_rows = wide_t.pull(wide_keys).reshape(B, NUM_CAT, 1)
            emb_rows = emb_t.pull(emb_keys).reshape(B, NUM_CAT, emb_dim)
            deep_vec = deep_t.pull_all()
            loss, gw, ge, gd = wd_grads(
                on_dev(wide_rows), on_dev(emb_rows), on_dev(deep_vec),
                {"dense": on_dev(data["dense"][sel]),
                 "y": on_dev(data["y"][sel])})
            wide_t.push(wide_keys, gw.cpu().numpy().reshape(-1, 1))
            emb_t.push(emb_keys, ge.cpu().numpy().reshape(-1, emb_dim))
            deep_t.push_dense(gd.cpu().numpy())
            losses.append(float(loss))
            trainer.tick()
            save_hook(i)
            slow_rank = getattr(args, "slow_rank", -1)
            if rank == slow_rank and getattr(args, "slow_ms", 0) > 0:
                time.sleep(args.slow_ms / 1000.0)
        trainer.finalize(timeout=30.0)
        # ---- streaming holdout AUC on the FINAL shared tables
        if holdout is not None:
            auc = StreamingAUC()
            deep_final = unravel(on_dev(deep_t.pull_all())[:, 0]
                                 + deep_flat0)
            with torch.no_grad():
                for chunk, n_valid in padded_chunks(holdout, 4096):
                    cats = chunk["cat"]
                    cb = cats.shape[0]
                    w_rows = wide_t.pull(
                        hash_to_slots_np(cats, slots, 1).reshape(-1)
                    ).reshape(cb, NUM_CAT, 1)
                    e_rows = emb_t.pull(
                        hash_to_slots_np(cats, slots, 2).reshape(-1)
                    ).reshape(cb, NUM_CAT, emb_dim)
                    lg = wd_model.logits(
                        on_dev(w_rows), on_dev(e_rows), deep_final,
                        {"dense": on_dev(chunk["dense"])}, use_fm=use_fm)
                    auc.update(lg.cpu().numpy()[:n_valid],
                               chunk["y"][:n_valid])
            auc_val = auc.result()
        # fingerprints for the replica-agreement assertion
        fp = (float(np.sum(wide_t.pull_all()))
              + float(np.sum(emb_t.pull_all()))
              + float(np.sum(deep_t.pull_all())))
        trainer.shutdown_barrier(timeout=10.0)

    code = run_multiproc_body(rank, trainer, body)
    if code == 0:
        # deep table is always adagrad server-side (shard + accumulator)
        table_bytes = (table_state_bytes(slots, 1, updater)        # wide
                       + table_state_bytes(slots, emb_dim, updater)  # emb
                       + table_state_bytes(n_deep, 1, "adagrad"))  # deep
        # metrics BEFORE the protocol line: the launcher harvests the LAST
        # JSON line on stdout as the result dict
        metrics.log(final_loss=losses[-1] if losses else None,
                    holdout_auc=auc_val)
        emit_multiproc_done(
            trainer, rank, t0, losses, table_bytes, fp,
            auc=auc_val, resumed_from=start_iter,
            push_comm=push_comm, device=str(dev),
            emb_collision_rate=coll["emb"]["collision_rate"],
            emb_unique_keys=coll["emb"]["unique_keys"],
            # embedding-table wire alone: the row-sparse claim is about
            # these (the deep tower is inherently dense-range traffic)
            sparse_bytes_pushed=wide_t.bytes_pushed + emb_t.bytes_pushed,
            emb_bytes_pushed=emb_t.bytes_pushed)
    monitor.stop()
    bus.close()
    if code:
        sys.exit(code)
    return {"losses": losses, "auc": auc_val}


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
                             "streaming ROC-AUC after training; 0 disables "
                             "(default: 0 for spmd/threaded, 0.2 for "
                             "multiproc)")
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
    return app_main("wide_deep_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
