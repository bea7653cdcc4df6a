"""word2vec_example — skip-gram with negative sampling on enwiki-shaped
text, the port of ``minips_tpu/apps/word2vec_example.py``
(BASELINE.json:11: "Word2Vec skip-gram on enwiki, negative sampling, async
push").

Input and output embeddings (D = 64) live in two hashed SparseTables.
Negatives are drawn on the host from unigram^0.75; a batch is B centers,
B positive contexts and [B, NEG] negatives, and the output table is pulled
once for the [B, 1 + NEG] keys of the positive and the negatives. Every
pull is the row-gather kernel on the card. Two modes:

- ``--exec spmd``: one ``PSTrainStep`` a batch, the gradients scaled by
  the batch size (per-pair SGD magnitude);
- ``--exec threaded``: ``--num_workers`` threads under the configured
  consistency model (ASP by default, the reference's "async push"), each
  with its own batch stream and sampler seeded ``seed + worker_id``.

``--data_file`` tokenizes a text file at word level; ``--subsample``
drops frequent words. ``run(cfg, args, metrics, group)`` runs one rank of
a process group (the CLI's ``--ranks N``), both tables range-sharded over
the ranks: in spmd mode every rank draws the same global batch and steps
on its rows of it, in threaded mode rank 0 runs the workers and the
other ranks serve (``core/engine.py``). ``--exec multiproc`` runs one
launcher rank (``launch.py``) of the key-range-sharded PS
(``train/sharded_ps.py``): the vocabulary's in and out rows partitioned
over the processes, the servers numpy on the host, this rank's step by
autograd on its device (``multiproc_device``).

Usage: python -m minips_tpu_torch.apps.word2vec_example --num_iters 200
       MINIPS_FORCE_CPU=1 python -m minips_tpu_torch.launch --n 2 -- \\
    python -m minips_tpu_torch.apps.word2vec_example --exec multiproc
"""

from __future__ import annotations

import time

import numpy as np
import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          loop_profile, mean_losses,
                                          run_rate, to_device)
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.models import word2vec as w2v
from minips_tpu_torch.parallel.mesh import Group, resolve_device
from minips_tpu_torch.tables.sparse import SparseTable
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.train.ps_step import PSTrainStep

DEFAULT = Config(
    table=TableConfig(name="emb", kind="sparse", consistency="asp",
                      updater="sgd", lr=0.05, dim=64, num_slots=1 << 14),
    train=TrainConfig(batch_size=1024, num_iters=200),
)
NEG = 5
VOCAB = 10_000


def make_tables(cfg: Config, device, group: Group = None):
    """The input (``in``) and output (``out``) embedding tables, sharded
    over ``group``."""
    mk = dict(updater=cfg.table.updater, lr=cfg.table.lr, device=device,
              group=group)
    return (SparseTable(cfg.table.num_slots, cfg.table.dim, name="in",
                        init_scale=0.01, seed=1, **mk),
            SparseTable(cfg.table.num_slots, cfg.table.dim, name="out",
                        init_scale=0.0, seed=2, **mk))


def pairs(cfg, args, vocab=VOCAB):
    """(centers, contexts, counts), tokenized, subsampled and paired once."""
    path = getattr(args, "data_file", None)
    if path:  # a real text corpus, word-level tokens
        from minips_tpu_torch.data.text import word_tokens
        tokens, counts = word_tokens(path, vocab_size=vocab)
    else:
        tokens, counts = synthetic.text_corpus(vocab, seed=cfg.train.seed)
    t = getattr(args, "subsample", 0.0)
    if t > 0:  # classic frequent-word subsampling (t=1e-5 at enwiki scale)
        tokens = w2v.subsample_frequent(tokens, counts, t=t,
                                        seed=cfg.train.seed)
    centers, contexts = synthetic.skipgram_pairs(tokens,
                                                 seed=cfg.train.seed)
    return centers, contexts, counts


def batch_gen(cfg, centers, contexts, counts, seed):
    """An endless batch stream with its own numpy generator and sampler,
    one per consumer: a generator shared between threads would make the
    draws depend on the threads' interleaving."""
    sampler = w2v.UnigramSampler(counts, seed=seed)
    rng = np.random.default_rng(seed)
    B = cfg.train.batch_size
    n = len(centers)
    while True:
        sel = rng.integers(0, n, size=B)
        yield {"center": centers[sel], "pos": contexts[sel],
               "neg": sampler.sample((B, NEG)).astype(np.int32)}


def out_keys(pos, neg):
    """The output table's [B, 1 + NEG] keys: the positive, then the
    negatives."""
    return torch.cat([pos[:, None], neg], dim=1)


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run (``group``: the run's process group,
    ``None`` for one device); every rank calls it with the same ``cfg``
    and ``args``."""
    mode = getattr(args, "exec_mode", "spmd")
    if mode == "multiproc":
        return _run_multiproc(cfg, args, metrics)
    device = resolve_device(getattr(args, "device", None))
    in_t, out_t = make_tables(cfg, device, group)
    if mode == "threaded":
        return _run_threaded(cfg, args, metrics, in_t, out_t, group)
    global_batch(cfg.train.batch_size, group)

    def loss_fn(dense_params, rows, batch):
        # rows["out"]: [B, 1 + NEG, dim]
        return w2v.sgns_loss(rows["in"], rows["out"][:, 0],
                             rows["out"][:, 1:])

    # grad_scale=B: the mean loss underscales the per-row updates by the
    # batch size; the scale restores per-pair SGD at this lr
    ps = PSTrainStep(
        loss_fn, sparse={"in": in_t, "out": out_t},
        key_fns={"in": lambda b: b["center"],
                 "out": lambda b: out_keys(b["pos"], b["neg"])},
        grad_scale=cfg.train.batch_size, device=device, group=group)
    batches = batch_gen(cfg, *pairs(cfg, args), cfg.train.seed)
    loop = TrainLoop(lambda b: ps(ps.shard_batch(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size,
                     **loop_profile(args))
    losses = loop.run(cfg.train.num_iters)
    metrics.log(final_loss=losses[-1],
                samples_per_sec=loop.timer.samples_per_sec)
    return {"losses": losses, "samples_per_sec": loop.timer.samples_per_sec,
            "tables": (in_t, out_t)}


def _run_threaded(cfg, args, metrics, in_t, out_t, group) -> dict:
    """Worker threads, the reference's literal "async push" word2vec:
    every thread pulls rows, pushes its SGNS gradients (scaled by B / NW)
    and, under ASP, never blocks. ``samples_per_sec`` leaves out each
    worker's first steps, as on the spmd path (the JAX package reports 0.0
    here)."""
    from minips_tpu_torch.consistency import make_controller
    from minips_tpu_torch.core.engine import Engine, MLTask

    device = in_t.device
    engine = Engine(num_workers=cfg.train.num_workers, device=device,
                    group=group).start_everything()
    for name, t in (("in", in_t), ("out", out_t)):
        # --consistency/--staleness (asp is the reference's configuration)
        engine.register_table(name, t, make_controller(
            cfg.table.consistency, engine.num_workers,
            staleness=cfg.table.staleness, sync_every=0))
    centers, contexts, counts = pairs(cfg, args)
    # the sum of per-sample gradients (the mean loss's times B, the spmd
    # path's grad_scale) over the NW workers that push once per clock: the
    # JAX package pushes B x the gradient from every worker, an NW-times
    # learning rate under sgd on rows every worker pulled at the same
    # state, and at its defaults (4 workers, ASP) its loss reaches inf
    # within 80 steps
    scale = cfg.train.batch_size / engine.num_workers

    def udf(info):
        it_, ot = info.table("in"), info.table("out")
        batches = batch_gen(cfg, centers, contexts, counts,
                            cfg.train.seed + info.worker_id)
        losses, starts = [], []
        for _ in range(cfg.train.num_iters):
            starts.append(time.perf_counter())
            b = to_device(next(batches), device)
            keys = out_keys(b["pos"], b["neg"])
            c_rows = it_.pull(keys=b["center"])  # gated per consistency
            o_rows = ot.pull(keys=keys)
            loss, gc, gp, gn = w2v.grad_fn(c_rows, o_rows[:, 0],
                                           o_rows[:, 1:])
            it_.push(gc * scale, keys=b["center"])
            ot.push(torch.cat([gp[:, None], gn], dim=1) * scale, keys=keys)
            it_.clock()
            ot.clock()
            losses.append(float(loss))
        return losses, starts

    per_worker = engine.run(MLTask(fn=udf))
    samples_per_sec = run_rate(
        engine, [s for _, s in per_worker],
        [cfg.train.batch_size] * engine.num_workers)
    engine.stop_everything()
    losses = mean_losses([w for w, _ in per_worker])
    metrics.log(final_loss=losses[-1], samples_per_sec=samples_per_sec)
    return {"losses": losses, "samples_per_sec": samples_per_sec,
            "tables": (in_t, out_t)}


def _run_multiproc(cfg: Config, args, metrics, vocab: int = VOCAB) -> dict:
    """Skip-gram negative sampling on the key-range-sharded PS: in/out
    embedding tables partitioned across launcher processes by vocab-id
    range — exact per-word rows. The default is ASP (BASELINE.json:11
    "async push"): a pull never parks and pushes land as they arrive;
    --consistency ssp/bsp bounds or removes the drift."""
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

    # tokenize once per rank (same corpus, deterministic), shard the PAIR
    # stream round-robin; counts (and so the vocab and the negative-
    # sampling distribution) stay global and identical on every rank
    centers, contexts, counts = pairs(cfg, args, vocab)
    centers, contexts = centers[rank::nprocs], contexts[rank::nprocs]
    vocab = len(counts)

    dim = cfg.table.dim
    updater = cfg.table.updater  # sgd/adagrad/adam all server-side
    push_comm = getattr(args, "push_comm", "float32")
    mk = lambda name, scale, seed: ShardedTable(  # noqa: E731
        name, vocab, dim, bus, rank, nprocs, updater=updater,
        lr=cfg.table.lr, init_scale=scale, seed=seed, monitor=monitor,
        pull_timeout=30.0, push_comm=push_comm)
    in_t = mk("in", 0.01, 1)
    out_t = mk("out", 0.0, 2)
    trainer = ShardedPSTrainer({"in": in_t, "out": out_t}, bus, nprocs,
                               staleness=staleness, gate_timeout=30.0,
                               monitor=monitor)
    resume = shard_checkpointing(bus, nprocs, cfg.train.checkpoint_dir,
                                 rank)
    bus.handshake(nprocs)
    start_iter, save_hook = resume(
        {"in": in_t, "out": out_t, "trainer": trainer},
        cfg.train.checkpoint_every)

    B = cfg.train.batch_size
    # resumed runs reseed on start_iter: sampling is with-replacement, so
    # resume is convergence-equivalent, not bit-exact
    batches = batch_gen(cfg, centers, contexts, counts,
                        (cfg.train.seed + rank, start_iter))
    losses = []
    fp = 0.0
    t0 = time.monotonic()

    def body():
        nonlocal fp
        for i in range(start_iter, cfg.train.num_iters):
            if getattr(args, "kill_at", 0) \
                    and rank == getattr(args, "kill_rank", -1) \
                    and i == args.kill_at:
                os._exit(137)
            b = next(batches)
            okeys = np.concatenate([b["pos"][:, None], b["neg"]],
                                   axis=1).reshape(-1)  # [B * (1+NEG)]
            c_rows = torch.from_numpy(in_t.pull(b["center"])).to(dev)
            o_rows = torch.from_numpy(out_t.pull(okeys)).to(dev).reshape(
                B, 1 + NEG, dim)
            loss, gc, gp, gn = w2v.grad_fn(c_rows, o_rows[:, 0],
                                           o_rows[:, 1:])
            # x B: per-sample server-add magnitude (the classic per-pair
            # SGNS update; the spmd path's grad_scale)
            in_t.push(b["center"], gc.cpu().numpy() * float(B))
            out_t.push(okeys, torch.cat([gp[:, None], gn], dim=1)
                       .reshape(-1, dim).cpu().numpy() * float(B))
            losses.append(float(loss))
            trainer.tick()
            save_hook(i)
            if rank == getattr(args, "slow_rank", -1) \
                    and getattr(args, "slow_ms", 0) > 0:
                time.sleep(args.slow_ms / 1000.0)
        trainer.finalize(timeout=30.0)
        fp = (float(np.sum(in_t.pull_all()))
              + float(np.sum(out_t.pull_all())))
        trainer.shutdown_barrier(timeout=10.0)

    code = run_multiproc_body(rank, trainer, body)
    if code == 0:
        table_bytes = table_state_bytes(2 * vocab, dim, updater)
        metrics.log(final_loss=losses[-1] if losses else None)
        emit_multiproc_done(trainer, rank, t0, losses, table_bytes, fp,
                            resumed_from=start_iter, push_comm=push_comm,
                            device=str(dev))
    monitor.stop()
    bus.close()
    if code:
        sys.exit(code)
    return {"losses": losses}


def _flags(parser):
    parser.add_argument("--data_file", default=None,
                        help="text file (enwiki-style) tokenized at word "
                             "level instead of the synthetic corpus")
    parser.add_argument("--subsample", type=float, default=0.0,
                        help="frequent-word subsampling threshold t "
                             "(classic 1e-5 for enwiki-scale corpora; "
                             "0 disables)")
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
    return app_main("word2vec_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
