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
other ranks serve (``core/engine.py``). ``--exec multiproc`` (ROADMAP.md
queue 1 items 14-15) is not ported yet and raises.

Usage: python -m minips_tpu_torch.apps.word2vec_example --num_iters 200
"""

from __future__ import annotations

import time

import numpy as np
import torch

from minips_tpu_torch.apps.common import (app_main, global_batch,
                                          mean_losses, run_rate, to_device)
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
        raise SystemExit("--exec multiproc is not ported yet (ROADMAP.md "
                         "queue 1 items 14-15: the sharded PS)")
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
                     batch_size=cfg.train.batch_size)
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


def _flags(parser):
    parser.add_argument("--data_file", default=None,
                        help="text file (enwiki-style) tokenized at word "
                             "level instead of the synthetic corpus")
    parser.add_argument("--subsample", type=float, default=0.0,
                        help="frequent-word subsampling threshold t "
                             "(classic 1e-5 for enwiki-scale corpora; "
                             "0 disables)")


def main():
    return app_main("word2vec_example", DEFAULT, run, extra_flags=_flags,
                    exec_choices=("spmd", "threaded", "multiproc"))


if __name__ == "__main__":
    main()
