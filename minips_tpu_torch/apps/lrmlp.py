"""The LR + MLP parameter-server pair — the training step that the primary
metric (samples/s per chip, LR plus MLP on Criteo-shaped data) times.

``build_lrmlp`` builds the two ``PSTrainStep``s and their four tables
exactly as ``bench.py:bench_lrmlp`` builds them for the JAX package:

- LR: a hashed "wide" SparseTable (2^18 x 1, row Adagrad, salt 1) plus a
  dense LR table (13 weights and a bias, Adagrad);
- MLP: a hashed "emb" SparseTable (2^18 x 8, row Adagrad, salt 2) plus the
  221 -> 256 -> 128 -> 1 tower (Adam), its matmuls in bf16 by default.

Both steps read the same batch. Given a process group, the four tables
are range-sharded over it and each rank steps on its shard of the batch.
``chip_smoke.py`` and the tests share this function; it is not a
benchmark.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from minips_tpu_torch.data import synthetic
from minips_tpu_torch.models import lr as lr_model
from minips_tpu_torch.models import mlp as mlp_model
from minips_tpu_torch.models import wide_deep as wd_model
from minips_tpu_torch.parallel.mesh import DeviceLike, Group, resolve_device
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable
from minips_tpu_torch.train.ps_step import PSTrainStep

NUM_DENSE, NUM_CAT, EMB_DIM, HIDDEN = 13, 26, 8, (256, 128)


def build_lrmlp(batch: int, device: DeviceLike = None, seed: int = 0, *,
                num_slots: int = 1 << 18,
                mlp_compute_dtype: torch.dtype = torch.bfloat16,
                group: Group = None):
    """The pair at (global) batch size ``batch``. Returns a namespace with
    ``lr_step``, ``mlp_step``, the tables ``wide``, ``lin``, ``emb``,
    ``deep``, and ``batches``: this rank's shards of two ``criteo_like``
    batches (seeds 0 and 1) on the device, the rotation the JAX bench
    uses. ``seed`` seeds the tables and the tower's init; ``num_slots`` and
    ``mlp_compute_dtype`` exist so that the CPU tests can run the pair
    small and in float32. ``group``: the process group every table and
    step is sharded over (``None``: one device)."""
    device = resolve_device(device)
    wide = SparseTable(num_slots, 1, name="wide", updater="adagrad", lr=0.05,
                       init_scale=0.0, salt=1, seed=seed, device=device,
                       group=group)
    lin = DenseTable(lr_model.init(NUM_DENSE, device=device), name="lin",
                     updater="adagrad", lr=0.05, device=device, group=group)

    def lr_loss(dp, rows, b):
        logits = (torch.sum(rows["wide"][..., 0], dim=-1)
                  + lr_model.logits_dense(dp, b["dense"]))
        return lr_model.bce_with_logits(logits, b["y"])

    lr_step = PSTrainStep(lr_loss, dense=lin, sparse={"wide": wide},
                          key_fns={"wide": lambda b: b["cat"]},
                          device=device, group=group)

    emb = SparseTable(num_slots, EMB_DIM, name="emb", updater="adagrad",
                      lr=0.05, init_scale=0.01, salt=2, seed=seed,
                      device=device, group=group)
    gen = torch.Generator().manual_seed(seed)
    deep = DenseTable(
        wd_model.init_deep(gen, NUM_CAT, EMB_DIM, NUM_DENSE, hidden=HIDDEN,
                           device=device),
        name="deep", updater="adam", lr=1e-3, device=device, group=group)

    def mlp_loss(dp, rows, b):
        bsz = rows["emb"].shape[0]
        x = torch.cat([b["dense"], rows["emb"].reshape(bsz, -1)], dim=-1)
        logits = mlp_model.apply(dp, x, compute_dtype=mlp_compute_dtype)[:, 0]
        return lr_model.bce_with_logits(logits, b["y"])

    mlp_step = PSTrainStep(mlp_loss, dense=deep, sparse={"emb": emb},
                           key_fns={"emb": lambda b: b["cat"]},
                           device=device, group=group)
    batches = [lr_step.shard_batch(synthetic.criteo_like(batch, seed=s))
               for s in (0, 1)]
    return SimpleNamespace(lr_step=lr_step, mlp_step=mlp_step, wide=wide,
                           lin=lin, emb=emb, deep=deep, batches=batches)
