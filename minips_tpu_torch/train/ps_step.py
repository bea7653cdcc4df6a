"""PSTrainStep — the port of ``minips_tpu/train/ps_step.py``.

One training step of a parameter-server job over a dense table and any
number of sparse tables. Per step:

1. hash each sparse table's keys to slots;
2. gather the rows with the row-gather kernel, as a fresh leaf tensor
   that requires a gradient (the gather itself is forward-only);
3. unravel the dense flat vector into a dict of views;
4. call ``loss_fn(dense_params, rows, batch)``, cast to
   ``compute_dtype`` first as the JAX step does;
5. ``torch.autograd.grad`` with respect to the flat vector and the rows;
6. apply ``grad_scale``;
7. run the dense updater on the flat vector;
8. run each sparse table's ``row_update`` on its touched slots.

User contract (as in JAX):
    loss_fn(dense_params, rows: dict[name, [B?, F?, dim]], batch) -> loss
    key_fns[name](batch) -> integer key tensor for that sparse table

The transition is exposed as ``step_fn_pure(state, batch) -> (state,
loss)``: it reads and writes only the state it is handed (the sparse
tables' rows are updated in place, see ``ops/sparse_update.py``), so a
later PR can capture a chain of steps in a CUDA graph. ``__call__`` runs it
against the tables' live state.

Sharded over a process group (``group=``, shared with every table), each
rank runs the step on its own batch shard (``shard_batch``): the sparse
pulls route its keys to their owners and back (``SparseTable.route`` and
``gather``, the row-gather kernel on each owner's shard), the dense
params are all-gathered, the loss is taken on the shard, the dense
gradient is reduce-scattered to the owner shards, the row gradients are
sent to their owners, each owner updates its shard, and the loss returned
is the mean over the ranks.

The gradient scale: the JAX step differentiates ONE loss over the global
batch, this one a loss per rank over its shard. For a batch-mean loss the
global gradient is the mean of the per-rank gradients, so every gradient
is divided by the group size before the updates (``grad_scale`` applies
as well). Every caller's loss is a batch mean: the LR + MLP pair
(``apps/lrmlp.py``, ``bench.py:bench_lrmlp``'s losses) and the apps'
spmd steps (Wide&Deep/DeepFM, LR sparse, MF, word2vec), all mean
cross-entropy or mean squared error over the batch. A loss that sums over
its batch would need the division undone through ``grad_scale``. As in
the JAX step, no ``clip_norm`` of the dense table applies here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from minips_tpu_torch.ops.quantized_comm import (quantized_all_gather,
                                                 quantized_psum_scatter)
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group,
                                            all_reduce_sum, resolve_device,
                                            same_device, shard_batch, world)
from minips_tpu_torch.tables.dense import DenseTable, cast_floating
from minips_tpu_torch.tables.sparse import SparseTable

PyTree = Any


class PSTrainStep:
    """Runs the fused step; owns nothing — state stays in the tables."""

    def __init__(
        self,
        loss_fn: Callable[..., torch.Tensor],
        dense: Optional[DenseTable] = None,
        sparse: Optional[dict[str, SparseTable]] = None,
        key_fns: Optional[dict[str, Callable]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        grad_scale: float = 1.0,
        device: DeviceLike = None,
        group: Group = None,
    ):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): run ``loss_fn`` in
        reduced precision — dense params, gathered rows and floating batch
        leaves are cast down before the loss; gradients come back float32
        (the dtype of the leaves they are taken against) and table state
        stays float32.

        ``grad_scale``: multiply all gradients by this constant before the
        updates while reporting the unscaled loss (per-sample update
        semantics for a batch-mean loss).

        ``group``: the process group every table is sharded over (each
        table's own ``group``); ``None`` is one device."""
        if compute_dtype is not None and not compute_dtype.is_floating_point:
            raise ValueError(f"compute_dtype must be a floating dtype, got "
                             f"{compute_dtype}")
        self.compute_dtype = compute_dtype
        if grad_scale <= 0:
            raise ValueError(f"grad_scale must be > 0, got {grad_scale}")
        self.grad_scale = float(grad_scale)
        self.loss_fn = loss_fn
        self.dense = dense
        self.sparse = dict(sparse or {})
        self.key_fns = dict(key_fns or {})
        if "dense" in self.sparse:
            raise ValueError(
                "'dense' is a reserved state key; rename the sparse table")
        missing = set(self.sparse) - set(self.key_fns)
        if missing:
            raise ValueError(f"sparse tables missing key_fns: {missing}")
        if dense is None and not self.sparse:
            raise ValueError("PSTrainStep needs a dense table and/or at "
                             "least one sparse table")
        self.device = resolve_device(device)
        tables = ([dense] if dense is not None else []) + list(
            self.sparse.values())
        for t in tables:
            if not same_device(t.device, self.device):
                raise ValueError(f"table {t.name!r} lives on {t.device}, "
                                 f"the step on {self.device}")
            if t.group is not group:
                raise ValueError(f"table {t.name!r} is sharded over another "
                                 "process group than the step's")
        self.group = group
        self.rank, self.world_size = world(group)

    # ------------------------------------------------------------------ state
    def _collect_state(self) -> dict:
        state: dict = {}
        if self.dense is not None:
            state["dense"] = (self.dense.params, self.dense.opt_state)
        for name, t in self.sparse.items():
            state[name] = (t.emb, t.opt_state())
        return state

    def _restore_state(self, state: dict) -> None:
        if self.dense is not None:
            self.dense.params, self.dense.opt_state = state["dense"]
        for name, t in self.sparse.items():
            t.emb, opt = state[name]
            t.set_opt_state(opt)

    # ------------------------------------------------------------------- step
    def step_fn_pure(self, state: dict, batch: dict):
        """One step: ``(state, batch) -> (new_state, loss)``."""
        dense, cd, group = self.dense, self.compute_dtype, self.group
        cbatch = cast_floating(batch, cd)

        routes, rows = {}, {}
        for name, t in self.sparse.items():
            routes[name] = t.route(self.key_fns[name](batch))
            # a fresh copy: the leaf the row gradients are taken against
            rows[name] = t.gather(state[name][0],
                                  routes[name]).requires_grad_()

        leaves = list(rows.values())
        dp = None
        if dense is not None:
            p_flat, opt = state["dense"]
            full = quantized_all_gather(p_flat, group)            # pull
            p_leaf = full.detach().requires_grad_()
            leaves = [p_leaf] + leaves
            dp = cast_floating(dense.unravel(p_leaf), cd)
        loss = self.loss_fn(dp, cast_floating(rows, cd), cbatch).float()
        grads = list(torch.autograd.grad(loss, leaves))
        # the global batch's mean gradient is the mean of the ranks'
        scale = self.grad_scale / self.world_size
        if scale != 1.0:
            grads = [g * scale for g in grads]

        new_state = dict(state)
        if dense is not None:
            g_flat = quantized_psum_scatter(grads.pop(0), group)  # push
            updates, opt = dense.tx.update(g_flat, opt, p_flat)
            new_state["dense"] = (p_flat + updates, opt)
        for (name, t), g in zip(self.sparse.items(), grads):
            emb, opt_rows = state[name]
            new_state[name] = t.row_update(emb, opt_rows,
                                           routes[name].local,
                                           t.to_owners(routes[name], g))
        loss = loss.detach()
        if group is not None:
            loss = all_reduce_sum(loss, group) / self.world_size
        return new_state, loss

    # -------------------------------------------------------------------- run
    def __call__(self, batch: dict) -> torch.Tensor:
        """Run one step against the tables' live state; returns the loss
        as a device scalar (reading it waits for the step)."""
        new_state, loss = self.step_fn_pure(self._collect_state(), batch)
        self._restore_state(new_state)
        return loss

    def shard_batch(self, batch: PyTree) -> PyTree:
        """This rank's shard of a global batch of numpy arrays (or
        tensors), on the step's device: rows ``[r*B/n, (r+1)*B/n)`` of
        every leaf (the whole batch under ``group=None``). B must divide
        by the group size."""
        return shard_batch(batch, self.group, self.device)
