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
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from minips_tpu_torch.ops.gather import gather_rows
from minips_tpu_torch.parallel.mesh import (DeviceLike, resolve_device,
                                            same_device)
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
    ):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): run ``loss_fn`` in
        reduced precision — dense params, gathered rows and floating batch
        leaves are cast down before the loss; gradients come back float32
        (the dtype of the leaves they are taken against) and table state
        stays float32.

        ``grad_scale``: multiply all gradients by this constant before the
        updates while reporting the unscaled loss (per-sample update
        semantics for a batch-mean loss)."""
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
        dense, cd = self.dense, self.compute_dtype
        cbatch = cast_floating(batch, cd)

        slots, rows = {}, {}
        for name, t in self.sparse.items():
            slots[name] = t.slots_of(self.key_fns[name](batch))
            # a fresh copy: the leaf the row gradients are taken against
            rows[name] = gather_rows(state[name][0],
                                     slots[name]).requires_grad_()

        leaves = list(rows.values())
        dp = None
        if dense is not None:
            p_flat, opt = state["dense"]
            p_leaf = p_flat.detach().requires_grad_()
            leaves = [p_leaf] + leaves
            dp = cast_floating(dense.unravel(p_leaf), cd)
        loss = self.loss_fn(dp, cast_floating(rows, cd), cbatch).float()
        grads = list(torch.autograd.grad(loss, leaves))
        if self.grad_scale != 1.0:
            grads = [g * self.grad_scale for g in grads]

        new_state = dict(state)
        if dense is not None:
            g_flat = grads.pop(0)
            updates, opt = dense.tx.update(g_flat, opt, p_flat)
            new_state["dense"] = (p_flat + updates, opt)
        for (name, t), g in zip(self.sparse.items(), grads):
            emb, opt_rows = state[name]
            new_state[name] = t.row_update(emb, opt_rows, slots[name], g)
        return new_state, loss.detach()

    # -------------------------------------------------------------------- run
    def __call__(self, batch: dict) -> torch.Tensor:
        """Run one step against the tables' live state; returns the loss
        as a device scalar (reading it waits for the step)."""
        new_state, loss = self.step_fn_pure(self._collect_state(), batch)
        self._restore_state(new_state)
        return loss

    def shard_batch(self, batch: PyTree) -> PyTree:
        """Move a batch of numpy arrays (or tensors) to the step's device —
        at world size 1 the one shard is the whole batch."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        if torch.is_tensor(batch):
            return batch.to(self.device)
        return torch.as_tensor(np.asarray(batch), device=self.device)
