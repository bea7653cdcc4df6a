"""DenseTable — the port of ``minips_tpu/tables/dense.py``.

A dense table is a flat parameter vector: the template's leaves raveled in
``jax.flatten_util.ravel_pytree`` order (dict children in sorted-key
order, list children in order, each leaf row-major), zero-padded to the
range partition, with a server-side updater applied at push. Keeping JAX's
ravel order lets the two packages exchange parameters and optimizer state
as flat vectors; for the MLP tower that order is ``b0, b1, b2, w0, w1,
w2``, for LR ``b, w``, for the LM ``blocks[0..]``, ``ln_f``, ``pos_emb``,
``tok_emb``.

The table is range-sharded over a process group (``group=``, see
``parallel/mesh.py``): rank ``r`` of ``n`` holds the ``r``-th of ``n``
contiguous shards of the padded vector and that shard's optimizer state,
as device ``r`` of the JAX table's ``data`` axis does. The pull is an
all-gather; the push runs the updater on the owner shard. ``make_step``
fuses pull, gradient, push and update into one call, as the JAX package's
does, with ``comm`` (the quantized collectives), ``accum``,
``compute_dtype``, ``grad_reduce`` and the global-norm clip.
``group=None`` is one device holding the one shard, with no collective.

The optimizer state's leaves follow the JAX table's specs: a 0-d leaf
(adam's count, a schedule's count) is replicated on every rank; a 1-D leaf
(moments, accumulators, the decay mask, adam8's codes and its per-block
scales) is range-sharded like the params.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from minips_tpu_torch.ops.quantized_comm import (_check,
                                                 quantized_all_gather,
                                                 quantized_psum_scatter)
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group, all_gather,
                                            all_reduce_sum, resolve_device,
                                            world)
from minips_tpu_torch.parallel.partition import RangePartitioner
from minips_tpu_torch.tables.updaters import (LearningRate, Updater,
                                              make_updater)
from minips_tpu_torch.utils.tree import PyTree, tree_leaves, tree_map, \
    tree_rebuild


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot change.
    numpy has no bfloat16: a bfloat16 tensor comes out as its uint16 bit
    pattern."""
    t = t.detach().to("cpu", copy=True)
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _tensor_like(arr, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype and device. Into a bfloat16
    leaf, a 2-byte array that is not float16 (the uint16 bit pattern of
    :func:`_host`, or JAX's ``ml_dtypes`` bfloat16) is read bit for bit."""
    arr = np.asarray(arr)
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype != np.float16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    return t.to(device=like.device, dtype=like.dtype)


def ravel(tree: PyTree, device: Optional[torch.device] = None):
    """``ravel_pytree`` for nested dicts and lists: (flat vector, unravel).
    Leaves go in ``jax.tree.leaves`` order, each flattened row-major.
    ``unravel(flat)`` returns views into ``flat`` (sharing its storage)."""
    leaves = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
              for x in tree_leaves(tree)]
    if device is None:
        device = leaves[0].device if leaves else torch.device("cpu")
    flat = (torch.cat([x.reshape(-1).to(device) for x in leaves])
            if leaves else torch.zeros(0, device=device))
    shapes = [tuple(x.shape) for x in leaves]

    def unravel(vec: torch.Tensor) -> PyTree:
        return tree_rebuild(tree, iter(_split(vec, shapes)))

    return flat, unravel


def _split(vec, shapes):
    out, i = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(vec[i:i + n].view(s))
        i += n
    return out


def cast_floating(tree: PyTree, dtype: Optional[torch.dtype]) -> PyTree:
    """Cast every floating tensor of ``tree`` to ``dtype`` (integers and
    bools pass through); ``None`` is the identity. The shared
    mixed-precision downcast of ``PSTrainStep``."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype) if torch.is_tensor(x)
                    and x.is_floating_point() else x, tree)


class DenseTable:
    """A dense parameter table: one flat vector, range-sharded over the
    group, plus its updater state."""

    def __init__(
        self,
        template: PyTree,
        *,
        name: str = "dense0",
        updater: str = "sgd",
        lr: LearningRate = 0.1,
        grad_reduce: str = "mean",
        tx: Optional[Updater] = None,
        updater_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
        group: Group = None,
    ):
        """``tx`` is an updater built by the caller (it replaces
        ``updater``, ``lr`` and ``updater_kwargs``), as in the JAX
        package. ``group``: the process group the table is sharded over
        (every rank builds the table from the same template); ``None`` is
        one device."""
        if grad_reduce not in ("mean", "sum"):
            raise ValueError("grad_reduce must be 'mean' or 'sum'")
        self.name = name
        self.grad_reduce = grad_reduce
        self.device = resolve_device(device)
        self.group = group
        self.rank, self.num_shards = world(group)

        flat, self._unravel = ravel(template, self.device)
        self.num_keys = int(flat.shape[0])
        kw = dict(updater_kwargs or {})
        # adam8's scales cover whole blocks of the flat vector, so each
        # range shard holds whole blocks: the padding aligns to the block
        # (padding keys are zeros with zero gradients and never move)
        align = int(kw.get("block", 256)) if updater == "adam8" else 1
        self.partitioner = RangePartitioner(self.num_keys, self.num_shards,
                                            align=align)
        self.padded = self.partitioner.padded
        shard = self.partitioner.shard_size
        self._lo = self.rank * shard  # this rank's range [lo, lo + shard)
        # global-norm clipping is the table's, over the whole gradient (the
        # JAX table intercepts it the same way for its sharded update)
        self._clip_norm = float(kw.pop("clip_norm", 0.0) or 0.0)
        if kw.get("decay_mask") is not None:
            mflat, _ = ravel(kw["decay_mask"], self.device)
            if mflat.shape != flat.shape:
                raise ValueError(
                    f"decay_mask ravels to {tuple(mflat.shape)}, params to "
                    f"{tuple(flat.shape)} — the mask must be params-shaped")
            # padded, then sliced to this rank's shard: the mask rides in
            # the state as a range-sharded leaf
            kw["decay_mask"] = self._shard(self._pad(mflat.to(flat.dtype)))
        self.tx = tx if tx is not None else make_updater(updater, lr, **kw)
        # the updater runs on one range shard: its state must fit one (a
        # quantized state's blocks must not straddle two); a probe on the
        # meta device allocates nothing
        try:
            self.tx.init(torch.empty(shard, device="meta"))
        except ValueError as e:
            raise ValueError(
                f"the updater's state does not fit a range shard of {shard} "
                f"keys ({e}): each shard must hold whole blocks (use "
                "updater='adam8' so the table aligns its padding, or pick a "
                "block that divides the shard size)") from e
        self.params = self._shard(self._pad(flat))
        self.opt_state = self.tx.init(self.params)
        bad = [tuple(x.shape) for x in self.opt_state if x.dim() > 1]
        if bad:
            raise ValueError(f"updater state leaves must be 0-d (replicated) "
                             f"or 1-D (range-sharded), got shapes {bad}")

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.padded, dtype=flat.dtype, device=self.device)
        out[: self.num_keys] = flat
        return out

    def _shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's range of a global 1-D leaf (``full`` itself under
        ``group=None``), whatever the leaf's length: a per-block leaf
        (adam8's scales) shards in step with the params it covers."""
        if self.group is None:
            return full
        size = full.shape[0] // self.num_shards
        return full[self.rank * size:(self.rank + 1) * size].clone()

    def _gather(self, leaf: torch.Tensor) -> torch.Tensor:
        """The global value of a state leaf: a 1-D leaf's shards in rank
        order, a 0-d leaf as it is (collective under a group)."""
        if self.group is None or leaf.dim() == 0:
            return leaf
        return all_gather(leaf, self.group).reshape(-1)

    def unravel(self, flat: torch.Tensor) -> PyTree:
        """The template's tree of views into ``flat[:num_keys]``."""
        return self._unravel(flat[: self.num_keys])

    # ------------------------------------------------------------------ pull
    def pull(self) -> PyTree:
        """The full parameter tree (an all-gather of the shards; every
        rank calls it)."""
        return self.unravel(self._gather(self.params))

    def pull_keys(self, keys) -> torch.Tensor:
        """Sparse read of a dense table (emulation/API-parity path); keys
        index the global vector."""
        return self._gather(self.params)[
            torch.as_tensor(keys, device=self.device).long()]

    # ------------------------------------------------------------------ push
    def push(self, grads: PyTree) -> None:
        """Apply a full-tree gradient through the server-side updater. The
        caller passes the already-reduced gradient, the same on every
        rank; each rank applies its own range of it."""
        gflat, _ = ravel(grads, self.device)
        self._apply(self._shard(self._pad(gflat)))

    def push_keys(self, keys, vals) -> None:
        """Sparse additive push: only the pushed keys' parameters and
        elementwise optimizer state move; scalar state (adam's count)
        still advances once per push. Keys index the global vector; every
        rank is handed the same keys and applies those in its range."""
        keys = torch.as_tensor(keys, device=self.device).long()
        vals = torch.as_tensor(vals, device=self.device,
                               dtype=self.params.dtype)
        if self.group is not None:
            own = (keys >= self._lo) & (keys < self._lo + self.params.shape[0])
            keys, vals = keys[own] - self._lo, vals[own]
        flat = torch.zeros_like(self.params).index_add_(0, keys, vals)
        mask = torch.zeros_like(self.params).index_fill_(0, keys, 1.0)
        self._apply(flat, mask)

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        """Global-norm clip over the whole gradient, its sum of squares
        summed over the shards (a no-op without ``clip_norm``)."""
        if not self._clip_norm:
            return g
        sumsq = all_reduce_sum(torch.sum(g * g), self.group)
        return g * torch.clamp(self._clip_norm * torch.rsqrt(
            torch.clamp(sumsq, min=1e-16)), max=1.0)

    def _apply(self, g: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> None:
        g = self._clip(g)
        updates, new_opt = self.tx.update(g, self.opt_state, self.params)
        if mask is not None:
            updates = updates * mask
            # untouched keys keep their old state (adam8's block by block)
            new_opt = self.tx.restore(new_opt, self.opt_state, mask)
        self.params = self.params + updates
        self.opt_state = new_opt

    # ------------------------------------------------------------- fused step
    def make_step(
        self,
        grad_fn: Callable[[PyTree, Any], tuple[torch.Tensor, PyTree]],
        *,
        accum: int = 1,
        compute_dtype: Optional[torch.dtype] = None,
        comm: str = "float32",
    ):
        """Pull, gradient, push and update in one call — the port of the
        JAX package's ``DenseTable.make_step``.

        ``grad_fn(params_tree, batch) -> (loss, grads_tree)`` runs on this
        rank's batch shard; the returned ``step(params, opt_state, batch)
        -> (params, opt_state, loss)`` reads this rank's shard of the
        padded flat params and returns new ones (``step_inplace`` runs it
        against the table's own state). Every rank of the group calls it
        with its own batch shard. In order: the pull (``comm``'s
        all-gather of the shards), the gradient, the push (``comm``'s
        reduce-scatter to the owner shards, divided by the world size
        under ``grad_reduce="mean"``), the global-norm clip and the
        updater on the shard; the loss returned is the mean over the
        ranks.

        ``comm`` is the wire format of both collectives: ``"float32"``,
        ``"bfloat16"`` or ``"int8"`` (``ops/quantized_comm.py``). Params
        and the update stay float32. Under ``group=None`` the codec still
        runs (the pulled params and the pushed gradient go through it), as
        on a one-device JAX mesh.

        ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the params and the
        batch's floating leaves down before ``grad_fn`` and the gradients
        back up to float32 before the push: the master weights and the
        update stay float32. ``accum`` > 1 splits the batch's leading dim
        into that many microbatches and folds their losses and flat
        gradients in float32 (averaged under ``grad_reduce="mean"``,
        summed under ``"sum"``) before one update.

        The JAX function's ``batch_spec`` and ``jit`` have no
        counterpart: each rank is handed its own batch shard, and PyTorch
        runs eagerly.
        """
        _check(comm)
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        n, padded, shards = self.num_keys, self.padded, self.num_shards
        unravel, tx, reduce = self._unravel, self.tx, self.grad_reduce
        group = self.group

        if compute_dtype is not None:
            user_grad_fn = grad_fn

            def grad_fn(params, batch):  # noqa: F811 - deliberate wrap
                loss, grads = user_grad_fn(cast_floating(params, compute_dtype),
                                           cast_floating(batch, compute_dtype))
                return loss.float(), cast_floating(grads, torch.float32)

        def grads_flat(params, batch):
            if accum == 1:
                loss, grads = grad_fn(params, batch)
                return loss, ravel(grads)[0]
            for leaf in tree_leaves(batch):
                if leaf.shape[0] % accum:
                    raise ValueError(f"batch dim {leaf.shape[0]} must "
                                     f"divide by accum={accum}")
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            gsum = torch.zeros(n, dtype=torch.float32, device=self.device)
            for i in range(accum):
                micro = tree_map(lambda x: x.reshape(
                    (accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i],
                    batch)
                loss, grads = grad_fn(params, micro)
                loss_sum = loss_sum + loss
                gsum = gsum + ravel(grads)[0]
            if reduce == "sum":
                return loss_sum, gsum
            return loss_sum / accum, gsum / accum

        def step(params, opt_state, batch):
            full = quantized_all_gather(params, group, comm)        # pull
            loss, gflat = grads_flat(unravel(full[:n]), batch)
            g = torch.zeros(padded, dtype=gflat.dtype, device=gflat.device)
            g[:n] = gflat
            g = quantized_psum_scatter(g, group, comm)              # push
            if reduce == "mean":
                g = g / shards
            updates, opt_state = tx.update(self._clip(g), opt_state, params)
            if group is not None:
                loss = all_reduce_sum(loss.detach(), group) / shards
            return params + updates, opt_state, loss

        return step

    def step_inplace(self, step, batch) -> torch.Tensor:
        """Run a fused step against the table's own state."""
        self.params, self.opt_state, loss = step(self.params, self.opt_state,
                                                 batch)
        return loss

    # ------------------------------------------------------------- state I/O
    def state_dict(self) -> dict:
        """Host copies of the global state, in the JAX package's layout:
        ``params`` (padded flat) and ``opt_state`` (the leaves in
        ``jax.tree.leaves`` order; bfloat16 leaves as their uint16 bit
        patterns). Under a group the shards are gathered: every rank calls
        it together and gets the whole state."""
        return {"params": _host(self._gather(self.params)),
                "opt_state": [_host(self._gather(x)) for x in self.opt_state]}

    def load_state_dict(self, state: dict) -> None:
        """Load a global state (as :meth:`state_dict` returns it, or the
        JAX table's); each rank keeps its shard. The padded size depends
        on the shard count, so a state carries across group sizes only
        where the padding agrees."""
        params = torch.tensor(np.asarray(state["params"]))
        if tuple(params.shape) != (self.padded,):
            raise ValueError(f"params shape {tuple(params.shape)} does not "
                             f"match the table's {(self.padded,)}")
        new_leaves = list(state.get("opt_state", []))
        if len(new_leaves) != len(self.opt_state):
            raise ValueError(
                f"opt state leaf count mismatch: table has "
                f"{len(self.opt_state)}, state has {len(new_leaves)} "
                "(different updater?)")
        loaded = []
        for cur, new in zip(self.opt_state, new_leaves):
            shape = tuple(np.shape(new))
            want = tuple(cur.shape) if cur.dim() == 0 else \
                (cur.shape[0] * self.num_shards,)
            if shape != want:
                raise ValueError(f"opt state leaf shape {shape} "
                                 f"does not match {want}")
            loaded.append(self._shard(_tensor_like(new, cur))
                          if cur.dim() else _tensor_like(new, cur))
        self.params = self._shard(params.to(device=self.device,
                                             dtype=self.params.dtype))
        self.opt_state = loaded

