"""DenseTable — the port of ``minips_tpu/tables/dense.py``.

A dense table is a flat parameter vector: the template's leaves raveled in
``jax.flatten_util.ravel_pytree`` order (sorted dict keys, each leaf
row-major), zero-padded to the range partition, with a server-side
updater applied at push. Keeping JAX's ravel order lets the two packages
exchange parameters and optimizer state as flat vectors; for the MLP tower
that order is ``b0, b1, b2, w0, w1, w2``, for LR ``b, w``.

World size is 1 in this slice: the pull is a read and the push the
updater on the one shard. The JAX package's fused ``make_step`` is not on
this slice's path and waits for the next one.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from minips_tpu_torch.parallel.mesh import (WORLD_SIZE, DeviceLike,
                                            resolve_device)
from minips_tpu_torch.parallel.partition import RangePartitioner
from minips_tpu_torch.tables.updaters import LearningRate, make_updater

PyTree = Any  # nested dicts of tensors


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot change."""
    return t.detach().to("cpu", copy=True).numpy()


def _leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def ravel(tree: PyTree, device: Optional[torch.device] = None):
    """``ravel_pytree`` for nested dicts: (flat vector, unravel). Leaves go
    in sorted-key order, each flattened row-major. ``unravel(flat)``
    returns views into ``flat`` (sharing its storage)."""
    leaves = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
              for x in _leaves(tree)]
    if device is None:
        device = leaves[0].device if leaves else torch.device("cpu")
    flat = (torch.cat([x.reshape(-1).to(device) for x in leaves])
            if leaves else torch.zeros(0, device=device))
    shapes = [tuple(x.shape) for x in leaves]

    def unravel(vec: torch.Tensor) -> PyTree:
        it = iter(_split(vec, shapes))
        return _rebuild(tree, it)

    return flat, unravel


def _split(vec, shapes):
    out, i = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(vec[i:i + n].view(s))
        i += n
    return out


def _rebuild(template, it):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    return next(it)


def cast_floating(tree: PyTree, dtype: Optional[torch.dtype]) -> PyTree:
    """Cast every floating tensor of ``tree`` to ``dtype`` (integers and
    bools pass through); ``None`` is the identity. The shared
    mixed-precision downcast of ``PSTrainStep``."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class DenseTable:
    """A dense parameter table: one flat vector plus its updater state."""

    def __init__(
        self,
        template: PyTree,
        *,
        name: str = "dense0",
        updater: str = "sgd",
        lr: LearningRate = 0.1,
        updater_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
    ):
        self.name = name
        self.device = resolve_device(device)
        self.num_shards = WORLD_SIZE

        flat, self._unravel = ravel(template, self.device)
        self.num_keys = int(flat.shape[0])
        kw = dict(updater_kwargs or {})
        self.partitioner = RangePartitioner(self.num_keys, self.num_shards)
        self.padded = self.partitioner.padded
        # global-norm clipping is the table's, over the whole gradient (the
        # JAX table intercepts it the same way for its sharded update)
        self._clip_norm = float(kw.pop("clip_norm", 0.0) or 0.0)
        if kw.get("decay_mask") is not None:
            mflat, _ = ravel(kw["decay_mask"], self.device)
            if mflat.shape != flat.shape:
                raise ValueError(
                    f"decay_mask ravels to {tuple(mflat.shape)}, params to "
                    f"{tuple(flat.shape)} — the mask must be params-shaped")
            kw["decay_mask"] = self._pad(mflat.to(flat.dtype))
        self.tx = make_updater(updater, lr, **kw)
        self.params = self._pad(flat)
        self.opt_state = self.tx.init(self.params)

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.padded, dtype=flat.dtype, device=self.device)
        out[: self.num_keys] = flat
        return out

    def unravel(self, flat: torch.Tensor) -> PyTree:
        """The template's dict of views into ``flat[:num_keys]``."""
        return self._unravel(flat[: self.num_keys])

    # ------------------------------------------------------------------ pull
    def pull(self) -> PyTree:
        """The full parameter dict."""
        return self.unravel(self.params)

    def pull_keys(self, keys) -> torch.Tensor:
        """Sparse read of a dense table (emulation/API-parity path)."""
        return self.params[torch.as_tensor(keys, device=self.device).long()]

    # ------------------------------------------------------------------ push
    def push(self, grads: PyTree) -> None:
        """Apply a full-dict gradient through the server-side updater."""
        gflat, _ = ravel(grads, self.device)
        self._apply(self._pad(gflat))

    def push_keys(self, keys, vals) -> None:
        """Sparse additive push: only the pushed keys' parameters and
        elementwise optimizer state move; scalar state (adam's count)
        still advances once per push."""
        keys = torch.as_tensor(keys, device=self.device).long()
        vals = torch.as_tensor(vals, device=self.device,
                               dtype=self.params.dtype)
        flat = torch.zeros_like(self.params).index_add_(0, keys, vals)
        mask = torch.zeros_like(self.params).index_fill_(0, keys, 1.0)
        self._apply(flat, mask)

    def _apply(self, g: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> None:
        if self._clip_norm:
            sumsq = torch.sum(g * g)
            g = g * torch.clamp(self._clip_norm * torch.rsqrt(
                torch.clamp(sumsq, min=1e-16)), max=1.0)
        updates, new_opt = self.tx.update(g, self.opt_state, self.params)
        if mask is not None:
            updates = updates * mask
            new_opt = [torch.where(mask > 0, new, old)
                       if new.shape == self.params.shape else new
                       for new, old in zip(new_opt, self.opt_state)]
        self.params = self.params + updates
        self.opt_state = new_opt

    # ------------------------------------------------------------- state I/O
    def state_dict(self) -> dict:
        """Host copies: ``params`` (padded flat) and ``opt_state`` (the
        leaves in ``jax.tree.leaves`` order)."""
        return {"params": _host(self.params),
                "opt_state": [_host(x) for x in self.opt_state]}

    def load_state_dict(self, state: dict) -> None:
        params = torch.tensor(np.asarray(state["params"]))
        if tuple(params.shape) != tuple(self.params.shape):
            raise ValueError(f"params shape {tuple(params.shape)} does not "
                             f"match the table's {tuple(self.params.shape)}")
        new_leaves = list(state.get("opt_state", []))
        if len(new_leaves) != len(self.opt_state):
            raise ValueError(
                f"opt state leaf count mismatch: table has "
                f"{len(self.opt_state)}, state has {len(new_leaves)} "
                "(different updater?)")
        loaded = []
        for cur, new in zip(self.opt_state, new_leaves):
            t = torch.tensor(np.asarray(new))
            if tuple(t.shape) != tuple(cur.shape):
                raise ValueError(f"opt state leaf shape {tuple(t.shape)} "
                                 f"does not match {tuple(cur.shape)}")
            loaded.append(t.to(device=self.device, dtype=cur.dtype))
        self.params = params.to(device=self.device, dtype=self.params.dtype)
        self.opt_state = loaded

