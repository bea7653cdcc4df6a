"""Carry table state between the JAX package and the port, as numpy.

``jax.random`` and ``torch.Generator`` give different numbers from the
same seed, so a comparison of the two packages starts both from identical
weights by carrying them across. The JAX side hands over:

- a sparse table: the dict of ``SparseTable.state_dict()`` — ``emb``,
  ``layout``, then ``accum`` (adagrad) or ``m``, ``v``, ``steps`` (adam);
- a dense table: the padded flat ``params`` and the list
  ``jax.tree.leaves(opt_state)`` in leaf order — adagrad gives
  ``[sum_of_squares]``, adam ``[count, mu, nu]``, adam_bf16 ``[count, mu,
  nu]`` with bfloat16 moments, adam8 ``[count, mu_q, mu_s, nu_q, nu_s]``
  (uint8 codes, float32 scales).

The reverse direction returns the port's state in the same layout, for
comparing final states. numpy has no bfloat16 of its own: the JAX side's
bfloat16 leaves arrive as ``ml_dtypes`` arrays, which ``torch.from_numpy``
refuses, so both directions go through a uint16 view. ``load_dense`` reads
any 2-byte array into a bfloat16 leaf bit for bit, and ``dense_to_numpy``
returns bfloat16 leaves as uint16 bit patterns (compare them with
``np.asarray(leaf).view(np.uint16)``). This module imports neither JAX nor the JAX
package: the caller does the ``jax.tree.leaves`` on its side.

``shard_from_numpy`` carries a JAX params tree into a model-parallel
layout: one rank's shard of every leaf per a spec tree of
``models/transformer.py`` (``tp_specs``, ``pp_specs`` of the blocks stacked
on either side by ``stack_layers``, ``ep_lm_specs``), the shard that the
JAX array places on device (d, m) of its mesh for rank ``d·model_size +
m``: pass ``m`` as the index for tp and pp, ``d`` for ep.

The trainers of the collective consistency plane carry across too:
``load_ssp`` (an ``SSPTrainer``'s raveled replica and clock),
``load_cssp`` (a ``CollectiveSSP``'s params, opt state, sync base and
residual) and ``load_cssp_ps`` (a ``CollectiveSSPPS``'s tables and
bases). A JAX trainer's table is padded for its mesh, a port trainer's
for one device: they load through ``load_dense(..., refit=True)``, which
refits each params-length leaf.

Every array here is global, as the JAX table holds it. Into a table
sharded over a process group, each rank loads the same global arrays and
keeps its own range; out of one, the shards are gathered, a collective
that every rank calls (the table's ``state_dict``). A dense table's
padded size depends on its shard count, so its flat state carries across
only at the JAX mesh's size.
"""

from __future__ import annotations

import numpy as np
import torch

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.parallel.partition import shard_params
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable
from minips_tpu_torch.utils.tree import tree_map


def load_sparse(table: SparseTable, state: dict) -> None:
    """Load a JAX ``SparseTable.state_dict()`` (numpy arrays, global);
    each rank keeps its rows."""
    table.load_state_dict({k: np.asarray(v) for k, v in state.items()})


def sparse_to_numpy(table: SparseTable) -> dict:
    """The port's table as a global JAX-layout ``state_dict`` (collective
    under a group)."""
    return table.state_dict()


def tree_from_numpy(tree, device: DeviceLike = None):
    """A nested dict/list of numpy arrays (the JAX package's params via
    ``jax.tree.map(np.asarray, ...)`` or plain ``np.asarray`` leaves) as the
    port's tree of tensors on ``device`` (the card by default). Any
    nesting carries: the MoE LM's ``blk["moe"]`` dicts too."""
    device = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device), tree)


def shard_from_numpy(tree, specs, index: int, n: int,
                     device: DeviceLike = None):
    """Shard ``index`` of ``n`` of every leaf of a numpy params tree, cut
    per ``specs`` (``parallel/partition.py:shard_params``) on the host and
    moved to ``device``: only the shard reaches the device."""
    device = resolve_device(device)
    host = tree_map(lambda x: torch.as_tensor(np.array(x)), tree)
    return tree_map(lambda x: x.contiguous().to(device),
                    shard_params(host, specs, index, n))


def _refit(vec, table: DenseTable) -> np.ndarray:
    """A JAX table's padded 1-D leaf (params or a params-length moment)
    refitted to ``table``'s padding: the same first ``num_keys`` entries,
    zeros after (padding keys never move)."""
    vec = np.asarray(vec)
    out = np.zeros((table.padded,), vec.dtype)
    out[: table.num_keys] = vec[: table.num_keys]
    return out


def load_dense(table: DenseTable, params, opt_leaves, *,
               refit: bool = False) -> None:
    """Load the JAX table's padded flat params and its opt-state leaves
    (``jax.tree.leaves(opt_state)``, in that order), global; each rank
    keeps its shard. bfloat16 leaves are read bit for bit. A state padded
    otherwise than ``table`` is refused, unless ``refit``: a JAX table on
    a mesh of another size than this table's group pads its flat vector
    otherwise, so each params-length leaf is then refitted (0-d leaves
    carry as they are), and a per-block leaf (adam8's scales), which does
    not refit, is refused."""
    params = np.asarray(params)
    leaves = [np.asarray(x) for x in opt_leaves]
    if refit and params.shape != (table.padded,):
        padded = params.shape[0]
        for i, x in enumerate(leaves):
            if x.ndim and x.shape[0] != padded:
                raise ValueError(f"opt leaf of shape {x.shape} is not "
                                 f"params-length ({padded}): it does not "
                                 "carry across paddings")
            if x.ndim:
                leaves[i] = _refit(x, table)
        params = _refit(params, table)
    table.load_state_dict({"params": params, "opt_state": leaves})


def load_ssp(trainer, flat, clock: int = 0) -> None:
    """Carry a JAX ``SSPTrainer``'s replica (``state_dict()["flat"]``, the
    raveled params) and clock into the port's ``SSPTrainer``."""
    trainer.load_state_dict({"flat": np.asarray(flat),
                             "clock": np.asarray(clock)})


def load_cssp(trainer, params, opt_leaves, base=None, residual=None) -> None:
    """Carry a JAX ``CollectiveSSP``'s state into the port's: its table's
    padded params and opt leaves (``jax.tree.leaves(opt_state)``), its
    sync base (``_base``; the params when omitted) and, on a compressed
    wire, its error-feedback residual; each refitted to the port table's
    padding."""
    t = trainer.table
    load_dense(t, params, opt_leaves, refit=True)
    trainer._base = torch.as_tensor(_refit(
        params if base is None else base, t)).to(t.params)
    if residual is not None:
        trainer._residual = torch.as_tensor(_refit(residual, t)).to(t.params)


def load_cssp_ps(trainer, dense: dict, sparse: dict,
                 dense_bases: dict = None, sparse_bases: dict = None) -> None:
    """Carry a JAX ``CollectiveSSPPS``'s tables and sync bases into the
    port's: ``dense`` maps a table name to ``(params, opt_leaves)``,
    ``sparse`` to its ``state_dict()``; the bases (``_dense_base``: name ->
    padded params; ``_sparse_base``: name -> {leaf name -> rows}) default
    to the loaded state."""
    for name, (params, opt) in dense.items():
        t = trainer.dense[name]
        load_dense(t, params, opt, refit=True)
        base = (dense_bases or {}).get(name)
        trainer._dense_base[name] = (t.params.clone() if base is None else
                                     torch.as_tensor(_refit(base, t))
                                     .to(t.params))
    for name, state in sparse.items():
        t = trainer.sparse[name]
        load_sparse(t, state)
        base = (sparse_bases or {}).get(name)
        trainer._sparse_base[name] = {
            ln: (leaf.clone() if base is None else
                 torch.as_tensor(np.asarray(base[ln])).to(leaf))
            for ln, leaf in trainer._leaves(t)}


def dense_to_numpy(table: DenseTable) -> tuple[np.ndarray, list]:
    """``(params, opt_leaves)``, global, in the JAX package's layout and
    leaf order, bfloat16 leaves as their uint16 bit patterns (collective
    under a group)."""
    state = table.state_dict()
    return state["params"], state["opt_state"]
