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
    port's tree of tensors on ``device`` (the card by default)."""
    device = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device), tree)


def load_dense(table: DenseTable, params, opt_leaves) -> None:
    """Load the JAX table's padded flat params and its opt-state leaves
    (``jax.tree.leaves(opt_state)``, in that order), global; each rank
    keeps its shard. bfloat16 leaves are read bit for bit."""
    table.load_state_dict({"params": np.asarray(params),
                           "opt_state": [np.asarray(x) for x in opt_leaves]})


def dense_to_numpy(table: DenseTable) -> tuple[np.ndarray, list]:
    """``(params, opt_leaves)``, global, in the JAX package's layout and
    leaf order, bfloat16 leaves as their uint16 bit patterns (collective
    under a group)."""
    state = table.state_dict()
    return state["params"], state["opt_state"]
