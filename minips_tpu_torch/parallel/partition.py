"""Range partitioner — a numpy copy of ``RangePartitioner`` from
``minips_tpu/parallel/partition.py`` (the port imports nothing of the JAX
package, whose ``__init__`` pulls in JAX) — and :func:`shard_params`, the
port's counterpart of ``device_put`` with a ``NamedSharding``.

A table of ``n`` keys padded to ``P`` is laid out as ``shards`` contiguous
ranges of ``P/shards`` keys, shard ``r`` on rank ``r`` of the table's
process group. ``P`` is the JAX table's at the same shard count (adam8's
block alignment included), so the two packages exchange flat state
unchanged at the same ``n``; at another ``n`` the padding may differ.
"""

from __future__ import annotations

import numpy as np

from minips_tpu_torch.parallel.mesh import padded_size
from minips_tpu_torch.utils.tree import PyTree, tree_leaves, tree_rebuild


class RangePartitioner:
    def __init__(self, num_keys: int, num_shards: int, align: int = 1):
        """``align > 1`` pads each SHARD to a multiple of ``align`` keys —
        for consumers whose per-shard state has block granularity. Padding
        keys are zeros and stay zeros; only the pad fraction changes."""
        if align < 1:
            raise ValueError(f"align must be >= 1, got {align}")
        self.num_keys = int(num_keys)
        self.num_shards = int(num_shards)
        self.padded = padded_size(self.num_keys, self.num_shards * align)
        self.shard_size = self.padded // self.num_shards

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Owner shard id for each key (contiguous ranges)."""
        return np.asarray(keys) // self.shard_size

    def split(self, keys: np.ndarray) -> list[np.ndarray]:
        """Group keys by owner, preserving order within each slice."""
        keys = np.asarray(keys)
        owners = self.shard_of(keys)
        return [keys[owners == s] for s in range(self.num_shards)]

    def local_offset(self, keys: np.ndarray) -> np.ndarray:
        """Offset of each key within its owner shard."""
        return np.asarray(keys) % self.shard_size


def shard_params(params: PyTree, specs: PyTree, rank: int, n: int) -> PyTree:
    """This rank's shard of every leaf of ``params``: ``specs`` is a tree of
    the same structure whose leaves are the dim each leaf is sharded on
    over a group of ``n`` ranks, or None (replicated: the leaf itself).
    A sharded dim is cut into n equal contiguous pieces and rank ``rank``
    keeps piece ``rank`` (a view), as a mesh axis places a
    ``PartitionSpec``'s shards."""
    dims = tree_leaves(specs)
    leaves = tree_leaves(params)
    if len(dims) != len(leaves):
        raise ValueError(f"specs have {len(dims)} leaves, params "
                         f"{len(leaves)}")
    out = []
    for x, dim in zip(leaves, dims):
        if dim is not None:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf "
                                 f"does not split {n} ways")
            x = x.chunk(n, dim=dim)[rank]
        out.append(x)
    return tree_rebuild(params, iter(out))
