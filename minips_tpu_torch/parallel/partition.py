"""Partitioners — numpy copies of ``RangePartitioner``,
``HashPartitioner`` and ``BlockRouter`` from
``minips_tpu/parallel/partition.py`` (the port imports nothing of the JAX
package, whose ``__init__`` pulls in JAX) — and :func:`shard_params`, the
port's counterpart of ``device_put`` with a ``NamedSharding``.

- :class:`RangePartitioner`: contiguous ranges (the default);
- :class:`HashPartitioner`: the reference's hash partition mode
  (modulo-interleave), same interface;
- :class:`BlockRouter`: the epoch-versioned ``block -> owner`` overlay
  over a base :class:`RangePartitioner` that the multi-process sharded PS
  (``train/sharded_ps.py``) routes every key through.

A table of ``n`` keys padded to ``P`` is laid out as ``shards`` contiguous
ranges of ``P/shards`` keys, shard ``r`` on rank ``r`` of the table's
process group. ``P`` is the JAX table's at the same shard count (adam8's
block alignment included), so the two packages exchange flat state
unchanged at the same ``n``; at another ``n`` the padding may differ.
"""

from __future__ import annotations

import threading

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


class HashPartitioner:
    """The reference's hash-partition mode (MiniPs supports hash alongside
    range), behind the same interface: owner = ``key % num_shards`` — the
    classic modulo-interleave, which is what the reference's hash mapper
    degenerates to for integer keys. Adjacent keys land on DIFFERENT
    owners, so a contiguous hot key range spreads across every shard for
    free — the static answer to skew the rebalancer solves dynamically
    for range partitions (PARITY.md "static vs dynamic partition").

    Trade-off vs range: there is no contiguous-range fast path (a dense
    ``[lo, hi)`` span touches every shard), which is why the sharded PS
    keeps range as its default layout.
    """

    def __init__(self, num_keys: int, num_shards: int, align: int = 1):
        if align < 1:
            raise ValueError(f"align must be >= 1, got {align}")
        self.num_keys = int(num_keys)
        self.num_shards = int(num_shards)
        self.padded = padded_size(self.num_keys, self.num_shards * align)
        self.shard_size = self.padded // self.num_shards

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(keys) % self.num_shards

    def split(self, keys: np.ndarray) -> list[np.ndarray]:
        """``Gen(keys) -> per-server slices``, order preserved per slice."""
        keys = np.asarray(keys)
        owners = self.shard_of(keys)
        return [keys[owners == s] for s in range(self.num_shards)]

    def local_offset(self, keys: np.ndarray) -> np.ndarray:
        """Slot within the owner shard: interleaved keys pack densely
        (key = offset * num_shards + owner round-trips exactly)."""
        return np.asarray(keys) // self.num_shards


class BlockRouter:
    """Epoch-versioned block→owner overlay over a RangePartitioner.

    The base partition cuts the padded key space into ``num_shards``
    contiguous home ranges; this router additionally cuts every home
    range into fixed key BLOCKS (``block_size`` keys, the last block of
    a shard possibly short) and keeps an overlay ``{block_id: owner}``
    holding only blocks that currently live AWAY from their home shard.
    Routing = home owner unless the key's block is in the overlay.

    The overlay is replaced wholesale by :meth:`apply` under a
    monotonically increasing EPOCH — duplicated/reordered table updates
    are harmless (older epochs are ignored), and the epoch is what the
    sharded PS stamps on wire frames so a stale client is detectable.
    Reads are lock-free (the overlay dict reference is swapped
    atomically); a reader racing an apply() routes by the OLD table for
    one op, which is exactly the stale-routing case the migration
    protocol's forward/refuse fencing handles anyway.
    """

    def __init__(self, part: RangePartitioner, block_size: int = 0):
        if block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = auto)")
        self.part = part
        if block_size == 0:  # auto: ~128 blocks per shard, at least 1 key
            block_size = max(1, part.shard_size // 128)
        self.block_size = min(int(block_size), part.shard_size)
        # blocks are cut PER SHARD so a block never straddles two home
        # ranges (shard_size need not divide by block_size)
        self.bps = -(-part.shard_size // self.block_size)
        self.num_blocks = self.bps * part.num_shards
        self.epoch = 0
        self._overlay: dict[int, int] = {}
        self._owner_arr: "np.ndarray | None" = None  # memoized per epoch
        self._lock = threading.Lock()

    # ------------------------------------------------------------- routing
    def blocks_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        shard = keys // self.part.shard_size
        return shard * self.bps + (keys % self.part.shard_size) \
            // self.block_size

    def home_of(self, block: int) -> int:
        return int(block) // self.bps

    def block_span(self, block: int) -> tuple[int, int]:
        """Global ``(lo, length)`` key range of ``block`` (the last block
        of each shard may be short)."""
        b = int(block)
        shard, loc = divmod(b, self.bps)
        lo = shard * self.part.shard_size + loc * self.block_size
        length = min(self.block_size,
                     self.part.shard_size - loc * self.block_size)
        return lo, length

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Owner of each key under the CURRENT table — the base range map
        with overlay blocks rerouted. Empty overlay = the base partition
        exactly (and near the base partition's cost)."""
        return self.shard_of_with(keys, self._overlay)

    def shard_of_with(self, keys: np.ndarray,
                      overlay: dict[int, int]) -> np.ndarray:
        """:meth:`shard_of` under an EXPLICIT overlay — the psE re-route
        path computes destinations from a refusal's table without
        adopting it (adoption is a clock-boundary event; a pull leg
        must make progress before one)."""
        keys = np.asarray(keys)
        base = keys // self.part.shard_size
        if not overlay:
            return base
        b = self.blocks_of(keys)
        ub, inv = np.unique(b, return_inverse=True)
        mapped = np.fromiter((overlay.get(int(x), -1) for x in ub),
                             np.int64, count=ub.size)[inv]
        return np.where(mapped >= 0, mapped, base)

    def split(self, keys: np.ndarray) -> list[np.ndarray]:
        keys = np.asarray(keys)
        owners = self.shard_of(keys)
        return [keys[owners == s] for s in range(self.part.num_shards)]

    # ----------------------------------------------------------- the table
    def table(self) -> tuple[int, dict[int, int]]:
        """Snapshot ``(epoch, overlay)`` — the routing table wire frames
        carry (psE refusals, rbP plans)."""
        with self._lock:
            return self.epoch, dict(self._overlay)

    def apply(self, epoch: int, overlay: dict[int, int]
              ) -> "dict[int, int] | None":
        """Adopt a FULL overlay table stamped ``epoch``. Returns the
        PREVIOUS overlay when adopted (callers diff old vs new to find
        moved blocks), None when ``epoch`` is not newer (duplicate or
        reordered update — ignored, adoption is idempotent)."""
        overlay = {int(b): int(o) for b, o in overlay.items()}
        for b, o in overlay.items():
            if not 0 <= b < self.num_blocks \
                    or not 0 <= o < self.part.num_shards:
                raise ValueError(f"overlay entry {b}->{o} out of range")
            if o == self.home_of(b):
                raise ValueError(
                    f"overlay maps block {b} to its home shard {o} "
                    "(home blocks must be absent from the overlay)")
        with self._lock:
            if epoch <= self.epoch:
                return None
            prev, self._overlay = self._overlay, overlay
            self.epoch = int(epoch)
            self._owner_arr = None
            return prev

    def owner_of_blocks(self) -> np.ndarray:
        """``[num_blocks]`` current owner per block (memoized per epoch)
        — the heat reporter's ownership mask."""
        with self._lock:
            if self._owner_arr is None:
                arr = np.arange(self.num_blocks, dtype=np.int64) // self.bps
                for b, o in self._overlay.items():
                    arr[b] = o
                self._owner_arr = arr
            return self._owner_arr


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
