"""Data-plane selection for the sharded PS — the part of
``minips_tpu/train/mesh_plane.py`` that the bus-backed trainer
(``train/sharded_ps.py``) and its apps read: :func:`resolve_plane` and
:func:`resolve_deposit`.

The in-mesh collective plane itself (``MeshTable``, ``MeshPlane``,
``MeshRank`` and the hierarchical push tree's ``MeshAggregator``: server
state sharded over the devices, push as a reduce-scatter, pull as an
all-gather) maps to NCCL collectives over a ``torch.distributed`` group
and is not ported yet (ROADMAP.md queue 1 item 15). ``plane="mesh"`` is
refused by ``ShardedPSTrainer``, ``MINIPS_HIER`` ``agg=mesh`` by the
trainer where it arms hier.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["resolve_plane", "resolve_deposit"]


def resolve_plane(plane: Optional[str]) -> str:
    """The data-plane selection rule every entrypoint shares (same
    explicit-wins-over-env convention as ``make_bus``): an explicit
    ``plane`` wins, else ``MINIPS_MESH`` (any value but ''/'0') selects
    the in-mesh collective plane, else the host wire."""
    if plane:
        if plane not in ("wire", "mesh"):
            raise ValueError(f"plane must be 'wire' or 'mesh', "
                             f"got {plane!r}")
        return plane
    env = os.environ.get("MINIPS_MESH", "").strip()
    return "mesh" if env not in ("", "0") else "wire"


def resolve_deposit(deposit: Optional[str] = None) -> str:
    """Deposit-buffer selection, same explicit-wins-over-env rule:
    ``dense`` stages pushes in the pre-stacked ``[n, padded, dim]``
    host buffers; ``sparse`` stages COO (keys, rows) streams and
    densifies ON DEVICE with a segment-sum scatter inside the wave —
    an embedding-table-sized key space with a small touched set stops
    materializing host buffers that scale with ``num_rows``.
    ``MINIPS_MESH_SPARSE`` (any value but ''/'0') selects sparse."""
    if deposit:
        if deposit not in ("dense", "sparse"):
            raise ValueError(f"mesh deposit must be 'dense' or "
                             f"'sparse', got {deposit!r}")
        return deposit
    env = os.environ.get("MINIPS_MESH_SPARSE", "").strip()
    return "sparse" if env not in ("", "0") else "dense"
