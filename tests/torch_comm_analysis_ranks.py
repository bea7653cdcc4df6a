"""Rank bodies for ``tests/test_torch_comm_analysis.py`` (and
``chip_smoke.py --ranks N``): each profiles one piece of the port's
collective traffic on its rank of a ``run_ranks`` group and returns what
``utils/comm_analysis.py`` read from the capture.

Module-level functions, so that ``parallel/mesh.py:run_ranks`` can pickle
them into its spawned ranks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DIM = 32


def sparse_table_traffic(group, dev, slots_list, batches, root) -> dict:
    """For each table size and batch: one profiled ``pull`` and one
    profiled ``push`` of this rank's seeded keys through the range-sharded
    ``SparseTable`` (one table a size), after an unprofiled warm-up pull.
    Returns ``{"pull"|"push": {(slots, batch): [op, ...]}}``, each op as
    ``(kind, bytes, dims)``."""
    from minips_tpu_torch.parallel.mesh import world
    from minips_tpu_torch.tables.sparse import SparseTable
    from minips_tpu_torch.utils.comm_analysis import collective_ops
    from minips_tpu_torch.utils.profiling import profile_trace

    rank, n = world(group)
    out: dict = {"pull": {}, "push": {}}
    for slots in slots_list:
        t = SparseTable(slots, DIM, updater="adagrad", group=group,
                        device=dev)
        for batch in batches:
            rng = np.random.default_rng(1000 * rank + batch)
            keys = torch.as_tensor(rng.integers(0, 1 << 30, size=batch),
                                   device=dev)
            grads = torch.ones(batch, DIM, device=dev)
            t.pull(keys)
            for leg in ("pull", "push"):
                d = os.path.join(root, f"{leg}-{slots}-{batch}-r{rank}")
                with profile_trace(d, device=dev):
                    if leg == "pull":
                        t.pull(keys)
                    else:
                        t.push(keys, grads)
                out[leg][(slots, batch)] = [
                    (o.kind, o.bytes, o.dims)
                    for o in collective_ops(d, world=n)]
    return out


def cssp_sync_traffic(group, dev, comm, length, root) -> dict:
    """One ``CollectiveSSP`` local step, then its sync (``finalize``)
    under the profiler on the ``comm`` wire. Returns the sync's observed
    ops beside ``SyncPlane.plan``'s record."""
    from minips_tpu_torch.models import lr as tlr
    from minips_tpu_torch.parallel.mesh import world
    from minips_tpu_torch.train.ssp_spmd import CollectiveSSP
    from minips_tpu_torch.utils.comm_analysis import traffic_report
    from minips_tpu_torch.utils.profiling import profile_trace

    rank, n = world(group)
    tr = CollectiveSSP(tlr.init(length, device=dev), tlr.grad_fn_dense,
                       staleness=float("inf"), sync_every=1 << 30,
                       sync_comm=comm, name=f"c{comm}", device=dev)
    rng = np.random.default_rng(rank)
    x = rng.normal(size=(16, length)).astype(np.float32)
    tr.step({"x": x, "y": (x.sum(axis=1) > 0).astype(np.float32)})
    d = os.path.join(root, f"sync-{comm}-r{rank}")
    with profile_trace(d, device=dev):
        tr.finalize()
    return {"observed": traffic_report(d, world=n),
            "plan": tr.sync_record(), "rounds": tr.sync_rounds,
            "launches": tr.plane.launches, "bytes": tr.plane.bytes}
