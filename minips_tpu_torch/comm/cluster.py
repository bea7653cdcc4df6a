"""Multi-host bootstrap — the port of ``minips_tpu/comm/cluster.py``: a
``torch.distributed`` process group over every launched process.

The JAX package joins its processes into one JAX runtime with
``jax.distributed.initialize``; the port joins them into the default
``torch.distributed`` process group, and the cross-process data plane is
that group's collectives. The clock gossip and the heartbeats keep the
control bus (``comm/bus.py``), as in the JAX package.

The launcher (``launch.py``) exports ``MINIPS_COORDINATOR`` (rank 0's
``host:port``) and ``MINIPS_PROC_ID`` / ``MINIPS_NUM_PROCS`` for every
rank, so a worker that calls :func:`initialize` with no arguments joins
the job it was spawned into. Without them (no launcher, or ``--n 1``)
everything is a no-op on one process. PyTorch's own environment
(``MASTER_ADDR``/``MASTER_PORT`` with ``RANK``/``WORLD_SIZE``, as
``torchrun`` sets it) takes the place of JAX's ``JAX_COORDINATOR_ADDRESS``:
it passes through to ``init_method="env://"``, which resolves rank and
world size itself.

The backend (:func:`sync_backend`) is NCCL when every process on this
host holds a card of its own, and gloo otherwise: on the CPU
(``MINIPS_FORCE_CPU``) and where processes share a card, which NCCL
refuses. It is chosen from the launch layout before the group exists and
never changes after an error. A gloo group's collectives run on host
tensors: :func:`to_wire` and :func:`from_wire` stage a card's tensor
through pinned host memory and back.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device


def sync_backend() -> str:
    """``"nccl"`` when each process of this host has a card of its own
    (``MINIPS_LOCAL_PROCS`` at most the visible cards), else ``"gloo"``:
    the CPU under ``MINIPS_FORCE_CPU`` or without CUDA, and processes
    that share a card."""
    if os.environ.get("MINIPS_FORCE_CPU") or not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("MINIPS_LOCAL_PROCS", "1"))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


# how long a rank waits at the group's rendezvous and in a collective
INIT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the cluster: explicit arguments, else the launcher's
    ``MINIPS_*`` environment, else PyTorch's ``MASTER_ADDR`` (passed
    through as ``env://``); one process when none is present. Returns
    True iff a multi-process group was initialized. Under NCCL the
    process's card (``MINIPS_LOCAL_RANK`` mod the card count) becomes
    the current device first."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("MINIPS_COORDINATOR")
    if num_processes is None and "MINIPS_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["MINIPS_NUM_PROCS"])
    if process_id is None and "MINIPS_PROC_ID" in os.environ:
        process_id = int(os.environ["MINIPS_PROC_ID"])
    standard = coordinator_address is None and "MASTER_ADDR" in os.environ
    if coordinator_address is None and not standard:
        return False  # single-process (no launcher, no torch cluster env)
    if num_processes is not None and num_processes <= 1:
        return False  # launcher run with --n 1
    backend = sync_backend()
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("MINIPS_LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    # rank/world may still be None under the standard env: env:// reads
    # RANK/WORLD_SIZE itself rather than degrading to N single processes
    dist.init_process_group(
        backend,
        init_method=("env://" if standard
                     else f"tcp://{coordinator_address}"),
        rank=-1 if process_id is None else process_id,
        world_size=-1 if num_processes is None else num_processes,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kw)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The group's backend, ``None`` on one process."""
    return dist.get_backend() if dist.is_initialized() else None


def barrier(name: str = "minips_barrier", timeout_s: int = 120) -> None:
    """Cluster-wide barrier (reference Engine::Barrier, SURVEY.md §3.4).
    Under gloo a rank that never arrives raises after ``timeout_s``
    (naming it) instead of hanging; NCCL's barrier is the group's."""
    if process_count() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def shutdown() -> None:
    """Leave the cluster coordinated: barrier, then destroy the group, so
    that no rank's exit races a peer still inside a collective. Call it
    as the last cluster op of every multi-process job; a no-op on one
    process."""
    if process_count() == 1:
        return
    barrier("minips_shutdown")
    dist.destroy_process_group()


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of the group is given: ``x`` itself under
    NCCL (or on the CPU), a pinned host copy of a card's tensor under
    gloo."""
    if x.device.type == "cuda" and backend() == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x


def from_wire(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A collective's result back on ``device``."""
    return x if x.device == device else x.to(device)


def global_batch(batch: dict, device: DeviceLike = None) -> dict:
    """This process's part of the global batch (the rows, or the sequence
    slice, it loaded) as tensors on ``device``: each process keeps its own
    slice, as each host feeds its devices in the JAX package; nothing is
    gathered. On one process that is the whole batch."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev)
            for k, v in batch.items()}


def host_copy(x: torch.Tensor, sharded: bool = False) -> np.ndarray:
    """Full host value of ``x``: ``x`` itself when every process holds it
    whole, else (``sharded``: each process holds its slice along dim 0)
    the slices gathered in rank order — a collective that every process
    calls on the same tensor."""
    if not sharded or process_count() == 1:
        return x.detach().cpu().numpy()
    w = to_wire(x.detach().contiguous())
    parts = [torch.empty_like(w) for _ in range(process_count())]
    dist.all_gather(parts, w)
    return torch.cat([p.cpu() for p in parts]).numpy()
