"""Devices and process groups for the PyTorch port — the counterpart of
``minips_tpu/parallel/mesh.py``.

The JAX package builds a ``(data, model)`` device mesh in one process and
lets GSPMD place every table shard. The port runs one process per device
instead, joined by a ``torch.distributed`` process group: rank ``r`` of a
group of ``n`` owns the ``r``-th of ``n`` contiguous range shards of every
table, as device ``r`` of the JAX mesh's ``data`` axis does. Tables and
steps take the group as ``group=``; ``group=None`` is a world of one
device, which runs no collective at all.

- :func:`init_group` brings a group up from an explicit ``FileStore``:
  ``nccl`` on the card, ``gloo`` on the CPU, one device per rank
  (``cuda:<rank>``).
- :func:`run_ranks` runs a function on ``n`` spawned ranks and returns
  what each returned: the port's stand-in for JAX's one-process
  ``n``-device mesh, used by the tests (gloo on the CPU) and by
  ``chip_smoke.py`` (NCCL).
- :func:`all_gather`, :func:`all_to_all` and :func:`all_reduce_sum` are
  the collectives the tables use; each is the identity under ``None``.

Every entry point of the port takes ``device=``. Left out, it resolves to
the card, and the call raises when CUDA is absent: nothing quietly runs on
the CPU. Callers that mean the CPU (the parity tests) say so.
"""

from __future__ import annotations

import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"

DeviceLike = Union[str, torch.device, None]
Group = Optional[dist.ProcessGroup]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device is refused when CUDA is not
    available, so a missing card is an error, never a CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "minips_tpu_torch runs on a CUDA device by default and CUDA is "
            "not available here; pass device='cpu' to run the plain CPU "
            "versions explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def padded_size(n: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= n (range-partition padding)."""
    return shards * math.ceil(max(n, 1) / shards)


# ------------------------------------------------------------ process group
def world(group: Group) -> tuple[int, int]:
    """``(rank, size)`` of ``group``; ``(0, 1)`` for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def init_group(rank: int, world_size: int, store_path: str,
               device: DeviceLike = None) -> tuple[dist.ProcessGroup,
                                                   torch.device]:
    """Join the default process group of ``world_size`` ranks through a
    ``FileStore`` at ``store_path`` (a file every rank names the same and
    that does not exist before the first rank joins). ``device`` is
    ``"cpu"`` (gloo) or a CUDA device; ``None`` gives rank ``r`` the card
    ``cuda:r`` (NCCL). Returns ``(group, device)``."""
    dev = resolve_device(torch.device("cuda", rank) if device is None
                         else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            device_id=dev if dev.type == "cuda" else None)
    return dist.group.WORLD, dev


def _rank_main(rank: int, world_size: int, store_path: str,
               device: DeviceLike, fn: Callable, args: tuple,
               results) -> None:
    try:
        if torch.device(device or "cuda").type == "cpu":
            # n ranks share the host's cores: one thread each
            torch.set_num_threads(1)
        group, dev = init_group(rank, world_size, store_path, device)
        out = fn(group, dev, *args)
        dist.barrier(group)  # no rank leaves while a peer still needs it
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which re-raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world_size: int, *args,
              device: DeviceLike = None, timeout: float = 300.0,
              store_dir: Optional[str] = None) -> list:
    """Run ``fn(group, device, *args)`` on ``world_size`` spawned ranks
    and return the list of what each rank returned, by rank.

    ``fn`` and ``args`` are pickled into fresh interpreters, so ``fn`` is
    a module-level function of a module that the children can import.
    ``device`` as in :func:`init_group` (``"cpu"``: gloo; ``None``: rank
    ``r`` on ``cuda:r``). The group's ``FileStore`` lives in a new
    temporary directory (under ``store_dir`` if given), so concurrent
    calls never share a store and no TCP port is taken.

    A rank that raises ends the call: the others are killed (they would
    wait forever in their next collective) and its traceback is raised
    here as a ``RuntimeError``. After ``timeout`` seconds every rank is
    killed and ``TimeoutError`` raised. No child outlives the call."""
    import multiprocessing as mp

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    if store_dir is not None:
        os.makedirs(store_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, os.path.join(tmp, "store"),
                                   device, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: list = [None] * world_size
        pending = set(range(world_size))
        deadline = time.monotonic() + timeout
        dead_since: dict = {}
        done = False
        try:
            while pending:
                now = time.monotonic()
                if now >= deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"within {timeout} s")
                try:
                    rank, ok, value = results.get(
                        timeout=min(1.0, deadline - now))
                except queue.Empty:
                    # a rank that died before it could report (killed, or
                    # failing at start-up) has sent nothing; its peers would
                    # wait for it until the timeout
                    for r in pending:
                        code = procs[r].exitcode
                        if code is not None and \
                                now - dead_since.setdefault(r, now) > 5.0:
                            raise RuntimeError(
                                f"rank {r} of {world_size} exited with code "
                                f"{code} before returning") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                out[rank] = value
                pending.discard(rank)
            done = True
        finally:
            for p in procs:
                if done:  # every result is read: the ranks are exiting
                    p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return out


# -------------------------------------------------------------- collectives
def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``[*s] -> [n, *s]``: every rank's ``x`` stacked in rank order."""
    if group is None:
        return x[None]
    n = dist.get_world_size(group)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, group: Group,
               send: Optional[Sequence[int]] = None,
               recv: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Exchange along dim 0. Without split sizes ``x`` is ``[n, ...]`` and
    row ``j`` goes to rank ``j``; the result's row ``i`` came from rank
    ``i``. With them, ``send[j]`` leading rows go to rank ``j`` and
    ``recv[i]`` arrive from rank ``i`` (zero-length splits allowed)."""
    if group is None:
        return x
    x = x.contiguous()
    if send is None:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, x, list(recv), list(send), group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor; ``x`` under ``None``)."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out
