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
  the collectives the tables use, :func:`broadcast`,
  :func:`broadcast_object` and :func:`barrier` those of the Engine and the
  checkpointer; each is the identity under ``None``. :func:`shard_batch`
  takes a rank's rows of a global batch.
- :func:`ppermute`, :func:`all_to_all_axes`, :func:`reduce_from_group`,
  :func:`copy_to_group` and :func:`pmean` are the collectives of the
  parallel schedules (ring and all-to-all attention, GPipe, tensor and
  expert parallelism), each with its own backward; :func:`make_groups`
  splits the world into the ``(data, model)`` groups of a 2-D mesh.

**Gradients through the collectives.** JAX takes every gradient outside
``shard_map``, whose transpose places the conjugate collectives; here
autograd runs on each rank, so each collective carries its backward, in
the convention of shard_map's replication tracking: a value that is the
same on every rank of a group (replicated) has one cotangent, held whole
by every rank, not a share of one. So the psum that makes a replicated
value (:func:`reduce_from_group`) passes its cotangent through unchanged,
and a replicated value entering a computation that differs between ranks
(:func:`copy_to_group`) sums the ranks' cotangents. A parameter
replicated over a group but used in a computation that differs between
its ranks (every leaf over the data axis, which shards the batch) gets a
share of its gradient on each rank: the caller sums those over the group,
as shard_map's transpose of the implicit broadcast does.
``torch.distributed.nn.functional.all_reduce`` sums the gradient as well
and would count every replicated leaf once per rank.

Every rank runs the same collectives in the same order, backward
included: a schedule keeps its autograd graph the same on every rank
(``torch.where`` on the rank where JAX uses ``jnp.where``), so that each
collective's backward runs on every rank or on none.

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


def group_device(group: Group) -> torch.device:
    """The device of this rank of ``group``: the CPU under gloo, the
    rank's current card under NCCL (``init_group`` sets it); the card
    under ``None``."""
    if group is not None and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return resolve_device(None)


def shard_batch(batch, group: Group, device: DeviceLike = None):
    """This rank's rows of a global batch (a dict of numpy arrays or
    tensors, nested or not), on ``device``: rows ``[r*B/n, (r+1)*B/n)`` of
    every leaf, the whole batch under ``None``. B must divide by the group
    size."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group, device) for k, v in batch.items()}
    x = batch if torch.is_tensor(batch) else torch.as_tensor(batch)
    rank, n = world(group)
    if n > 1:
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch dim {b} must divide by the group "
                             f"size {n}")
        x = x[rank * (b // n):(rank + 1) * (b // n)]
    return x.to(resolve_device(device))


# -------------------------------------------------------------- collectives
def broadcast(x: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, written into ``x`` (which
    every other rank allocates at the same shape and dtype) and returned;
    ``x`` itself under ``None``."""
    if group is None:
        return x
    dist.broadcast(x, src=_global(group, src), group=group)
    return x


def broadcast_object(obj: Any, src: int, group: Group) -> Any:
    """Group rank ``src``'s picklable ``obj`` on every rank (the other
    ranks pass anything); ``obj`` itself on a world of one. For results at
    the end of a run, not for tensors on the hot path."""
    if world(group)[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_global(group, src), group=group)
    return box[0]


def barrier(group: Group) -> None:
    """Every rank of ``group`` waits here for the others; nothing under
    ``None``."""
    if group is not None:
        dist.barrier(group)


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


# ------------------------------------------- collectives with a backward
def axis_index(group: Group) -> int:
    """This rank's index in ``group`` (``jax.lax.axis_index``)."""
    return world(group)[0]


def _global(group, i: int) -> int:
    return i if group is None else dist.get_global_rank(group, i)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to rank ``r + shift`` and receive from ``r - shift``
    (mod n), both posted at once: at n = 2 the two peers are one rank,
    which a blocking send would deadlock."""
    r, n = world(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, _global(group, (r - shift) % n),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group: Group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` sends ``x`` to rank ``(i + shift) mod n`` and returns what
    rank ``(i - shift) mod n`` sent: ``jax.lax.ppermute`` with the
    permutation ``[(i, (i + shift) % n)]``. The backward sends the gradient
    the other way. On a group of one the rotation is ``x`` itself."""
    if world(group)[1] == 1:
        return x
    return _Ppermute.apply(x, group, shift)


def _exchange(x, group, split_axis: int, concat_axis: int, tiled: bool):
    n = world(group)[1]
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        parts = x.chunk(n, dim=split_axis)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all (untiled): dim {split_axis} of "
                             f"{tuple(x.shape)} must be the group size {n}")
        parts = x.unbind(split_axis)
    got = all_to_all(torch.stack(parts), group).unbind(0)  # by source rank
    return (torch.cat(got, dim=concat_axis) if tiled
            else torch.stack(got, dim=concat_axis))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, split_axis, concat_axis, tiled)
        return _exchange(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        # the inverse exchange: split where the forward concatenated
        return (_exchange(g, group, concat_axis, split_axis, tiled),
                None, None, None, None)


def all_to_all_axes(x: torch.Tensor, group: Group, split_axis: int,
                    concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled)``:
    ``x`` splits along ``split_axis`` into n parts, part ``j`` goes to rank
    ``j``, and the parts received are joined along ``concat_axis`` in
    source-rank order. Tiled, the parts are chunks of ``split_axis`` and
    join by concatenation; untiled, ``split_axis`` has size n and is
    removed, and the parts stack into a new axis at ``concat_axis``. The
    backward is the inverse exchange. The identity on a group of one
    (untiled: the size-1 axis moved)."""
    if world(group)[1] == 1:
        return x if tiled else x.movedim(split_axis, concat_axis)
    return _AllToAll.apply(x, group, split_axis, concat_axis, tiled)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group's ranks, a replicated value: all-reduce
    forward, the identity backward (the psum after a row-parallel matmul,
    and GPipe's closing broadcast)."""
    if world(group)[1] == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A replicated value entering a computation that differs between the
    group's ranks: the identity forward, the all-reduce of its gradient
    backward (the activation that enters a column-parallel matmul)."""
    if world(group)[1] == 1:
        return x
    return _CopyToGroup.apply(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``jax.lax.pmean``: the mean over the group's ranks, replicated; its
    backward hands each rank the cotangent over n."""
    return reduce_from_group(x, group) / world(group)[1]


def make_groups(n_data: int, model_size: int) -> tuple:
    """This rank's ``(data_group, model_group)`` on a ``(n_data,
    model_size)`` mesh of the default group's ranks, ``rank = d·model_size
    + m`` as ``make_mesh`` reshapes its devices: the data group holds the
    ranks of one ``m``, the model group those of one ``d``. Every rank
    calls it together (``new_group`` is collective over every subgroup, in
    one order)."""
    w = dist.get_world_size()
    if n_data * model_size != w:
        raise ValueError(f"a {n_data} x {model_size} mesh needs "
                         f"{n_data * model_size} ranks, the group has {w}")
    d, m = divmod(dist.get_rank(), model_size)
    data = [dist.new_group([i * model_size + j for i in range(n_data)])
            for j in range(model_size)]
    model = [dist.new_group([i * model_size + j for j in range(model_size)])
             for i in range(n_data)]
    return data[m], model[d]
