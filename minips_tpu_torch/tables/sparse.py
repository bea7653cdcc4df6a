"""SparseTable — the port of ``minips_tpu/tables/sparse.py``.

A fixed-slot embedding matrix ``[num_slots, dim]`` with multiplicative
hashing of unbounded feature ids onto slots. ``pull(keys)`` is a row
gather through the port's hand-written kernel (``ops/gather.py``) at any
D and any N, on the card always; ``push(keys, grads)`` sums duplicate keys
and applies the server-side row updater to the touched rows.

The rows are range-sharded over a process group (``group=``, see
``parallel/mesh.py``): rank ``r`` of ``n`` owns slots ``[r*S/n,
(r+1)*S/n)`` and their optimizer state, as device ``r`` of the JAX table's
``data`` axis does. Each rank pulls and pushes its own keys, as a
KVClientTable does: it hashes them, groups them by owner, and exchanges
the counts and then the owners' local slots with one ``all_to_all`` each;
each owner gathers its rows with the kernel and sends them back with one
more, in the caller's order. A push sends (slot, gradient) pairs to the
owners the same way, and each owner runs the row updater once on the
pairs of every rank, rank by rank: the JAX table's push of every rank's
keys and gradients concatenated. Every rank of the group takes part in
every pull and push, with or without keys. ``group=None`` is one device
holding every row, with no collective.

The hash must be bit-identical to the JAX package's, which computes in
uint32 on keys that reach the device as int32 (x64 off): only the low 32
bits of a key count. torch has no full uint32 arithmetic, so the port
computes in int64 on ``k & 0xFFFFFFFF`` and splits the multiply so that no
product overflows int64 (a plain ``k * M`` can exceed 2^63).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from minips_tpu_torch.ops.gather import gather_rows
from minips_tpu_torch.ops.sparse_update import row_adagrad, row_adam, row_sgd
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group, all_gather,
                                            all_to_all, resolve_device, world)

_HASH_MULT = 2654435761  # Knuth multiplicative hash
_MASK32 = 0xFFFFFFFF


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot change."""
    return t.detach().to("cpu", copy=True).numpy()


def hash_to_slots(keys: torch.Tensor, num_slots: int, salt: int = 0,
                  identity: bool = False) -> torch.Tensor:
    """Hash integer feature ids onto [0, num_slots) as int32 slots:
    ``((k * M) ^ (k >> 16) ^ salt) & (num_slots - 1)`` in uint32
    arithmetic. ``identity=True`` maps key -> key & (num_slots - 1)."""
    if num_slots <= 0 or num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of 2, got {num_slots}")
    if keys.is_floating_point() or keys.is_complex():
        raise TypeError(f"keys must be integers, got {keys.dtype}")
    k = keys.to(torch.int64) & _MASK32
    if identity:
        return (k & (num_slots - 1)).to(torch.int32)
    # (k * M) mod 2^32 with every partial product below 2^49
    lo = k * (_HASH_MULT & 0xFFFF)
    hi = ((k * (_HASH_MULT >> 16)) & 0xFFFF) << 16
    h = ((lo + hi) & _MASK32) ^ (k >> 16) ^ (salt & _MASK32)
    return (h & (num_slots - 1)).to(torch.int32)


def hash_to_slots_np(keys: np.ndarray, num_slots: int, salt: int = 0,
                     identity: bool = False) -> np.ndarray:
    """NumPy copy of the JAX package's host-side twin (uint32 arithmetic,
    int64 result) — the bit-exact reference for :func:`hash_to_slots`."""
    if num_slots <= 0 or num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of 2, got {num_slots}")
    k = np.asarray(keys).astype(np.uint32)
    if identity:
        return (k & np.uint32(num_slots - 1)).astype(np.int64)
    h = (k * np.uint32(_HASH_MULT)) ^ (k >> np.uint32(16)) ^ np.uint32(salt)
    return (h & np.uint32(num_slots - 1)).astype(np.int64)


def collision_stats(keys: np.ndarray, num_slots: int, salt: int = 0,
                    identity: bool = False,
                    max_sample: int = 1 << 20) -> dict:
    """Measured key->slot collision accounting: ``collision_rate`` is the
    fraction of unique keys folded into an already-occupied slot, beside
    ``expected_rate`` for a uniform random hash. Same fields and sampling
    as the JAX package's."""
    k = np.asarray(keys).reshape(-1)
    sampled = k.size > max_sample
    if sampled:
        k = k[np.random.default_rng(0).integers(0, k.size,
                                                size=max_sample)]
    uniq = np.unique(k)
    u = int(uniq.size)
    occupied = int(np.unique(
        hash_to_slots_np(uniq, num_slots, salt, identity)).size)
    s = float(num_slots)
    expected = 0.0 if identity or u == 0 else \
        1.0 - s * (1.0 - (1.0 - 1.0 / s) ** u) / u
    return {
        "unique_keys": u,
        "unique_slots": occupied,
        "num_slots": int(num_slots),
        "collision_rate": round(1.0 - occupied / max(u, 1), 6),
        "expected_rate": round(expected, 6),
        "sampled": sampled,
    }


class Route(NamedTuple):
    """Where one rank's keys go: the result of :meth:`SparseTable.route`.

    ``local`` are the slots this rank serves as an owner, local to its
    shard (int32; under ``group=None`` every slot, in the keys' shape).
    ``order`` lists the caller's key positions grouped by owner, ``send``
    how many keys go to each owner and ``recv`` how many arrive from each
    rank (``None`` under ``group=None``)."""
    shape: tuple
    local: torch.Tensor
    order: Optional[torch.Tensor] = None
    send: Optional[list] = None
    recv: Optional[list] = None


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


class SparseTable:
    """Hashed embedding table with server-side SGD/Adagrad/Adam on push."""

    _OPT_KEYS = {"adagrad": ("accum",), "adam": ("m", "v", "steps"),
                 "sgd": ()}

    def __init__(
        self,
        num_slots: int,
        dim: int,
        *,
        name: str = "sparse0",
        updater: str = "sgd",
        lr: float = 0.05,
        init_scale: float = 0.01,
        adagrad_init: float = 0.1,
        salt: int = 0,
        identity: bool = False,
        seed: int = 0,
        device: DeviceLike = None,
        group: Group = None,
    ):
        """``group``: the process group the rows are sharded over (every
        rank builds the table with the same arguments); ``None`` is one
        device. The weights are drawn whole from ``seed`` on the CPU and
        each rank keeps its range, so a seed gives the same table at any
        group size."""
        if updater not in self._OPT_KEYS:
            raise ValueError(
                "sparse updater must be 'sgd', 'adagrad', or 'adam'")
        if num_slots <= 0 or num_slots & (num_slots - 1):
            raise ValueError(f"num_slots must be a power of 2, got "
                             f"{num_slots}")
        self.name = name
        self.device = resolve_device(device)
        self.group = group
        self.rank, self.num_shards = world(group)
        if num_slots % self.num_shards:
            raise ValueError(f"num_slots {num_slots} must divide by the "
                             f"group size {self.num_shards}")
        self.num_slots = int(num_slots)
        self.shard_rows = self.num_slots // self.num_shards
        self.dim = int(dim)
        self.updater = updater
        self.lr = lr
        self.adagrad_init = adagrad_init
        self.salt = salt
        self.identity = identity

        # drawn on the CPU so that a seed gives the same table on any device
        gen = torch.Generator().manual_seed(seed)
        emb = torch.randn((self.num_slots, self.dim),
                          generator=gen) * init_scale
        self.emb = self._shard(emb).to(self.device)
        self.accum = None
        self.m = self.v = self.steps = None
        shape = (self.shard_rows, self.dim)
        if updater == "adagrad":
            self.accum = torch.full(shape, adagrad_init, device=self.device)
        elif updater == "adam":  # row-wise LAZY adam: moments + per-row t
            self.m = torch.zeros(shape, device=self.device)
            self.v = torch.zeros(shape, device=self.device)
            self.steps = torch.zeros(self.shard_rows, dtype=torch.int32,
                                     device=self.device)

    def _shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global table-shaped tensor."""
        if self.group is None:
            return full
        lo = self.rank * self.shard_rows
        return full[lo:lo + self.shard_rows].clone()

    # --------------------------------------------------- unified opt state
    # (emb,) + opt_state() is the table's full tuple; row_update is the
    # per-push transition both push and PSTrainStep use.
    def opt_state(self) -> tuple:
        return tuple(getattr(self, k) for k in self._OPT_KEYS[self.updater])

    def set_opt_state(self, opt: tuple) -> None:
        for k, x in zip(self._OPT_KEYS[self.updater], opt, strict=True):
            setattr(self, k, x)

    def row_update(self, emb, opt: tuple, slots, grads):
        """(emb', opt') for one push of already-hashed slots; duplicates
        are summed, then updated. Writes the table state in place where
        the row op does (see ``ops/sparse_update.py``)."""
        if self.updater == "sgd":
            return row_sgd(emb, slots, grads, self.lr), ()
        if self.updater == "adagrad":
            (accum,) = opt
            emb, accum = row_adagrad(emb, accum, slots, grads, self.lr)
            return emb, (accum,)
        m, v, steps = opt
        emb, m, v, steps = row_adam(emb, m, v, steps, slots, grads, self.lr)
        return emb, (m, v, steps)

    # ------------------------------------------------------------------ hash
    def slots_of(self, keys) -> torch.Tensor:
        keys = torch.as_tensor(keys, device=self.device)
        return hash_to_slots(keys, self.num_slots, self.salt, self.identity)

    # --------------------------------------------------------------- routing
    def route(self, keys) -> Route:
        """Hash this rank's keys and tell each owner which of its local
        slots this rank wants: one all-to-all of the counts, one of the
        slots (collective; no exchange under ``group=None``)."""
        keys = torch.as_tensor(keys, device=self.device)
        slots = self.slots_of(keys)
        if self.group is None:
            return Route(tuple(keys.shape), slots)
        flat = slots.reshape(-1)
        owner = flat // self.shard_rows
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=self.num_shards)
        recv = all_to_all(counts, self.group)
        send, recv = counts.tolist(), recv.tolist()
        local = all_to_all(flat[order] % self.shard_rows, self.group,
                           send, recv)
        return Route(tuple(keys.shape), local, order, send, recv)

    def gather(self, emb: torch.Tensor, route: Route) -> torch.Tensor:
        """The rows ``route`` asks for, ``[*keys.shape, dim]`` in the
        caller's order: each owner gathers from its shard ``emb`` with the
        row-gather kernel and sends them back (collective)."""
        rows = gather_rows(emb, route.local)
        if self.group is None:
            return rows
        back = all_to_all(rows, self.group, route.recv, route.send)
        out = torch.empty_like(back)
        out[route.order] = back
        return out.view(*route.shape, self.dim)

    def to_owners(self, route: Route, grads: torch.Tensor) -> torch.Tensor:
        """Send each key's gradient row to its owner: ``[len(local),
        dim]`` there, in the order of ``route.local`` (collective)."""
        if self.group is None:
            return grads
        g = grads.reshape(-1, self.dim)[route.order]
        return all_to_all(g, self.group, route.send, route.recv)

    # ------------------------------------------------------------------ pull
    def pull(self, keys) -> torch.Tensor:
        """Gather embedding rows for (hashed) keys: [B] or [B, F] keys ->
        [..., dim] rows, through the row-gather kernel on the card."""
        return self.gather(self.emb, self.route(keys))

    # ------------------------------------------------------------------ push
    def push(self, keys, grads) -> None:
        """Sum grads of duplicate keys and apply the updater to the
        touched rows only (the owners sum every rank's grads)."""
        grads = torch.as_tensor(grads, device=self.device)
        route = self.route(keys)
        self.emb, opt = self.row_update(self.emb, self.opt_state(),
                                        route.local,
                                        self.to_owners(route, grads))
        self.set_opt_state(opt)

    # ------------------------------------------------------------- state I/O
    def _layout(self) -> list:
        """[salt, identity] — salt normalized to 0 on the identity path,
        where the hash never reads it."""
        return [0 if self.identity else self.salt, int(self.identity)]

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        return all_gather(x, self.group).reshape((-1,) + tuple(x.shape[1:]))

    def state_dict(self) -> dict:
        """Host copies of the global table (under a group the shards are
        gathered: every rank calls it together)."""
        out = {"emb": _host(self._global(self.emb)),
               # key->slot layout: a state written under one layout is
               # garbage under another (every row lands at another slot)
               "layout": np.asarray(self._layout(), np.int64)}
        for k in self._OPT_KEYS[self.updater]:
            out[k] = _host(self._global(getattr(self, k)))
        return out

    def load_state_dict(self, state: dict) -> None:
        missing = [k for k in self._OPT_KEYS[self.updater]
                   if k not in state]
        if missing:
            raise ValueError(
                f"state lacks sparse optimizer state {missing} for "
                f"updater {self.updater!r} (written by a different "
                "updater?)")
        want = self._layout()
        if "layout" in state:
            got = np.asarray(state["layout"]).tolist()
            if got != want:
                raise ValueError(
                    f"key->slot layout [salt, identity]={got} does not "
                    f"match this table's {want} — rows would restore to "
                    "different slots")
        elif self.identity or self.salt != 0:
            raise ValueError(
                "state carries no layout record (default hashed layout) "
                f"but this table uses {want} — cannot verify the key->slot "
                "mapping matches")
        for k in ("emb",) + self._OPT_KEYS[self.updater]:
            cur = getattr(self, k)
            new = torch.tensor(np.asarray(state[k]))
            want = (self.num_slots,) + tuple(cur.shape[1:])
            if tuple(new.shape) != want:
                raise ValueError(f"{k} shape {tuple(new.shape)} does not "
                                 f"match the table's {want}")
            setattr(self, k, self._shard(new).to(device=self.device,
                                                 dtype=cur.dtype))
