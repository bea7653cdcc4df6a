"""In-mesh collective data plane for the sharded PS (``MINIPS_MESH=1``) —
the port of ``minips_tpu/train/mesh_plane.py``.

The third data plane next to the zmq/native/shm host wire (comm/bus.py):
instead of routing per-owner key slices over sockets or rings, the whole
gang lives in one process and exchanges owner-split rows with
collectives. It is the only plane whose server state lives on the
accelerator:

- **server state is range-sharded over the devices**: each table's rows
  and its updater state (adagrad accumulator, adam moments and steps)
  are device tensors, owner shard ``j`` on device ``j``, and the updater
  runs on the owner shards;
- **push = reduce-scatter**: each logical rank's dense row-space
  contribution is summed across ranks, leaving every owner its row range;
- **pull = all-gather**: the updated owner shards are reassembled, and
  one device-to-host copy refreshes the plane's read-only pull mirror;
- **BSP/SSP gate the collective, not wire frames**: the plane keeps a
  device-side clock vector (one entry per logical rank); pull admission
  is the shared ``consistency.gate.admits`` predicate over ``min`` of
  that vector — the owner-side park rule of the wire planes;
- **optional quantized tier** (``comm="blk8"``): the reduce leg ships
  blockwise absmax int8 codes and f32 scales and sums the dequantized
  contributions in f32 (``ops/quantized_comm.py``'s codec, shared with
  the compressed host wire), with error feedback: each rank keeps its
  quantization residual, folds it into the next wave, and the last
  ``finalize`` repays it with one exact f32 wave.

**The process model.** One process; the logical ranks are threads, and
``devices=`` maps rank ``r`` to a torch device. The list either names
one device ``n`` times — the collective is then the same sum on that
device, in rank order, and the owner shards are row ranges of one
tensor (how the plane runs on one card, and on the CPU as ``[cpu] * n``)
— or ``n`` distinct CUDA cards, where the reduce-scatter and all-gather
are ``torch.cuda.nccl`` collectives of this one process and the blk8
exchange copies each owner's codes and scales to its card. A list that
mixes the two is refused. Left out, the devices are the visible cards
(``MINIPS_FORCE_CPU``: ``[cpu] * n``), and a missing card raises: no
code carries on on the CPU when a card was asked for.

Semantics against the wire planes (the consistency contract survives
the transport swap):

- Pushes deposit into a per-rank row-space buffer (duplicate keys
  coalesced as the wire's client-side dedup does: per-dim f64 bincount,
  rounded once to f32). An apply wave — reduce-scatter, the updater on
  the owner shards, all-gather — fires when every live rank has a
  deposit, when a depositing rank pulls (read-your-own-writes), and at
  every ``tick``/``finalize``, so a rank's step-k pushes are in the
  shared state before its clock reads k.
- The sum over ranks runs in rank order on one device, as XLA's
  reduce-scatter on the host devices does, so BSP + sgd at float32 is
  bitwise the zmq wire path and the JAX plane (the ``run_bsp_lockstep``
  drill pins it). Over distinct cards NCCL's ring picks its own order.
- Stateful updaters apply one step per wave to each touched row (adam
  stays lazy through a reduced touch mask): two ranks hitting one row in
  one wave sum their gradients before the update — gradient aggregation,
  against the wire's update per frame.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from minips_tpu_torch.consistency.gate import RETIRED_CLOCK, admits
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import window as _ow
from minips_tpu_torch.obs.hist import Log2Histogram, summarize_counts
from minips_tpu_torch.ops.quantized_comm import (HOST_BLOCK,
                                                 _dequantize_blocks,
                                                 _quantize_blocks,
                                                 blockwise_stream_bytes)
from minips_tpu_torch.parallel.mesh import resolve_device, same_device

MESH_AXIS = "shard"
VALID_MESH_COMM = ("float32", "blk8")
# BSP tick-flush grace: how long a ticking rank lets the eager full
# wave fire before solo-flushing its own deposits (see
# MeshPlane._flush_rank_locked) — generous vs a step, invisible vs the
# gate timeout
_BSP_FLUSH_GRACE = 0.05

__all__ = ["MeshPlane", "MeshRank", "MeshTable", "MeshAggregator",
           "resolve_plane", "resolve_deposit", "mesh_devices", "MESH_AXIS",
           "VALID_MESH_COMM"]


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


def mesh_devices(n: int, devices=None) -> list:
    """The device list of an ``n``-slot plane or aggregator: ``devices``
    as torch devices, else ``[cpu] * n`` under ``MINIPS_FORCE_CPU``, else
    the visible CUDA cards (raises without CUDA)."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    if os.environ.get("MINIPS_FORCE_CPU", "").strip() not in ("", "0"):
        return [torch.device("cpu")] * int(n)
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _padded(rows: int, shards: int) -> int:
    return shards * (-(-max(rows, 1) // shards))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy (a fresh array even on the CPU, so a
    mirror never aliases live state)."""
    return t.detach().to("cpu", copy=True).numpy()


def _rank_sum(xs) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in rank order."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


class _Mesh:
    """``n`` logical ranks over a device list and the collectives between
    them. One device named ``n`` times holds the owner shards as row
    ranges of one tensor (``segs == 1``); ``n`` distinct cards hold one
    shard each (``segs == n``) and run ``torch.cuda.nccl``."""

    def __init__(self, devs: list):
        self.devices = list(devs)
        self.n = len(self.devices)
        self.one = all(same_device(d, self.devices[0])
                       for d in self.devices)
        if not self.one:
            ids = {(d.type, d.index) for d in self.devices}
            if len(ids) != self.n or any(d.type != "cuda"
                                         for d in self.devices):
                raise ValueError(
                    "mesh devices must name one device n times or n "
                    f"distinct CUDA devices, got {self.devices}")
        self.segs = 1 if self.one else self.n
        self.seg_devices = self.devices[: self.segs]

    def put(self, arr: np.ndarray) -> list:
        """Per-rank host slices ``arr[r]`` onto rank ``r``'s device."""
        if self.one:
            return list(torch.as_tensor(arr).to(self.devices[0],
                                                copy=True).unbind(0))
        return [torch.as_tensor(arr[r]).to(d, copy=True)
                for r, d in enumerate(self.devices)]

    def reduce_scatter(self, xs: list) -> list:
        """Sum the ranks' ``[P, ...]`` tensors; owner ``j`` keeps rows
        ``[j P/n, (j+1) P/n)`` (one full sum when ``segs == 1``)."""
        if self.one:
            return [_rank_sum(xs)]
        outs = [torch.empty((x.shape[0] // self.n,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device) for x in xs]
        torch.cuda.nccl.reduce_scatter([x.contiguous() for x in xs], outs)
        return outs

    def reduce_scatter_q(self, xs: list, block: int):
        """The blk8 reduce leg: each rank quantizes its ``n`` owner chunks
        blockwise, each owner sums the dequantized contributions in f32 in
        rank order. Returns ``(owner sums, per-rank residuals)``, the
        residual being input minus what the codes carry."""
        n = self.n
        shape = xs[0].shape
        if self.one:
            chunks = torch.stack(xs).reshape(n, n, -1)
            c = chunks.shape[-1]
            q, s = _quantize_blocks(chunks, block, reciprocal=True)
            sent = _dequantize_blocks(q, s, c)
            red = _rank_sum(list(sent.unbind(0)))
            resid = (chunks - sent).reshape((n,) + tuple(shape))
            return [red.reshape(shape)], list(resid.unbind(0))
        qs, resid = [], []
        for x in xs:
            chunks = x.reshape(n, -1)
            c = chunks.shape[-1]
            q, s = _quantize_blocks(chunks, block, reciprocal=True)
            qs.append((q, s))
            resid.append((chunks - _dequantize_blocks(q, s, c)
                          ).reshape(shape))
        red = []
        for j, d in enumerate(self.devices):
            parts = [_dequantize_blocks(q[j].to(d), s[j].to(d), c)
                     for q, s in qs]
            red.append(_rank_sum(parts).reshape(
                (shape[0] // n,) + tuple(shape[1:])))
        return red, resid

    def all_gather(self, segs: list) -> list:
        """The owner shards reassembled: one full tensor per segment
        device (each card's stream synchronised)."""
        if self.one:
            return [segs[0]]
        outs = [torch.empty((s.shape[0] * self.n,) + tuple(s.shape[1:]),
                            dtype=s.dtype, device=s.device) for s in segs]
        torch.cuda.nccl.all_gather([s.contiguous() for s in segs], outs)
        for d in self.devices:
            torch.cuda.synchronize(d)
        return outs


def _densify(keys: torch.Tensor, vals: torch.Tensor,
             padded: int) -> torch.Tensor:
    """Segment-sum a COO stream into ``[padded, dim]``; the sentinel key
    ``padded`` lands in a spare row that is dropped."""
    out = torch.zeros((padded + 1,) + tuple(vals.shape[1:]),
                      dtype=torch.float32, device=vals.device)
    return out.index_add_(0, keys.long(), vals)[:padded]


class MeshTable:
    """One table + updater state range-sharded over the plane's devices,
    with per-logical-rank deposit buffers. All mutation runs under the
    plane lock; rank-facing entrypoints take the rank explicitly (the
    :class:`MeshRank` handle binds it)."""

    def __init__(self, plane: "MeshPlane", name: str, num_rows: int,
                 dim: int, *, updater: str = "sgd", lr: float = 0.05,
                 adagrad_init: float = 0.1, eps: Optional[float] = None,
                 beta1: float = 0.9, beta2: float = 0.999):
        if updater not in ("sgd", "adagrad", "adam"):
            raise ValueError(
                "mesh-plane updater must be 'sgd', 'adagrad' or 'adam'")
        self.plane = plane
        self.name = name
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.updater = updater
        self.lr = float(lr)
        # same defaults as the wire table (train/sharded_ps.py), which
        # themselves match the ops/sparse_update.py oracles
        self.eps = float((1e-8 if updater == "adam" else 1e-10)
                         if eps is None else eps)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        n = plane.num_ranks
        mesh = plane.mesh
        self.padded = _padded(self.num_rows, n)
        self.shard_rows = self.padded // n
        seg_rows = self.padded // mesh.segs
        f32 = np.float32
        # the updater's constants as f32 scalars on each owner device
        # (the JAX plane's np.float32 constants; a Python float divisor
        # would turn into a reciprocal multiply on the card)
        self._c = [{k: torch.tensor(v, dtype=torch.float32, device=d)
                    for k, v in (("lr", f32(self.lr)), ("eps", f32(self.eps)),
                                 ("b1", f32(self.beta1)),
                                 ("b2", f32(self.beta2)),
                                 ("one_m_b1", f32(1) - f32(self.beta1)),
                                 ("one_m_b2", f32(1) - f32(self.beta2)),
                                 ("one", f32(1)))}
                   for d in mesh.seg_devices]

        def zeros(*tail, dtype=torch.float32, fill=0.0):
            return [torch.full((seg_rows,) + tail, fill, dtype=dtype,
                               device=d) for d in mesh.seg_devices]

        self._st = {"w": zeros(self.dim)}
        if updater == "adagrad":
            self._st["acc"] = zeros(self.dim, fill=float(adagrad_init))
        if updater == "adam":
            self._st["m"] = zeros(self.dim)
            self._st["v"] = zeros(self.dim)
            self._st["steps"] = zeros(dtype=torch.int32, fill=0)
        self.deposit = plane.deposit
        if self.deposit == "sparse":
            # per-rank COO (keys, rows) streams, densified on device
            # inside the wave: host staging scales with the touched set
            self._gbuf = None
            self._tstack = None
            self._ckeys: Optional[list] = [[] for _ in range(n)]
            self._cvals: Optional[list] = [[] for _ in range(n)]
            self.peak_deposit_bytes = 0
        else:
            # per-rank host deposit buffers, pre-stacked: the wave ships
            # this one [n, padded, dim] array (clean ranks contribute
            # exact zeros)
            self._gbuf = np.zeros((n, self.padded, self.dim), np.float32)
            self._tstack = (np.zeros((n, self.padded), np.float32)
                            if updater == "adam" else None)
            self._ckeys = self._cvals = None
            self.peak_deposit_bytes = self._gbuf.nbytes + (
                self._tstack.nbytes if self._tstack is not None else 0)
        self._dirty = [False] * n
        # the replicated pull mirror: the wave's all-gather, copied to
        # the host once per wave and read-only (pull_all serves views;
        # a wave replaces the mirror, never mutates it)
        self._mirror = np.zeros((self.padded, self.dim), np.float32)
        self._mirror.setflags(write=False)
        self.waves = 0
        self.rows_pushed = 0
        self.rows_pulled = 0
        # collective traffic accounting: what the reduce-scatter +
        # all-gather move per wave, summed over ranks (ring cost (n-1)/n
        # of the buffer each way, codes+scales for the blk8 tier)
        self.collective_bytes = 0
        # blk8 error feedback (plane.mesh_ef): each rank's quantization
        # residual, kept on its device between waves and folded into
        # its next contribution; the last finalize repays it exactly
        self._rbuf = ([torch.zeros(self.padded, self.dim,
                                   dtype=torch.float32, device=d)
                       for d in mesh.devices] if plane.mesh_ef else None)
        self.ef_waves = 0        # waves that folded + re-captured resid
        self.ef_fence_waves = 0  # exact repayment waves (finalize)
        self.sparse_waves = 0    # waves that densified on device
        self._wave_len = 8       # sparse: grow-only stack length L

    # ------------------------------------------------------------ state
    def _full(self, key: str) -> Optional[torch.Tensor]:
        """State ``key`` over the whole padded table (on the device when
        the plane has one, gathered to the host over distinct cards)."""
        segs = self._st.get(key)
        if segs is None:
            return None
        if len(segs) == 1:
            return segs[0]
        return torch.cat([s.cpu() for s in segs])

    _w = property(lambda self: self._full("w"))
    _acc = property(lambda self: self._full("acc"))
    _m = property(lambda self: self._full("m"))
    _v = property(lambda self: self._full("v"))
    _steps = property(lambda self: self._full("steps"))

    def _update(self, s: int, g: torch.Tensor,
                t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The updater on owner segment ``s`` (the wire table's numpy
        updaters op for op); returns adam's touch mask."""
        st, c = self._st, self._c[s]
        w = st["w"][s]
        if self.updater == "sgd":
            st["w"][s] = w - c["lr"] * g
            return None
        if self.updater == "adagrad":
            acc = st["acc"][s] + g * g
            st["acc"][s] = acc
            st["w"][s] = w - c["lr"] * g / (torch.sqrt(acc) + c["eps"])
            return None
        # lazy adam: the touch mask keeps untouched rows' moments and
        # step counters frozen (sharded_ps._adam_rows' per-key rule)
        mask = t > 0
        mcol = mask[:, None]
        steps = st["steps"][s] + mask.to(torch.int32)
        m = torch.where(mcol, c["b1"] * st["m"][s] + c["one_m_b1"] * g,
                        st["m"][s])
        v = torch.where(mcol, c["b2"] * st["v"][s]
                        + c["one_m_b2"] * (g * g), st["v"][s])
        tf = steps.to(torch.float32)[:, None]
        bc1 = c["one"] - torch.pow(c["b1"], tf)
        bc2 = c["one"] - torch.pow(c["b2"], tf)
        st["w"][s] = torch.where(
            mcol, w - c["lr"] * (m / bc1) / (torch.sqrt(v / bc2) + c["eps"]),
            w)
        st["m"][s], st["v"][s], st["steps"][s] = m, v, steps
        return mask

    # ------------------------------------------------------------ wave
    def _apply(self, g_in: list, t_in: Optional[list], *,
               fence: bool) -> None:
        """Reduce-scatter the ranks' ``[padded, dim]`` inputs, run the
        updater on the owner segments, all-gather and refresh the mirror.
        EF mode folds each rank's retained residual into its input and
        re-captures the wave's new residual; ``fence`` ships exact f32
        and resets the residual (the finalize repayment)."""
        mesh = self.plane.mesh
        ef = self._rbuf is not None
        if ef:
            g_in = [g + r for g, r in zip(g_in, self._rbuf)]
            if fence and self.updater == "adam":
                # the fence repays residual as a real (exact) push:
                # residual-only rows must pass the lazy-adam touch mask
                mass = [(g.abs().sum(dim=-1) > 0).to(torch.float32)
                        for g in g_in]
                t_in = (mass if t_in is None
                        else [torch.maximum(t, m) for t, m in zip(t_in, mass)])
        if fence or self.plane.comm == "float32":
            red, resid = mesh.reduce_scatter(g_in), None
        else:
            red, resid = mesh.reduce_scatter_q(g_in, self.plane.block)
        t_red = mesh.reduce_scatter(t_in) if self.updater == "adam" else None
        masks = [self._update(s, red[s], None if t_red is None else t_red[s])
                 for s in range(mesh.segs)]
        full = mesh.all_gather(self._st["w"])
        if ef and not fence:
            if self.updater == "adam":
                # rows no rank touched skip the update, so what they
                # shipped is discarded: their residual keeps the whole
                # input (nothing landed)
                mfull = mesh.all_gather([m.to(torch.float32) for m in masks])
                resid = [torch.where(mfull[0 if mesh.one else r][:, None] > 0,
                                     resid[r], g_in[r])
                         for r in range(mesh.n)]
            self._rbuf = resid
            self.ef_waves += 1
        elif ef:
            self._rbuf = [torch.zeros_like(g) for g in g_in]
            self.ef_fence_waves += 1
        mirror = _to_host(full[0])
        mirror.setflags(write=False)
        self._mirror = mirror

    def _clear_dirty(self) -> None:
        for r in range(self.plane.num_ranks):
            if self._dirty[r]:
                if self._gbuf is not None:
                    self._gbuf[r].fill(0.0)
                    if self._tstack is not None:
                        self._tstack[r].fill(0.0)
                else:
                    self._ckeys[r].clear()
                    self._cvals[r].clear()
                self._dirty[r] = False

    def _wave_locked(self, *, fence: bool = False) -> None:
        """One apply wave over the pre-stacked deposits (clean ranks
        contribute exact zeros). ``fence=True`` is the exact-f32
        repayment wave at finalize; in sparse mode it densifies any
        still-staged COO on the host, as the JAX plane does. Caller holds
        the plane lock."""
        if self._ckeys is not None and not fence:
            self._wave_sparse_locked()
            return
        t_wave0 = time.monotonic()
        mesh = self.plane.mesh
        g_host = self._gbuf
        if g_host is None:
            g_host = np.zeros((mesh.n, self.padded, self.dim), np.float32)
            for r in range(mesh.n):
                for k, v in zip(self._ckeys[r], self._cvals[r]):
                    np.add.at(g_host[r], k, v)
        g_in = mesh.put(g_host)
        t_in = mesh.put(self._tstack) if self._tstack is not None else None
        self._apply(g_in, t_in, fence=fence)
        self._clear_dirty()
        self.waves += 1
        self.collective_bytes += self._wave_bytes()
        # the step-phase observable: one wave = one collective round;
        # its duration hist feeds the plane's windowed layer
        self.plane.hist_wave.record_s(time.monotonic() - t_wave0)

    def _wave_sparse_locked(self) -> None:
        """Sparse apply wave: pack each rank's staged COO stream into
        ``[n, L]`` keys + ``[n, L, dim]`` rows (pad slots carry the
        sentinel key ``padded``), densify on device with a segment-sum
        scatter, then run the dense wave's reduce/update/gather. ``L`` is
        grow-only in powers of two (the JAX plane's compile-thrash guard,
        kept so that ``peak_deposit_bytes`` counts the same stacks).
        Caller holds the plane lock."""
        t_wave0 = time.monotonic()
        mesh = self.plane.mesh
        n = mesh.n
        counts = [sum(k.size for k in self._ckeys[r]) for r in range(n)]
        need = max(max(counts), 1)
        L = self._wave_len
        while L < need:
            L *= 2
        self._wave_len = L
        k_stack = np.full((n, L), self.padded, np.int32)
        v_stack = np.zeros((n, L, self.dim), np.float32)
        for r in range(n):
            o = 0
            for k, v in zip(self._ckeys[r], self._cvals[r]):
                k_stack[r, o:o + k.size] = k
                v_stack[r, o:o + k.size] = v
                o += k.size
        staged = sum(k.nbytes + v.nbytes
                     for r in range(n)
                     for k, v in zip(self._ckeys[r], self._cvals[r]))
        self.peak_deposit_bytes = max(
            self.peak_deposit_bytes,
            staged + k_stack.nbytes + v_stack.nbytes)
        ks, vs = mesh.put(k_stack), mesh.put(v_stack)
        g_in = [_densify(k, v, self.padded) for k, v in zip(ks, vs)]
        t_in = ([_densify(k, torch.ones(L, dtype=torch.float32,
                                        device=k.device), self.padded)
                 for k in ks] if self.updater == "adam" else None)
        self._apply(g_in, t_in, fence=False)
        self._clear_dirty()
        self.waves += 1
        self.sparse_waves += 1
        self.collective_bytes += self._wave_bytes()
        self.plane.hist_wave.record_s(time.monotonic() - t_wave0)

    def _wave_bytes(self) -> int:
        """Collective bytes one wave moves, summed over ranks: ring
        reduce-scatter + ring all-gather each move (n-1)/n of the buffer
        per rank; the blk8 reduce leg ships codes + blockwise scales
        (the shared ``blockwise_stream_bytes`` bill) instead of f32."""
        n = self.plane.num_ranks
        full = self.padded * self.dim * 4
        gather = (n - 1) * full  # (n-1)/n per rank, n ranks
        if self.plane.comm == "blk8":
            code, scale = blockwise_stream_bytes(
                self.padded, self.dim, 8, self.plane.block)
            reduce = (n - 1) * (code + scale)
        else:
            reduce = (n - 1) * full
        return reduce + gather

    # ---------------------------------------------------------- deposit
    def _deposit(self, rank: int, keys: np.ndarray,
                 grads: np.ndarray) -> None:
        """Coalesce duplicates via THE shared client-side dedup kernel
        (sharded_ps.sum_duplicate_keys — the bitwise-parity drill
        depends on both planes summing identically), then accumulate
        into the rank's buffer."""
        from minips_tpu_torch.train.sharded_ps import sum_duplicate_keys

        keys = np.asarray(keys, np.int64)
        grads = np.asarray(grads, np.float32).reshape(keys.size, self.dim)
        if keys.size and (keys.min() < 0 or keys.max() >= self.num_rows):
            raise ValueError("push keys outside the table's key space")
        uniq, summed, _ = sum_duplicate_keys(keys, grads, self.dim)
        if self._ckeys is not None:
            # sparse: stage the deduped COO slice; cross-deposit
            # duplicates coalesce on device
            self._ckeys[rank].append(np.asarray(uniq, np.int64))
            self._cvals[rank].append(
                np.ascontiguousarray(summed, np.float32))
        else:
            np.add.at(self._gbuf[rank], uniq, summed)
            if self._tstack is not None:
                self._tstack[rank][uniq] = 1.0
        self._dirty[rank] = True
        self.rows_pushed += keys.size

    def _deposit_dense(self, rank: int, grad: np.ndarray) -> None:
        grad = np.asarray(grad, np.float32).reshape(-1, self.dim)
        if grad.shape[0] != self.num_rows:
            raise ValueError(
                f"push_dense expects [{self.num_rows}, {self.dim}]")
        if self._ckeys is not None:
            # a dense push touches every row: COO staging degrades to
            # the full key list (correct, not clever)
            self._ckeys[rank].append(
                np.arange(self.num_rows, dtype=np.int64))
            self._cvals[rank].append(
                np.ascontiguousarray(grad, np.float32))
        else:
            self._gbuf[rank, : self.num_rows] += grad
            if self._tstack is not None:
                self._tstack[rank, : self.num_rows] = 1.0
        self._dirty[rank] = True
        self.rows_pushed += self.num_rows

    # ------------------------------------------------------- rank-facing
    def push(self, rank: int, keys: np.ndarray,
             grads: np.ndarray) -> None:
        plane = self.plane
        with plane._cond:
            self._deposit(rank, keys, grads)
            plane._maybe_wave_locked(self)

    def push_dense(self, rank: int, grad: np.ndarray) -> None:
        plane = self.plane
        with plane._cond:
            self._deposit_dense(rank, grad)
            plane._maybe_wave_locked(self)

    def pull(self, rank: int, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        if keys.size and (keys.min() < 0
                          or keys.max() >= self.num_rows):
            # same contract as the wire plane: a padding row or a
            # numpy-wrapped negative index is refused, never served
            raise ValueError("pull keys outside the table's key space")
        plane = self.plane
        with plane._cond:
            plane._admit_locked(rank)
            if self._dirty[rank]:  # read-your-own-writes: flush first
                self._wave_locked()
            self.rows_pulled += keys.size
            return self._mirror[keys].copy()

    def pull_all(self, rank: int) -> np.ndarray:
        """Full-table read: a READ-ONLY view of the current pull mirror
        (waves replace the mirror, never mutate it, so the view is a
        stable snapshot, at zero copy)."""
        plane = self.plane
        with plane._cond:
            plane._admit_locked(rank)
            if self._dirty[rank]:
                self._wave_locked()
            self.rows_pulled += self.num_rows
            return self._mirror[: self.num_rows]

    def load_dense(self, w: np.ndarray) -> None:
        """Install a full [num_rows, dim] weight table (drill/checkpoint
        seeding) — re-sharded onto the devices, mirror refreshed."""
        w = np.asarray(w, np.float32).reshape(self.num_rows, self.dim)
        padded = np.zeros((self.padded, self.dim), np.float32)
        padded[: self.num_rows] = w
        mesh = self.plane.mesh
        rows = self.padded // mesh.segs
        with self.plane._cond:
            self._st["w"] = [
                torch.as_tensor(padded[s * rows:(s + 1) * rows]).to(
                    d, copy=True) for s, d in enumerate(mesh.seg_devices)]
            padded.setflags(write=False)
            self._mirror = padded

    def shard_slice(self, rank: int) -> np.ndarray:
        """Rank ``rank``'s owner rows of the CURRENT table (mirror read)
        — the per-rank final-state view the lockstep drill compares
        against the wire tables' local shards."""
        with self.plane._cond:
            lo = rank * self.shard_rows
            hi = min(lo + self.shard_rows, self.num_rows)
            return self._mirror[lo:hi].copy()

    def _ef_resident(self) -> int:
        """(rank, row) pairs whose retained residual is nonzero."""
        return sum(int((r.abs().sum(dim=-1) > 0).sum())
                   for r in self._rbuf)

    def ef_stats(self) -> Optional[dict]:
        """blk8 error-feedback accounting — None when EF is off (the
        off-vs-idle convention every wire stats block keeps); resident
        rows are the residual mass currently awaiting its next fold."""
        if self._rbuf is None:
            return None
        return {
            "folded_waves": int(self.ef_waves),
            "fence_waves": int(self.ef_fence_waves),
            "resident_rows": self._ef_resident(),
        }

    def local_bytes(self) -> int:
        """Device bytes of table + updater state PER SHARD — the same
        ~1/N claim as the wire table's local_bytes."""
        n = self.shard_rows * self.dim * 4
        if "acc" in self._st:
            n += self.shard_rows * self.dim * 4
        if "m" in self._st:
            n += 2 * self.shard_rows * self.dim * 4 + self.shard_rows * 4
        return n


class MeshRank:
    """A logical rank's handle on the plane: the per-rank API surface
    the wire path spreads across (ShardedTable, ShardedPSTrainer)."""

    def __init__(self, plane: "MeshPlane", rank: int):
        self.plane = plane
        self.rank = rank
        self.tables = _RankTables(plane, rank)

    @property
    def clock(self) -> int:
        return int(self.plane._clk_host[self.rank])

    @property
    def staleness(self) -> float:
        return self.plane.staleness

    def tick(self, *, wait: bool = True) -> None:
        self.plane.tick(self.rank, wait=wait)

    def finalize(self, timeout: float = 30.0) -> None:
        self.plane.finalize(self.rank, timeout=timeout)


class _RankTables:
    def __init__(self, plane, rank):
        self._plane, self._rank = plane, rank

    def __getitem__(self, name: str) -> "_BoundTable":
        return _BoundTable(self._plane.tables[name], self._rank)

    def __iter__(self):
        return iter(self._plane.tables)


class _BoundTable:
    """MeshTable with the rank argument bound — pull/push read like the
    wire ShardedTable's client surface."""

    def __init__(self, table: MeshTable, rank: int):
        self._t, self._r = table, rank

    def __getattr__(self, item):
        return getattr(self._t, item)

    def pull(self, keys):
        return self._t.pull(self._r, keys)

    def pull_all(self):
        return self._t.pull_all(self._r)

    def push(self, keys, grads):
        self._t.push(self._r, keys, grads)

    def push_dense(self, grad):
        self._t.push_dense(self._r, grad)


class MeshPlane:
    """The gang: one process, ``num_ranks`` logical ranks mapped onto
    ``num_ranks`` devices (module docstring), tables sharded across them.

    Construction order: ``MeshPlane(...)`` → ``add_table(...)`` per
    table → ``rank(r)`` handles for the worker threads. BSP/SSP comes
    from ``staleness`` exactly like the wire trainer's; the gate is the
    shared ``admits`` predicate over the plane's device-side clock
    vector."""

    def __init__(self, num_ranks: int, *, staleness: float = 0.0,
                 comm: str = "float32", block: Optional[int] = None,
                 deposit: Optional[str] = None, devices=None,
                 gate_timeout: float = 60.0):
        if comm not in VALID_MESH_COMM:
            raise ValueError(f"mesh comm must be one of "
                             f"{VALID_MESH_COMM}, got {comm!r}")
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        devs = mesh_devices(num_ranks, devices)
        if len(devs) < num_ranks:
            raise ValueError(
                f"mesh plane needs {num_ranks} devices, have "
                f"{len(devs)} — pass devices=[device] * {num_ranks} to "
                f"run the ranks on one device (MINIPS_FORCE_CPU=1: the CPU)")
        self.num_ranks = int(num_ranks)
        self.staleness = float(staleness)
        self.comm = comm
        # the quantized tier defaults to the HOST wire's block size:
        # one codec (blockwise absmax), two transports
        self.block = int(HOST_BLOCK if block is None else block)
        self.deposit = resolve_deposit(deposit)
        # error feedback on the blk8 reduce leg (default ON);
        # MINIPS_MESH_EF=0 is the kill switch (A/B arm); float32 ships
        # exactly, nothing to feed back
        self.mesh_ef = (comm == "blk8"
                        and os.environ.get("MINIPS_MESH_EF",
                                           "1").strip() != "0")
        self.gate_timeout = float(gate_timeout)
        self.mesh = _Mesh(devs[: self.num_ranks])
        self.tables: dict[str, MeshTable] = {}
        self._cond = threading.Condition(threading.RLock())
        # the device-side clock vector: pull admission and the SSP gate
        # certify against min() of THIS tensor (gate.admits, the one
        # predicate); int32 as in the JAX plane, RETIRED_CLOCK = 2^30
        self._clk_dev = torch.zeros(self.num_ranks, dtype=torch.int32,
                                    device=self.mesh.devices[0])
        self._clk_host = np.zeros(self.num_ranks, np.int64)
        self._retired = np.zeros(self.num_ranks, bool)
        self.gate_waits = 0
        self.max_skew_seen = 0
        # always-on step-phase histograms (apply-wave duration, tick-gate
        # blocked time) + the windowed layer over them; MINIPS_OBS=0
        # disables the window only
        self.hist_wave = Log2Histogram()
        self.hist_gate = Log2Histogram()
        self.obs_window = _ow.maybe_build()
        if self.obs_window is not None:
            self.obs_window.register_hist(
                "wave", lambda: self.hist_wave.snapshot())
            self.obs_window.register_hist(
                "gate", lambda: self.hist_gate.snapshot())
            self.obs_window.register_counter(
                "waves", lambda: sum(t.waves
                                     for t in self.tables.values()))
            self.obs_window.register_counter(
                "collective_bytes",
                lambda: sum(t.collective_bytes
                            for t in self.tables.values()))

    # ------------------------------------------------------------- setup
    def add_table(self, name: str, num_rows: int, dim: int,
                  **kwargs) -> MeshTable:
        if name in self.tables:
            raise ValueError(f"table {name!r} already exists")
        t = MeshTable(self, name, num_rows, dim, **kwargs)
        self.tables[name] = t
        return t

    def rank(self, r: int) -> MeshRank:
        if not 0 <= r < self.num_ranks:
            raise ValueError(f"rank {r} out of range")
        return MeshRank(self, r)

    # -------------------------------------------------------- gang logic
    def _global_min(self) -> int:
        """min of the clock vector's host mirror, updated in lockstep
        with the device vector under the plane lock: the gate's wait
        loops poll this, and admission then certifies once against the
        device vector (:meth:`_device_min`)."""
        return int(self._clk_host.min())

    def _device_min(self) -> int:
        """min of the DEVICE-side clock vector (a host sync on the
        card) — the admission certificate reads THIS."""
        return int(self._clk_dev.min())

    def clocks(self) -> np.ndarray:
        """Host copy of the device-side clock vector (tests/obs)."""
        return _to_host(self._clk_dev)

    def _set_clock_locked(self, rank: int, value: int) -> None:
        self._clk_host[rank] = value
        self._clk_dev[rank] = value

    def _maybe_wave_locked(self, table: MeshTable) -> None:
        """Fire the apply wave eagerly once every live rank deposited —
        the full wave is the natural BSP barrier and keeps the state
        fresh without waiting for the tick boundary."""
        live = [r for r in range(self.num_ranks) if not self._retired[r]]
        if live and all(table._dirty[r] for r in live):
            table._wave_locked()
            self._cond.notify_all()

    def _admit_locked(self, rank: int) -> bool:
        """Pull admission: wait until ``admits(min(clock_vec), clk, s)``
        — the owner-side park rule. The host mirror screens each poll;
        the admission that actually serves is certified against the
        DEVICE clock vector."""
        clk = int(self._clk_host[rank])
        if not admits(self._global_min(), clk, self.staleness):
            self.gate_waits += 1
            deadline = time.monotonic() + self.gate_timeout
            while not admits(self._global_min(), clk, self.staleness):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"mesh plane gate timed out at clock {clk} "
                        f"(global_min={self._global_min()}, "
                        f"staleness={self.staleness})")
                self._cond.wait(timeout=min(0.2, left))
        if not admits(self._device_min(), clk, self.staleness):
            # cannot happen while mirror and device update under one
            # lock — but the predicate's final word is device state
            raise RuntimeError(
                "mesh clock mirror ahead of the device vector "
                f"({self._clk_host.tolist()} vs {self.clocks().tolist()})")
        return True

    def _flush_rank_locked(self, rank: int) -> None:
        """Flush rank ``rank``'s deposits ahead of a clock advance.
        Under BSP every live rank deposits every step, so a solo flush
        here would triple the wave count: give the eager full wave a
        short grace to fire first (peers' pushes run while we
        cond-wait), then flush whatever is left — correctness (pushes
        before clock) never depends on the grace."""
        if not any(t._dirty[rank] for t in self.tables.values()):
            return
        if self.staleness == 0:
            deadline = time.monotonic() + _BSP_FLUSH_GRACE
            while any(t._dirty[rank] for t in self.tables.values()):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(0.01, left))
        for t in self.tables.values():
            if t._dirty[rank]:
                t._wave_locked()
                self._cond.notify_all()

    def tick(self, rank: int, *, wait: bool = True) -> None:
        """Clock boundary: flush the rank's deposits (an apply wave —
        its step-k pushes enter the shared state BEFORE the clock reads
        k), advance the device-side clock vector, then gate
        (BSP/SSP/ASP rule) unless ``wait=False`` (single-threaded
        drivers gate at pull admission instead)."""
        poison_args = None
        try:
            with self._cond:
                self._flush_rank_locked(rank)
                new = int(self._clk_host[rank]) + 1
                self._set_clock_locked(rank, new)
                self._cond.notify_all()
                if rank == 0 and self.obs_window is not None:
                    # one roll per full clock (rank 0's boundary)
                    self.obs_window.roll()
                # skew is recorded in EVERY mode (ASP and wait=False
                # included)
                self.max_skew_seen = max(self.max_skew_seen,
                                         new - self._global_min())
                if not wait or self.staleness == float("inf"):
                    return
                threshold = new - int(self.staleness)
                t_gate0 = time.monotonic()
                if self._global_min() < threshold:
                    self.gate_waits += 1
                deadline = time.monotonic() + self.gate_timeout
                try:
                    while self._global_min() < threshold:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            poison_args = {
                                "rank": rank, "clock": new,
                                "global_min": self._global_min(),
                                "staleness": self.staleness}
                            raise TimeoutError(
                                f"mesh plane gate timed out at clock "
                                f"{new} "
                                f"(global_min={self._global_min()}, "
                                f"staleness={self.staleness})")
                        self._cond.wait(timeout=min(0.2, left))
                finally:
                    self.hist_gate.record_s(time.monotonic() - t_gate0)
                if self._device_min() < threshold:  # certify: device
                    raise RuntimeError(
                        "mesh clock mirror ahead of the device vector "
                        f"({self._clk_host.tolist()} vs "
                        f"{self.clocks().tolist()})")
        except TimeoutError:
            # the dump is file I/O: it must not run under the plane
            # lock (every other rank's tick would block behind it)
            if poison_args is not None:
                _fl.poison("mesh_gate_deadline", poison_args)
            raise

    def finalize(self, rank: int, timeout: float = 30.0) -> None:
        """Flush, retire (the shared RETIRED_CLOCK sentinel so nobody
        gates on a finished rank), and barrier until every rank
        finalized — after which pull/pull_all return identical rows for
        every rank (there is only ONE state; the barrier guarantees it
        contains everyone's mass)."""
        poison_args = None
        try:
            with self._cond:
                for t in self.tables.values():
                    if t._dirty[rank]:
                        t._wave_locked()
                self._retired[rank] = True
                self._set_clock_locked(rank, RETIRED_CLOCK)
                if self._retired.all():
                    # LAST rank out repays the blk8 EF residual with one
                    # exact-f32 fence wave per table that still holds
                    # mass; the barrier below returns every rank after it
                    for t in self.tables.values():
                        if t._rbuf is not None and t._ef_resident():
                            t._wave_locked(fence=True)
                self._cond.notify_all()
                deadline = time.monotonic() + timeout
                while not self._retired.all():
                    left = deadline - time.monotonic()
                    if left <= 0:
                        missing = [r for r in range(self.num_ranks)
                                   if not self._retired[r]]
                        poison_args = {"rank": rank,
                                       "missing": missing}
                        raise TimeoutError(
                            f"mesh finalize: ranks {missing} never "
                            "retired")
                    self._cond.wait(timeout=min(0.2, left))
        except TimeoutError:
            if poison_args is not None:  # dump OUTSIDE the plane lock
                _fl.poison("mesh_finalize_deadline", poison_args)
            raise

    def stats(self) -> dict:
        return {
            "plane": "mesh",
            "comm": self.comm,
            "block": self.block if self.comm == "blk8" else None,
            "deposit": self.deposit,
            "ranks": self.num_ranks,
            "devices": self.mesh.n,
            "waves": {n: t.waves for n, t in self.tables.items()},
            # peak host bytes the deposit stage held (dense: the fixed
            # pre-stacked buffers; sparse: the high-water COO staging)
            "peak_deposit_bytes": {n: t.peak_deposit_bytes
                                   for n, t in self.tables.items()},
            "sparse_waves": sum(t.sparse_waves
                                for t in self.tables.values()),
            "collective_bytes": sum(t.collective_bytes
                                    for t in self.tables.values()),
            # blk8 reduce-leg error feedback: None when off
            "ef": ({n: t.ef_stats()
                    for n, t in self.tables.items()}
                   if self.mesh_ef else None),
            "gate_waits": self.gate_waits,
            "hist": {"wave_ms": summarize_counts(
                         self.hist_wave.snapshot()),
                     "gate_ms": summarize_counts(
                         self.hist_gate.snapshot())},
            "window": (self.obs_window.record()
                       if self.obs_window is not None else None),
        }


class MeshAggregator:
    """The hier leader's in-host reduce backend (``MINIPS_HIER``
    ``agg=mesh``): member contributions deposit as per-slot COO streams,
    and one device round — segment-sum densify per slot, then a
    reduce-scatter over the slots' devices (the blk8 tier with its
    error-feedback residual out, or exact f32) — produces the aggregate
    the leader ships cross-host. The cross-host leg (one ``psH`` frame
    per owner) is untouched, so cross-host bytes are identical by
    construction.

    Fewer than 2 usable devices (``m = min(slots, devices,
    MINIPS_HIER_MESH_DEVS)``) reduce on the host via THE shared dedup
    kernel in the exact deposit order the f64 path uses — bitwise
    ``agg=host``. The ``reduce()`` residual feeds the leader's
    ResidualStore so the unbiased-flush contract holds end to end."""

    def __init__(self, num_rows: int, dim: int, *, slots: int,
                 comm: str = "blk8", block: Optional[int] = None,
                 devices=None):
        if comm not in VALID_MESH_COMM:
            raise ValueError(f"aggregator comm must be one of "
                             f"{VALID_MESH_COMM}, got {comm!r}")
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.block = int(HOST_BLOCK if block is None else block)
        devs = mesh_devices(max(int(slots), 1), devices)
        m = min(int(slots), len(devs))
        cap = os.environ.get("MINIPS_HIER_MESH_DEVS", "").strip()
        if cap:
            m = min(m, max(int(cap), 1))
        self.m = max(m, 1)
        # one usable device -> nothing to reduce-scatter ACROSS: the
        # degenerate tier is the host dedup kernel, and it reports
        # comm=float32 because that is what it ships (exactly)
        self.comm = comm if self.m >= 2 else "float32"
        self.reduces = 0
        self.rows_reduced = 0
        self.collective_bytes = 0
        self.peak_stage_bytes = 0
        self._staged: list = [[] for _ in range(self.m)]
        self._order: list = []  # (slot-stream flattening) deposit order
        self._L = 8             # grow-only stack length (see reduce())
        if self.m >= 2:
            self.mesh = _Mesh(devs[: self.m])
            self.padded = _padded(self.num_rows, self.m)
        else:
            self.mesh = None
            self.padded = self.num_rows

    def deposit(self, slot: int, keys: np.ndarray,
                grads: np.ndarray) -> None:
        """Stage one member contribution. ``slot`` is the member's
        index within the host group (wrapped onto the devices)."""
        keys = np.asarray(keys, np.int64)
        grads = np.asarray(grads, np.float32).reshape(keys.size,
                                                      self.dim)
        if keys.size == 0:
            return
        if keys.min() < 0 or keys.max() >= self.num_rows:
            raise ValueError("aggregator keys outside the key space")
        self._staged[slot % self.m].append((keys, grads))
        self._order.append((keys, grads))

    def reduce(self):
        """Run the reduce over everything staged since the last call.

        Returns ``(keys, rows, resid_keys, resid_rows)``: the touched
        keys (sorted) with their aggregated rows, plus the quantizer's
        residual (what the blk8 exchange did NOT ship) for the leader's
        ResidualStore. Exact tiers return empty residuals."""
        empty_r = (np.zeros(0, np.int64),
                   np.zeros((0, self.dim), np.float32))
        if not self._order:
            return empty_r + empty_r
        from minips_tpu_torch.train.sharded_ps import sum_duplicate_keys

        if self.m < 2:
            # host tier: concat in deposit order, THE shared f64 dedup
            # kernel — bitwise what agg=host would have shipped
            ks = np.concatenate([k for k, _ in self._order])
            gs = np.concatenate([g for _, g in self._order])
            self._staged = [[] for _ in range(self.m)]
            self._order = []
            k, g, _ = sum_duplicate_keys(ks, gs, self.dim)
            if k.size and not np.all(k[1:] >= k[:-1]):
                # the kernel keeps the ORIGINAL pairing when nothing
                # coalesced — restore the sorted order reduce() promises
                order = np.argsort(k, kind="stable")
                k, g = k[order], g[order]
            self.reduces += 1
            self.rows_reduced += int(k.size)
            return (k, g) + empty_r
        counts = [sum(k.size for k, _ in s) for s in self._staged]
        need = max(max(counts), 1)
        L = self._L
        while L < need:
            L *= 2
        self._L = L
        k_stack = np.full((self.m, L), self.padded, np.int32)
        v_stack = np.zeros((self.m, L, self.dim), np.float32)
        for s in range(self.m):
            o = 0
            for k, v in self._staged[s]:
                k_stack[s, o:o + k.size] = k
                v_stack[s, o:o + k.size] = v
                o += k.size
        staged_bytes = sum(k.nbytes + g.nbytes for k, g in self._order)
        self.peak_stage_bytes = max(
            self.peak_stage_bytes,
            staged_bytes + k_stack.nbytes + v_stack.nbytes)
        touched = np.unique(np.concatenate(
            [k for k, _ in self._order]))
        self._staged = [[] for _ in range(self.m)]
        self._order = []
        mesh = self.mesh
        dense = [_densify(k, v, self.padded)
                 for k, v in zip(mesh.put(k_stack), mesh.put(v_stack))]
        if self.comm == "blk8":
            red, resid = mesh.reduce_scatter_q(dense, self.block)
        else:
            red, resid = mesh.reduce_scatter(dense), None
        agg = _to_host(mesh.all_gather(red)[0])  # [padded, dim]
        rows = agg[touched]
        if resid is not None:
            resid_total = np.stack([_to_host(r) for r in resid]).sum(axis=0)
            rk = np.flatnonzero(
                np.abs(resid_total).sum(axis=1) > 0)
            rk = rk[rk < self.num_rows]
            rrows = resid_total[rk]
            code, scale = blockwise_stream_bytes(
                self.padded, self.dim, 8, self.block)
            self.collective_bytes += (self.m - 1) * (code + scale)
        else:
            rk, rrows = empty_r
            self.collective_bytes += (
                (self.m - 1) * self.padded * self.dim * 4)
        self.reduces += 1
        self.rows_reduced += int(touched.size)
        return touched, rows, np.asarray(rk, np.int64), rrows

    def stats(self) -> dict:
        return {
            "backend": "mesh" if self.m >= 2 else "host-degenerate",
            "slots": self.m,
            "comm": self.comm,
            "reduces": int(self.reduces),
            "rows_reduced": int(self.rows_reduced),
            "collective_bytes": int(self.collective_bytes),
            "peak_stage_bytes": int(self.peak_stage_bytes),
        }
