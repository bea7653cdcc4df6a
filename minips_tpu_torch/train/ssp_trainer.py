"""SSPTrainer — the port of ``minips_tpu/train/ssp_trainer.py``:
multi-process BSP/SSP/ASP over the control bus.

One process per node, each driving its own step on its device, with the
parameter-server semantics carried by two host-side channels:

- **push** publishes my parameter *delta* (a packed float32 blob) to
  every peer, and every process applies every peer's deltas into its
  local replica: a replicated PS whose "server state" is the merged
  replica. Additive updates commute, so all replicas converge to the same
  state once all deltas land (float-addition reorder noise aside).
- **clock gossip + gate** is ``Clock()`` with the BSP/SSP/ASP admission
  rule: after step ``c`` a process waits until ``global_min_clock >= c -
  staleness`` (0 = BSP lockstep, s = SSP, inf = ASP never waits), the
  shared ``consistency/gate.py`` rule, enforced across processes.

A process publishes its step-``c`` delta before its clock-``c`` gossip on
the same socket, and the bus keeps per-publisher order, so once the gate
sees a peer at clock ``c`` that peer's deltas through step ``c`` are in
the inbox and merge at the next drain: staleness is the only
inconsistency.

The step is a PyTorch function on the process's device, ``(params,
batch) -> (new_params, loss)`` over a tree of tensors; the flat vector
and the delta follow ``tables/dense.py:ravel`` (``ravel_pytree`` order),
so a state dict carries between the two packages. The wire, the
compression and the ``MINIPS_*`` knobs of the bus are the JAX package's,
so port and JAX-package processes exchange deltas on one mesh.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from minips_tpu_torch.comm.bus import ClockGossip, ControlBus
from minips_tpu_torch.consistency.gate import (PeerFailureError,
                                               StalenessGate, publish_clock)
from minips_tpu_torch.tables.dense import ravel

__all__ = ["SSPTrainer", "PeerFailureError"]  # PeerFailureError re-exported

PyTree = Any


class SSPTrainer:
    """Drives ``step_fn`` locally; exchanges deltas + clocks with peers.

    Parameters
    ----------
    step_fn: ``(params, batch) -> (new_params, loss)`` on tensors.
    params: initial parameter tree of tensors (identical on every
        process), on the device the step runs on.
    bus / num_processes: the loopback/TCP control bus and peer count.
    staleness: 0 = BSP, s = SSP, ``float('inf')`` = ASP.
    push_every: publish accumulated local deltas every k steps.
    compress: fraction of delta entries shipped per push (1.0 = dense);
        below 1.0 each push sends the top entries by magnitude (int32
        indices + f32 values) and keeps the rest as a residual for the
        next push (error feedback); ``finalize`` flushes it dense.
    monitor: optional HeartbeatMonitor; on gate timeout its dead set turns
        a hang into a PeerFailureError and excludes corpses from the gate.
    """

    def __init__(
        self,
        step_fn: Callable[[PyTree, Any], tuple[PyTree, Any]],
        params: PyTree,
        bus: ControlBus,
        num_processes: int,
        *,
        staleness: float = 0,
        push_every: int = 1,
        gate_timeout: float = 60.0,
        monitor=None,
        compress: float = 1.0,
    ):
        if not 0.0 < compress <= 1.0:
            raise ValueError("compress must be in (0, 1]")
        self.step_fn = step_fn
        self.bus = bus
        self.num_processes = num_processes
        self.staleness = staleness
        self.push_every = max(int(push_every), 1)
        self.monitor = monitor
        self.compress = compress
        self.bytes_pushed = 0    # wire accounting (the compression payoff)

        flat, self._unravel = ravel(params)
        self._flat = flat.clone()
        self._params = self._unravel(self._flat)
        self._nparam = int(flat.shape[0])
        self._pending_push = np.zeros(self._nparam, np.float32)
        self._inbox: deque[np.ndarray] = deque()
        self._inbox_lock = threading.Lock()
        self.clock = 0
        self.deltas_applied = 0
        self._retired = False

        self.gossip = ClockGossip(bus, num_processes, workers_per_process=1)
        self._gate_obj = StalenessGate(self.gossip, staleness,
                                       timeout=gate_timeout, monitor=monitor)
        self._flushed: set[int] = set()
        self._flush_cond = threading.Condition()
        bus.on("delta", self._on_delta)
        bus.on("flush", self._on_flush)

    # ------------------------------------------------------------- messaging
    def _on_delta(self, sender: int, payload: dict) -> None:
        if sender == self.bus.my_id:
            return  # own PUB loops back only if self-subscribed; be safe
        blob = payload.get("__blob__")
        if blob is None:
            return
        if payload.get("fmt") == "topk":
            # blob = [k int32 indices][k f32 values]
            k = int(payload.get("k", 0))
            if len(blob) != k * 8 or k > self._nparam:
                return  # malformed / stale peer; drop
            idx = np.frombuffer(blob[: 4 * k], np.int32)
            if k and (idx.min() < 0 or idx.max() >= self._nparam):
                return
            vals = np.frombuffer(blob[4 * k:], np.float32)
            vec = np.zeros(self._nparam, np.float32)
            vec[idx] = vals
        else:
            vec = np.frombuffer(blob, np.float32)
            if vec.shape[0] != self._nparam:
                return  # shape mismatch: stale peer from an old run; drop
        with self._inbox_lock:
            self._inbox.append(vec)

    def _on_flush(self, sender: int, payload: dict) -> None:
        with self._flush_cond:
            self._flushed.add(sender)
            self._flush_cond.notify_all()

    def _set_flat(self, flat: torch.Tensor) -> None:
        self._flat = flat
        self._params = self._unravel(flat)

    def _drain_inbox(self) -> None:
        with self._inbox_lock:
            pending = list(self._inbox)
            self._inbox.clear()
        if not pending:
            return
        total = np.sum(pending, axis=0) if len(pending) > 1 else pending[0]
        self._set_flat(self._flat + torch.from_numpy(np.array(total)).to(
            device=self._flat.device, dtype=self._flat.dtype))
        self.deltas_applied += len(pending)

    def _push(self, force: bool = False) -> None:
        if not force and self.clock % self.push_every != 0:
            return
        if not np.any(self._pending_push):
            return
        vec = self._pending_push.astype(np.float32)
        if self.compress < 1.0 and not force:
            # top-k by magnitude; the unsent tail STAYS in _pending_push
            # (error feedback) and rides a later push
            k = max(1, int(self.compress * self._nparam))
            idx = np.argpartition(np.abs(vec), -k)[-k:].astype(np.int32)
            vals = vec[idx]
            blob = idx.tobytes() + vals.tobytes()
            self.bus.publish("delta", {"clock": self.clock, "fmt": "topk",
                                       "k": int(k)}, blob=blob)
            self.bytes_pushed += len(blob)
            self._pending_push[idx] = 0.0   # residual keeps the rest
            return
        # dense: force-pushes (finalize) always take this path so the
        # full residual lands and replicas converge exactly
        blob = vec.tobytes()
        self.bus.publish("delta", {"clock": self.clock}, blob=blob)
        self.bytes_pushed += len(blob)
        self._pending_push = np.zeros(self._nparam, np.float32)

    # ------------------------------------------------------------------ gate
    @property
    def gate_waits(self) -> int:
        return self._gate_obj.gate_waits

    @property
    def max_skew_seen(self) -> int:
        return self._gate_obj.max_skew_seen

    # ------------------------------------------------------------------ step
    def step(self, batch) -> float:
        """One local step: merge peer pushes, compute, push, clock, gate."""
        self._drain_inbox()
        new_params, loss = self.step_fn(self._params, batch)
        after, _ = ravel(new_params, self._flat.device)
        delta = (after - self._flat).to(torch.float32).cpu().numpy()
        self._pending_push += delta
        self._set_flat(after)
        self.clock += 1
        self._push()
        self.gossip.publish_local([self.clock])
        self._gate_obj.wait(self.clock)
        return float(loss)

    # -------------------------------------------------------------- lifecycle
    def retire(self) -> None:
        """Announce this worker is out of data: publish the shared
        sentinel clock (``consistency/gate.py`` RETIRED_CLOCK) so peers'
        gates never wait on a finished worker. Call before finalize()."""
        self._retired = True
        publish_clock(self.gossip, self.clock, True)

    def finalize(self, timeout: float = 30.0) -> PyTree:
        """Flush my remaining delta, wait for every live peer's flush,
        merge their tail: afterwards every live replica holds the same
        merged parameters (up to float reorder noise)."""
        self._push(force=True)
        # "flush" follows the forced dense push on the same socket, so
        # once a peer's flush is heard every delta it sent is in the inbox
        self.bus.publish("flush", {"clock": self.clock})
        publish_clock(self.gossip, self.clock, self._retired)
        deadline = time.monotonic() + timeout
        peers = set(range(self.num_processes)) - {self.bus.my_id}
        while True:
            with self._flush_cond:
                live = peers - self.gossip.excluded
                if live <= self._flushed:
                    break
                self._flush_cond.wait(timeout=0.5)
            dead = self.monitor.check() if self.monitor is not None else set()
            for p in dead:
                self.gossip.exclude(p)
            if time.monotonic() > deadline:
                with self._flush_cond:
                    missing = sorted(peers - self._flushed
                                     - self.gossip.excluded)
                if not dead:
                    raise TimeoutError(
                        f"finalize: peers {missing} never flushed")
        self._drain_inbox()
        return self._params

    @property
    def params(self) -> PyTree:
        return self._params

    @property
    def flat(self) -> torch.Tensor:
        """The replica as one flat vector (``ravel_pytree`` order)."""
        return self._flat

    @property
    def skew(self) -> int:
        return self.gossip.skew

    # ------------------------------------------------------------ checkpoint
    # state_dict/load_state_dict make the trainer a "table" to the
    # checkpointers: PS state = params + clock (SURVEY.md §5.4)
    def state_dict(self) -> dict:
        return {"flat": self._flat.detach().cpu().numpy().copy(),
                "clock": np.asarray(self.clock)}

    def load_state_dict(self, state: dict) -> None:
        self._set_flat(torch.as_tensor(np.array(state["flat"])).to(
            device=self._flat.device, dtype=self._flat.dtype))
        self.clock = int(state["clock"])
        self._pending_push = np.zeros(self._nparam, np.float32)
        with self._inbox_lock:
            self._inbox.clear()
        # through the chokepoint: a restore on a retired trainer keeps the
        # sentinel (gate.py RETIRED_CLOCK stickiness)
        publish_clock(self.gossip, self.clock, self._retired)
