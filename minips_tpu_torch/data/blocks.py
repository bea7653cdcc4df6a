"""Dynamic data-block assignment — the HDFS block assigner/coordinator of
the reference lineage (SURVEY.md §1 L5: "HDFS block assigner/coordinator in
the FlexPS lineage"), rebuilt host-side.

The reference statically shards data per worker only in the simplest apps;
the lineage's coordinator hands out *blocks* dynamically so fast workers
take more blocks (straggler mitigation) and a dead worker's unfinished
blocks can be re-queued (SURVEY.md §5.3 failure handling). That is exactly
what SSP-style asynchrony wants on the data side, so the rebuild keeps it:

- ``split_rows`` / ``split_file_lines`` produce JSON-serializable block
  descriptors (row ranges, or newline-aligned byte ranges of a text file).
- ``LocalBlockAssigner`` — thread-safe queue for single-process Engines
  (threads-as-workers, SURVEY.md §4).
- ``BlockMaster`` / ``BlockClient`` — the multi-process protocol over the
  control bus (comm/bus.py): workers request the next block, the master
  (process 0) assigns; ``done`` acks retire a block, and
  ``BlockMaster.handle_failure(pid)`` re-queues a dead worker's outstanding
  blocks for the survivors.

The bus does not loop a process's own messages back to itself, so the
master's co-located worker passes ``local_master=`` to its client and is
served by direct call — same code path, no sockets.

A copy of ``minips_tpu/data/blocks.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterator, Optional

Block = dict  # JSON-serializable descriptor; "id" is the only required key


def split_rows(n_rows: int, block_size: int) -> list[Block]:
    """Row-range blocks [{"id", "start", "end"}] covering [0, n_rows)."""
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    return [{"id": k, "start": s, "end": min(s + block_size, n_rows)}
            for k, s in enumerate(range(0, n_rows, block_size))]


def split_file_lines(path: str, lines_per_block: int) -> list[Block]:
    """Newline-aligned byte-range blocks of a text file:
    [{"id", "path", "offset", "nbytes", "lines"}]. One scan; no line is ever
    split across blocks (the HDFS-block analog for local/NFS files)."""
    if lines_per_block <= 0:
        raise ValueError("lines_per_block must be positive")
    blocks: list[Block] = []
    start = 0
    lines = 0
    pos = 0
    last_byte = b"\n"
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            base = pos
            at = 0
            while True:
                nl = chunk.find(b"\n", at)
                if nl < 0:
                    break
                lines += 1
                at = nl + 1
                if lines == lines_per_block:
                    end = base + at
                    blocks.append({"id": len(blocks), "path": path,
                                   "offset": start, "nbytes": end - start,
                                   "lines": lines})
                    start, lines = end, 0
            pos += len(chunk)
            last_byte = chunk[-1:]
    if pos > start:  # tail; an unterminated final line still counts as one
        blocks.append({"id": len(blocks), "path": path, "offset": start,
                       "nbytes": pos - start,
                       "lines": lines + (last_byte != b"\n")})
    return blocks


def read_block_bytes(block: Block) -> bytes:
    """Read one ``split_file_lines`` block back as raw bytes (whole lines
    by construction) — feed to a mem parser without a splitlines pass."""
    with open(block["path"], "rb") as f:
        f.seek(block["offset"])
        return f.read(block["nbytes"])


def read_block_lines(block: Block) -> list[bytes]:
    """Read one ``split_file_lines`` block back as its lines."""
    return read_block_bytes(block).splitlines()


def iter_block_batches(client, parse_block, batch_size: int,
                       drop_last: bool = True):
    """Stream fixed-size batches out of dynamically assigned blocks — the
    out-of-core input pipeline for file-backed training (Criteo-1TB scale,
    SURVEY.md §7.4 item 4): ``parse_block(block) -> dict[str, np.ndarray]``
    materializes ONE block at a time; rows left over from a block carry into
    the next, so batch shape stays static for the device step regardless of
    block size. ``client`` is a BlockClient (or any iterable of blocks, e.g.
    a plain list for single-worker use)."""
    import numpy as np

    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    buf: Optional[dict] = None
    for block in client:
        d = parse_block(block)
        buf = d if buf is None else \
            {k: np.concatenate([buf[k], d[k]]) for k in buf}
        n = len(next(iter(buf.values())))
        s = 0
        while n - s >= batch_size:
            yield {k: v[s:s + batch_size] for k, v in buf.items()}
            s += batch_size
        buf = {k: v[s:] for k, v in buf.items()}
    if (not drop_last and buf is not None
            and len(next(iter(buf.values())))):
        yield buf  # ragged tail (eval sweeps; training wants drop_last)


class LocalBlockAssigner:
    """Thread-safe dynamic block queue with per-worker outstanding tracking
    (the in-process coordinator; workers are threads, SURVEY.md §4)."""

    def __init__(self, blocks: list[Block]):
        self._q: deque[Block] = deque(blocks)
        self._outstanding: dict[int, dict[int, Block]] = {}
        self._lock = threading.Lock()

    def next_block(self, worker: int = 0) -> Optional[Block]:
        """Pop the next block for ``worker`` (None when exhausted). The block
        stays outstanding until ``done`` or a ``requeue_worker``."""
        with self._lock:
            if not self._q:
                return None
            b = self._q.popleft()
            self._outstanding.setdefault(worker, {})[b["id"]] = b
            return b

    def done(self, worker: int, block_id: int) -> None:
        with self._lock:
            self._outstanding.get(worker, {}).pop(block_id, None)

    def requeue_worker(self, worker: int) -> int:
        """Return a dead worker's outstanding blocks to the queue (failure
        handling, SURVEY.md §5.3). Returns how many were re-queued."""
        with self._lock:
            stale = self._outstanding.pop(worker, {})
            self._q.extend(stale.values())
            return len(stale)

    @property
    def remaining(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def outstanding_total(self) -> int:
        """Blocks popped but not yet done/re-queued, across all workers."""
        with self._lock:
            return sum(len(v) for v in self._outstanding.values())


class BlockMaster:
    """Bus-side coordinator (runs on one process, conventionally id 0):
    serves ``blk_req`` with ``blk_asn`` and retires blocks on ``blk_done``.

    Assignment is idempotent per (sender, req): a client that never saw the
    reply (lost frame, slow master) retries the SAME req id and gets the
    SAME block back — without this, a timed-out request would strand its
    already-popped block on a live worker forever (never trained, never
    re-queued by ``handle_failure`` because the worker isn't dead).

    Exhaustion is answered with "wait, retry" for up to ``wait_grace``
    seconds while blocks are still outstanding on other workers: a dead
    holder's blocks come back via ``handle_failure`` within the heartbeat
    timeout, and answering None in that window would let survivors exit
    with those blocks stranded. The wait MUST be bounded: a live holder can
    be SSP-gate-blocked precisely because the starved requester stopped
    clocking — an unbounded wait is a three-way deadlock (requester waits
    for a block, holder's gate waits for the requester's clock)."""

    def __init__(self, bus, blocks: list[Block], wait_grace: float = 6.0):
        self.bus = bus
        self.assigner = LocalBlockAssigner(blocks)
        self.wait_grace = wait_grace
        # last (req, block) served per sender; client reqs are sequential,
        # so one entry per sender bounds memory
        self._last: dict[int, tuple] = {}
        self._wait_since: dict[int, float] = {}
        self._lock = threading.Lock()
        bus.on("blk_req", self._on_req)
        bus.on("blk_done", self._on_done)

    _WAIT = object()  # _last marker: this req was answered "retry later"

    def _on_req(self, sender: int, payload: dict) -> None:
        req = payload.get("req")
        with self._lock:
            last = self._last.get(sender)
            if last is not None and last[0] == req:
                block = last[1]  # duplicate request: re-serve, don't re-pop
                # a wait'd req must KEEP answering wait: the client has
                # moved on to a fresh req id, so popping a real block for
                # the stale id would be dropped as stale and stranded
                if block is self._WAIT:
                    self.bus.publish("blk_asn", {"to": sender, "req": req,
                                                 "wait": True})
                    return
            else:
                import time as _time

                block = self.assigner.next_block(sender)
                if (block is None
                        and self.assigner.outstanding_total > 0
                        and (_time.monotonic()
                             - self._wait_since.setdefault(
                                 sender, _time.monotonic()))
                        < self.wait_grace):
                    # queue empty but blocks are still OUT — a dead
                    # worker's come back via handle_failure within the
                    # heartbeat timeout, so retry for wait_grace; past
                    # that the holders are live (they will finish their
                    # own blocks) and the requester must be released to
                    # retire, or a gate-blocked holder deadlocks with it
                    self._last[sender] = (req, self._WAIT)
                    self.bus.publish("blk_asn", {"to": sender, "req": req,
                                                 "wait": True})
                    return
                if block is not None:
                    self._wait_since.pop(sender, None)
                self._last[sender] = (req, block)
        self.bus.publish("blk_asn", {"to": sender, "req": req,
                                     "block": block})

    def _on_done(self, sender: int, payload: dict) -> None:
        self.assigner.done(sender, payload.get("block_id"))

    def handle_failure(self, process_id: int) -> int:
        """Re-queue a dead process's outstanding blocks (wire this to the
        HeartbeatMonitor's on_failure)."""
        return self.assigner.requeue_worker(process_id)


class BlockClient:
    """Worker-side handle: ``next_block()`` asks the master for work;
    iteration drains until the master reports exhaustion."""

    def __init__(self, bus, *, local_master: Optional[BlockMaster] = None,
                 timeout: float = 30.0, retry_every: float = 1.0):
        self.bus = bus
        self.timeout = timeout
        self.retry_every = retry_every
        self._local = local_master
        self._req = 0
        self._waiting: Optional[int] = None
        self._replies: dict[int, Optional[Block]] = {}
        self._cond = threading.Condition()
        if local_master is None:
            bus.on("blk_asn", self._on_asn)

    def _on_asn(self, sender: int, payload: dict) -> None:
        if payload.get("to") != self.bus.my_id:
            return  # assignment addressed to another worker
        with self._cond:
            if payload.get("req") != self._waiting:
                return  # stale reply for an abandoned request: don't leak
            self._replies[payload.get("req")] = payload
            self._cond.notify_all()

    def next_block(self) -> Optional[Block]:
        """Next block, or None when the master's queue is exhausted. The
        request is re-published every ``retry_every`` seconds until answered
        (the master re-serves duplicates idempotently), so a lost frame
        costs latency, not a block."""
        import time

        if self._local is not None:
            # same bounded wait as the master gives remote clients
            deadline = time.monotonic() + self._local.wait_grace
            while True:
                b = self._local.assigner.next_block(self.bus.my_id)
                if (b is None
                        and self._local.assigner.outstanding_total > 0
                        and time.monotonic() < deadline):
                    time.sleep(min(self.retry_every, 0.25))
                    continue
                return b
        deadline = time.monotonic() + self.timeout
        while True:
            with self._cond:
                self._req += 1
                req = self._req
                self._waiting = req
            try:
                reply = None
                while reply is None:
                    self.bus.publish("blk_req", {"req": req})
                    with self._cond:
                        if self._cond.wait_for(
                                lambda: req in self._replies,
                                min(self.retry_every,
                                    max(deadline - time.monotonic(),
                                        0.01))):
                            reply = self._replies.pop(req)
                    if reply is None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"block request {req} unanswered after "
                            f"{self.timeout}s (master process dead?)")
            finally:
                with self._cond:
                    self._waiting = None
            if not reply.get("wait"):
                return reply.get("block")
            # queue empty but blocks outstanding elsewhere: retry with a
            # FRESH req id (the master served this one) until they either
            # come back (dead-worker re-queue) or all complete
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "block queue drained but blocks still outstanding "
                    f"after {self.timeout}s")
            time.sleep(self.retry_every)

    def done(self, block: Block) -> None:
        if self._local is not None:
            self._local.assigner.done(self.bus.my_id, block["id"])
        else:
            self.bus.publish("blk_done", {"block_id": block["id"]})

    def __iter__(self) -> Iterator[Block]:
        """Drain: yields blocks and acks each one after the loop body ran
        (ack-on-next-yield keeps at most one block outstanding per worker).

        Deliberately NOT ack-on-close: a consumer that stops early —
        whether by ``break`` or because its step raised — reaches the
        generator identically as GeneratorExit, and acking there would
        retire a block a FAILING worker never trained, so handle_failure
        could not re-queue it (silent data loss). Leaving it outstanding
        costs the benign break case at most the master's bounded
        ``wait_grace`` before peers see true exhaustion."""
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b
            self.done(b)
