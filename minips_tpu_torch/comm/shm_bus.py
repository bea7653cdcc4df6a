"""ShmControlBus — same-host shared-memory ring transport.

Every bench arm in this repo runs on loopback, where the zmq path pays
for each frame several times over: encode into a Python bytes, copy into
zmq's send buffer, two kernel crossings through the TCP stack, copy out
of zmq's receive queue. This backend deletes all of it for colocated
ranks: one single-producer single-consumer byte ring per ordered link
``(i → j)``, mapped by both ends from the same tmpfs pages, with the
encoded head and the ndarray blob written DIRECTLY into the ring (no
intermediate concatenation, no socket, no syscall on the hot path) and
read back as buffer views.

Select with ``make_bus(..., backend="shm")`` or ``MINIPS_BUS=shm``.
Exact ``ControlBus`` interface — ``ClockGossip``, ``BlobExchange``,
``HeartbeatMonitor``, the sharded PS, and the chaos/reliable/trace
layers run unchanged (``make_bus`` stacks them identically on all
backends; frames decode through the same ``deliver_frame`` chain).

**Ring layout.** Each link is one file (``/dev/shm`` when present) of
``64 + capacity`` bytes: a 64-byte header holding the producer cursor
(``head``), consumer cursor (``tail``) — both monotonically increasing
byte offsets, position = cursor % capacity — a ``sleeping`` flag, and
an init magic written LAST so attachers never see a half-built ring.
Records are length-prefixed and always contiguous: a record that would
straddle the wrap point writes a wrap marker and restarts at offset 0.
SPSC discipline is what makes this safe without locks: the producer
writes data then publishes ``head``; the consumer reads data then
publishes ``tail``; each 8-byte cursor store is aligned (single-copy
atomic). The data-then-cursor ORDER across processes is an x86-TSO
property (total store order: a store is never visible before an
earlier one) — pure Python can emit no release fence, so on a
weakly-ordered CPU (aarch64) the consumer could observe the new head
before the record bytes. Construction therefore REFUSES non-x86 hosts
loudly (``MINIPS_BUS=zmq``/``native`` are the portable answers) rather
than delivering torn frames that only a memory model can explain.

Within the producer process, multiple sender threads are ordered by
per-ring write tickets issued under the seq lock in stamp order, so
ring order == seq order per link while the seq lock is NEVER held
across a full ring's backpressure wait (see ``_emit``/``_write``).

**Doorbell.** Receivers must block, not spin (2-core CI hosts — a
spinning receiver steals the timeslices the workload needs). Each rank
owns one named FIFO; a receiver that drains every inbound ring empty
sets the ``sleeping`` flag on each, re-checks, then parks in ``select``
on the FIFO. A producer that publishes into a ring whose consumer
advertises ``sleeping`` writes one byte into the FIFO (nonblocking —
a full pipe already IS a pending doorbell). The classic store-load
race (flag set between the producer's head-publish and its flag-read)
is bounded by the 50 ms select timeout, the same worst-case latency
the zmq backend's poll loop has.

**Backpressure-when-full.** A producer whose ring lacks space BLOCKS
(escalating sleep) up to ``send_timeout`` — the native bounded-outbox
semantics, stricter than zmq's silent HWM drop — then counts the frame
in ``send_drops`` (never silently lost; the receiver's loss tracker
books the seq gap too). A single frame may not exceed half the ring
(``ValueError`` at the source, like the native protocol caps): beyond
that, producer and consumer could deadlock on wrap padding. One
exception: a send issued from the RECV thread (handler replies, the
reliable layer's NACK/retransmit traffic) blocks only
``recv_send_timeout`` (250 ms) — while it waits it is not draining
inbound rings, so two ranks' recv threads stuck writing into each
other's full ring would otherwise stall symmetrically for the full
budget; the short bound breaks the cycle and the counted drop is
recoverable (journal + NACK under ``MINIPS_RELIABLE``, the pull
deadline poison without it).

**Segment lifecycle.** Rank ``j`` CREATES its inbound rings (``i→j``
for every i) and its doorbell at construction; producers attach by
name in ``start()``, retrying until the init magic appears (processes
boot in arbitrary order). Names carry ``MINIPS_RUN_ID`` (the launcher
pid) plus a digest of the job's port list, so a relaunch never attaches
a crashed run's stale ring; ``close()`` unlinks what the rank created
(mapped pages live until the last attacher drops them — POSIX), and
:func:`sweep_stale_segments` (called by the launcher before spawning,
like the sample store's sweeper) reclaims segments whose run is dead.

Knobs: ``MINIPS_SHM_RING`` — ring capacity in bytes per link (default
8 MiB); ``MINIPS_WIRE_FMT`` — head codec, shared with every backend.

A copy of ``minips_tpu/comm/shm_bus.py``, which imports no JAX.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import platform
import select
import struct
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Optional

from minips_tpu_torch.comm.bus import (FrameLossTracker, deliver_frame,
                                 dispatch_parsed, run_handshake,
                                 stop_bus_layers)
from minips_tpu_torch.comm.framing import (dup_msg, encode_head, rt_wrap,
                                     wire_fmt_from_env)

__all__ = ["ShmControlBus", "sweep_stale_segments"]

_PREFIX = "minips_bus"
_HDR = 64                      # ring file: header bytes before the data
_OFF_HEAD = 0                  # u64 producer cursor
_OFF_TAIL = 8                  # u64 consumer cursor
_OFF_CAP = 16                  # u64 data capacity
_OFF_SLEEP = 24                # u64 consumer-sleeping flag
_OFF_MAGIC = 32                # u64, written last by the creator
_MAGIC = 0x314D4853_53504D31   # "1MPS" "SHM1"
_WRAP = 0xFFFFFFFF             # u32 wrap marker in the length slot
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

DEFAULT_RING = 8 << 20         # per-link capacity ($MINIPS_SHM_RING)


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _parse_port(addr: str) -> str:
    return addr.rsplit(":", 1)[-1]


def _namespace(my_addr: str, peer_addrs: list[str]) -> str:
    """Identical on every rank of one job: run id (launcher pid — the
    sweeper's liveness key) + a digest of the job's full port list (the
    launcher hands every rank the same MINIPS_BUS_ADDRS; ports are
    OS-randomized per job, so two concurrent jobs never collide). The
    launcher always sets MINIPS_RUN_ID; the fallback (this pid) covers
    in-proc threads-as-nodes tests, whose ranks share the process —
    either way the run token is a live pid the sweeper can check."""
    run = os.environ.get("MINIPS_RUN_ID") or str(os.getpid())
    ports = sorted(_parse_port(a) for a in [my_addr, *peer_addrs])
    dig = hashlib.md5(",".join(ports).encode()).hexdigest()[:8]
    return f"{run}_{dig}"


def _ring_path(ns: str, src: int, dst: int) -> str:
    return os.path.join(_shm_dir(), f"{_PREFIX}_{ns}_{src}to{dst}.ring")


def _doorbell_path(ns: str, rank: int) -> str:
    return os.path.join(_shm_dir(), f"{_PREFIX}_{ns}_{rank}.doorbell")


def _pid_alive(pid: int) -> bool:
    """Portable liveness probe — /proc is Linux-only, and this module
    deliberately runs on macOS x86-64 too (the tempdir fallback above):
    a /proc check there reads EVERY run as dead and the sweeper would
    unlink a live job's rings out from under it. Signal 0 probes
    without sending; EPERM means alive-but-not-ours."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def sweep_stale_segments(directory: Optional[str] = None) -> int:
    """Delete bus segments whose run (MINIPS_RUN_ID = launcher pid) is
    dead — a SIGKILLed job never unlinks its rings, and tmpfs pages are
    host RAM. Same contract as data/shm_store.sweep_stale_segments;
    the launcher calls both before spawning. Returns #files removed."""
    directory = directory or _shm_dir()
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    for name in entries:
        if not name.startswith(_PREFIX + "_"):
            continue
        run = name[len(_PREFIX) + 1:].split("_", 1)[0]
        if not run.isdigit() or _pid_alive(int(run)):
            continue  # non-pid namespace (tests) or launcher still alive
        try:
            os.unlink(os.path.join(directory, name))
            removed += 1
        except OSError:
            pass
    return removed


class _Ring:
    """One mapped SPSC ring. The creator (consumer side) builds the
    file; the attacher (producer side) maps it by name once the init
    magic lands."""

    def __init__(self, path: str, mm: mmap.mmap, created: bool):
        self.path = path
        self.mm = mm
        self.buf = memoryview(mm)
        # header slots as a cast('Q') view: item get/set compiles to one
        # aligned 8-byte memcpy (a single mov on x86-64) — struct's
        # standard-format pack_into/unpack_from moves standard-layout
        # fields BYTE AT A TIME, so a peer polling a cursor mid-store
        # could assemble a torn value (old-low/new-high reads ABOVE the
        # committed head and the consumer parses unwritten bytes)
        self._hdr = self.buf[:_HDR].cast("Q")
        self.cap = self._hdr[_OFF_CAP // 8]
        self.created = created
        # producer-side write scheduling (meaningful on tx rings):
        # tickets are issued under the bus seq lock in stamp order and
        # served strictly in ticket order, so ring order == seq order
        # per link without holding the seq lock across backpressure.
        # ``abandoned`` holds tickets whose owner gave up waiting for
        # its turn (budget expired behind a blocked predecessor): the
        # finishing predecessor skips them when advancing served.
        self.wcond = threading.Condition()
        self.ticket_next = 0
        self.ticket_served = 0
        self.abandoned: set = set()

    @classmethod
    def create(cls, path: str, cap: int) -> "_Ring":
        # unlink-then-create: a stale same-name file (crashed run whose
        # sweeper has not fired) must not leak its cursors into this run
        try:
            os.unlink(path)
        except OSError:
            pass
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, _HDR + cap)
            mm = mmap.mmap(fd, _HDR + cap)
        finally:
            os.close(fd)
        _U64.pack_into(mm, _OFF_CAP, cap)
        _U64.pack_into(mm, _OFF_MAGIC, _MAGIC)  # last: ring is now live
        return cls(path, mm, created=True)

    @classmethod
    def attach(cls, path: str, deadline: float) -> "_Ring":
        while True:
            try:
                fd = os.open(path, os.O_RDWR)
            except FileNotFoundError:
                fd = -1
            if fd >= 0:
                try:
                    size = os.fstat(fd).st_size
                    if size > _HDR:
                        mm = mmap.mmap(fd, size)
                        if _U64.unpack_from(mm, _OFF_MAGIC)[0] == _MAGIC:
                            return cls(path, mm, created=False)
                        mm.close()
                finally:
                    os.close(fd)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shm bus: ring {path} never appeared — is the peer "
                    "on this host and on MINIPS_BUS=shm?")
            time.sleep(0.01)

    # cursor accessors — each is ONE aligned 8-byte load/store through
    # the cast('Q') header view (single-copy atomic on x86-64); SPSC
    # means each side only ever STORES one of them
    def head(self) -> int:
        return self._hdr[_OFF_HEAD // 8]

    def tail(self) -> int:
        return self._hdr[_OFF_TAIL // 8]

    def set_head(self, v: int) -> None:
        self._hdr[_OFF_HEAD // 8] = v

    def set_tail(self, v: int) -> None:
        self._hdr[_OFF_TAIL // 8] = v

    def sleeping(self) -> bool:
        return self._hdr[_OFF_SLEEP // 8] != 0

    def set_sleeping(self, v: bool) -> None:
        self._hdr[_OFF_SLEEP // 8] = 1 if v else 0

    def close(self) -> None:
        try:
            self._hdr.release()
            self.buf.release()
            self.mm.close()
        except (BufferError, ValueError):
            # a recv thread that outlived its join still holds views
            # into the map (mid-_drain_ring); the pages drop with the
            # process — but the FILE must not outlive us, so fall
            # through to the unlink either way (the /dev/shm hygiene
            # contract: a live-pid leak is invisible to the sweeper)
            pass
        if self.created:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmControlBus:
    """``ControlBus``-shaped bus over per-link shared-memory rings.
    Same-host only by construction (the ring files live in this host's
    tmpfs); a cross-host job selects zmq/native instead.

    Unlike zmq/native (which refuse a directed send to self — a PUB
    socket would have to loop a frame through the kernel to deliver
    it), this backend accepts ``send(my_id, ...)`` as an IN-PROCESS
    LOOPBACK: the decoded head and blob go straight onto a local queue
    the recv thread drains ahead of the rings — no codec round-trip,
    no ring, no syscall (``loopback_frames`` counts them; they are
    deliberately absent from ``bytes_sent`` — nothing crossed a wire).
    Handlers still run on the recv thread (their locking assumes it),
    per-caller FIFO holds (one deque), and the chaos/reliable layers
    are bypassed by design: a function call is not a wire, so there is
    nothing to drop or retransmit — the serving plane's self-shed path
    (serve/plane.py) is the consumer, probing ``supports_loopback``."""

    supports_loopback = True

    def __init__(self, my_addr: str, peer_addrs: list[str], my_id: int = 0,
                 connect_timeout: float = 15.0,
                 wire_fmt: Optional[str] = None,
                 ring_bytes: Optional[int] = None):
        mach = platform.machine().lower()
        if mach not in ("x86_64", "amd64"):
            raise RuntimeError(
                f"MINIPS_BUS=shm requires a 64-bit x86 (TSO) host; this "
                f"machine is {mach!r}. The pure-Python ring protocol "
                "publishes the head cursor with a plain aligned 8-byte "
                "store and relies on total store order to keep it behind "
                "the record bytes — a weakly-ordered CPU may deliver torn "
                "frames, and a 32-bit CPU splits the 8-byte cursor store "
                "itself (two 4-byte moves: a peer can read a torn "
                "cursor). Use MINIPS_BUS=zmq or MINIPS_BUS=native on "
                "this host.")
        self.my_id = my_id
        self.wire_fmt = wire_fmt or wire_fmt_from_env()
        self.bytes_sent = 0
        self.send_drops = 0
        self.loss = FrameLossTracker()
        self._n_world = len(peer_addrs) + 1
        self._bseq = 0                       # broadcast-stream seq
        self._dseq = [0] * self._n_world     # per-dest directed seq
        self._peers = [r for r in range(self._n_world) if r != my_id]
        self._ns = _namespace(my_addr, peer_addrs)
        # explicit-empty = default, like MINIPS_BUS / MINIPS_WIRE_FMT
        # (bench arms pin "" to keep an armed environment from leaking)
        self._cap = int(ring_bytes
                        or os.environ.get("MINIPS_SHM_RING", "").strip()
                        or DEFAULT_RING)
        if self._cap < 1 << 16:
            raise ValueError("MINIPS_SHM_RING below 64KiB")
        self._max_rec = self._cap // 2 - 16  # wrap-padding deadlock bound
        self._connect_timeout = connect_timeout
        self.send_timeout = 30.0             # backpressure bound (native's)
        # a send issued FROM the recv thread (handler replies, reliable
        # NACK/retransmit) gets a much shorter budget: while it waits —
        # for ring space or for its write turn — it is not draining
        # inbound rings, so two ranks whose recv threads are both stuck
        # writing into each other's full ring would stall symmetrically
        # for the whole send_timeout — neither consumer runs until both
        # give up. The short budget breaks the cycle; the drop is
        # counted, the frame is already journaled (NACK → retransmit
        # recovers it under MINIPS_RELIABLE), and without the reliable
        # layer the receiver books the seq gap — zmq's HWM-overflow
        # semantics, made loud.
        self.recv_send_timeout = 0.25
        # threads beyond the recv thread whose send stall would ALSO stop
        # inbound frames from draining get the same short budget — the
        # reliable repair thread dispatches recovered frames' handlers
        # while holding the channel lock on_stamped needs, so its
        # 30s-blocked send would transitively park the recv thread and
        # re-form the symmetric two-rank stall one lock up
        self._drain_critical: set = set()
        self._handlers: dict[str, Callable[[int, dict], None]] = {}
        # the in-process loopback lane (send-to-self): deque append /
        # popleft are GIL-atomic, so the recv thread drains without a
        # lock; loopback frames never touch a ring or the seq space
        self._loop: deque = deque()
        self.loopback_frames = 0
        self._seq_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # inbound side exists from construction: producers attach to it
        self._rx: dict[int, _Ring] = {
            src: _Ring.create(_ring_path(self._ns, src, my_id), self._cap)
            for src in self._peers}
        self._db_path = _doorbell_path(self._ns, my_id)
        try:
            os.unlink(self._db_path)
        except OSError:
            pass
        os.mkfifo(self._db_path, 0o600)
        # O_RDWR (self-pipe idiom), not O_RDONLY: a FIFO with zero
        # writers sits at permanent EOF — select() would return
        # readable instantly and the recv loop would busy-spin through
        # the whole window before peers' start() (and after their
        # close()). Holding our own write end keeps the pipe never-EOF,
        # so select genuinely blocks until a doorbell byte arrives.
        self._db_r = os.open(self._db_path, os.O_RDWR | os.O_NONBLOCK)
        self._tx: dict[int, _Ring] = {}      # dst -> ring (filled in start)
        self._db_w: dict[int, int] = {}      # dst -> doorbell write fd

    @property
    def port(self) -> int:  # interface parity; meaningless for shm
        return -1

    def on(self, kind: str, handler: Callable[[int, dict], None]) -> None:
        self._handlers[kind] = handler

    def start(self) -> "ShmControlBus":
        deadline = time.monotonic() + self._connect_timeout
        for dst in self._peers:
            self._tx[dst] = _Ring.attach(
                _ring_path(self._ns, self.my_id, dst), deadline)
        for dst in self._peers:
            self._db_w[dst] = self._open_doorbell(
                _doorbell_path(self._ns, dst), deadline)
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _open_doorbell(path: str, deadline: float) -> int:
        while True:
            try:
                return os.open(path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError:  # ENOENT/ENXIO: peer not constructed yet
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shm bus: doorbell {path} never appeared")
                time.sleep(0.01)

    def note_drain_critical(self, thread: threading.Thread) -> None:
        """Register a thread whose send stall would stop inbound frames
        from draining (beyond the bus's own recv thread): its sends get
        ``recv_send_timeout`` instead of the full backpressure budget.
        The reliable layer registers its repair thread — pump's _drain
        dispatches recovered frames' handlers while holding the channel
        lock the recv thread's on_stamped needs, so a 30s-blocked
        handler reply there parks inbound draining transitively. The
        short-budget drop is counted and journal+NACK-recoverable,
        exactly like a recv-thread send drop."""
        self._drain_critical.add(thread)

    # ------------------------------------------------------------- send
    def publish(self, kind: str, payload: dict,
                blob: Optional[bytes] = None) -> None:
        """Fan out to every peer's inbound ring. Like the native
        backend: nonblocking until a ring is full, then producer
        backpressure (bounded), then a counted drop."""
        self._emit(-1, kind, payload, blob)

    def send(self, dest: int, kind: str, payload: dict,
             blob: Optional[bytes] = None) -> None:
        if not 0 <= dest < self._n_world:
            raise ValueError(f"dest rank {dest} out of range")
        if dest == self.my_id:
            self._emit_loopback(kind, payload, blob)
            return
        self._emit(dest, kind, payload, blob)

    def _emit_loopback(self, kind: str, payload: dict,
                       blob: Optional[bytes]) -> None:
        """rank→self without the ring round-trip: the payload is
        deep-copied with the codec's own semantics (``dup_msg`` — the
        handler may mutate it, and dispatch attaches ``__blob__``) and
        the blob MATERIALIZED (a handler may retain it past a caller's
        buffer reuse, the same retention contract the ring's copy-out
        gives), then queued for the recv thread — handler threading
        identical to a wire frame, zero codec/ring/syscall cost."""
        if self._closed:
            return
        head = {"kind": kind, "sender": self.my_id,
                "payload": dup_msg(payload)}
        self._loop.append(
            (head, bytes(blob) if blob is not None else None))
        self.loopback_frames += 1
        try:  # wake a parked recv thread: our own RDWR fd is a writer
            os.write(self._db_r, b"x")
        except (BlockingIOError, OSError):
            pass  # full pipe = doorbell already pending

    def _emit(self, dest: int, kind: str, payload: dict,
              blob: Optional[bytes]) -> None:
        head = {"kind": kind, "sender": self.my_id, "payload": payload}
        blen = 0 if blob is None else len(blob)
        cur = threading.current_thread()
        budget = (self.recv_send_timeout
                  if cur is self._thread or cur in self._drain_critical
                  else self.send_timeout)
        with self._seq_lock:
            if self._closed:
                return  # post-close publish: silent no-op (zmq parity)
            # stamp AND take per-ring write tickets under the seq lock:
            # ring order must equal seq order per link (the zmq/native
            # backends' invariant) — but the lock is NEVER held across
            # a full ring's backpressure wait (a blocked producer
            # holding it would stall every other sender on the lock
            # itself, where no per-thread budget can apply; the recv
            # thread stuck there stops draining inbound rings and the
            # symmetric two-rank stall re-forms one level up)
            if not kind.startswith("__"):
                if dest < 0:
                    head["bs"] = self._bseq
                    self._bseq += 1
                else:
                    head["ds"] = self._dseq[dest]
                    self._dseq[dest] += 1
            msg = encode_head(head, self.wire_fmt)
            rec = 4 + len(msg) + 8 + blen   # u32 hlen | head | u64 | blob
            rel = getattr(self, "reliable", None)
            journaled = rel is not None and ("bs" in head or "ds" in head)
            if journaled and 4 + rec + len(msg) + 96 > self._max_rec:
                # A journaled frame may be re-shipped wrapped as the
                # reliable layer's __rt {"m"/"m2": <head bytes>}, which
                # adds head bytes — the RETRANSMIT record must fit the
                # cap too, or a frame that fit at first send is
                # permanently unretransmittable (the NACK-path
                # ValueError lands on the recv thread where dispatch
                # swallows it, and the stream stalls to give-up).
                # Coarse bound first (JSON escaping at most doubles the
                # head; TLV adds a constant), the exact wrapper size
                # only when that bound crosses the cap.
                wmsg = encode_head({"kind": "__rt", "sender": self.my_id,
                                    "payload": rt_wrap(msg)}, self.wire_fmt)
                rec = max(rec, 4 + len(wmsg) + 8 + blen)
            if 4 + rec > self._max_rec:
                # un-stamp before raising — the native backend's
                # validate-before-stamp ordering, achieved by rollback
                # (nothing journaled or written yet, and the seq lock is
                # still held): a raise after the increment would leave a
                # permanent stream gap the receiver books as wire loss
                if "bs" in head:
                    self._bseq -= 1
                elif "ds" in head:
                    self._dseq[dest] -= 1
                raise ValueError(
                    f"frame {rec}B exceeds the shm ring's {self._max_rec}B "
                    "record cap (raise MINIPS_SHM_RING)")
            if journaled:
                rel.journal_stamped(
                    "b" if "bs" in head else "d",
                    -1 if "bs" in head else dest,
                    head.get("bs", head.get("ds")), msg, blob)
            targets = self._peers if dest < 0 else (dest,)
            plan = []
            for dst in targets:
                ring = self._tx[dst]
                plan.append((dst, ring, ring.ticket_next))
                ring.ticket_next += 1
            self.bytes_sent += len(msg) + blen
        # ONE deadline for the whole fan-out (a broadcast must not pay
        # send_timeout per peer), spent outside the seq lock
        deadline = time.monotonic() + budget
        for dst, ring, ticket in plan:
            self._write(ring, dst, ticket, msg, blob, blen, deadline)

    def _write(self, ring: _Ring, dst: int, ticket: int, msg: bytes,
               blob, blen: int, deadline: float) -> None:
        """Wait for this frame's per-ring turn (tickets are issued in
        stamp order), then write. A thread whose budget expires while a
        predecessor sits out its own backpressure wait ABANDONS its
        ticket (counted drop; the predecessor skips it when advancing),
        so a recv-thread send is bounded by recv_send_timeout on every
        path — turn wait and ring wait alike."""
        with ring.wcond:
            while ring.ticket_served != ticket:
                if time.monotonic() > deadline or self._stop.is_set():
                    ring.abandoned.add(ticket)
                    self.send_drops += 1  # counted, never silent — and
                    return  # the receiver books the seq gap too
                ring.wcond.wait(0.05)
        # our turn: the ring-space wait and the record write run
        # OUTSIDE the condition lock — a writer sleeping through
        # backpressure while holding it would block every waiter's
        # deadline check (cond.wait must reacquire the lock to return).
        # Turn ownership (ticket_served == ticket) is exclusive and
        # only we advance it, so the SPSC write discipline holds.
        try:
            self._write_record(ring, dst, msg, blob, blen, deadline)
        finally:
            with ring.wcond:
                served = ticket + 1
                while served in ring.abandoned:
                    ring.abandoned.discard(served)
                    served += 1
                ring.ticket_served = served
                ring.wcond.notify_all()

    def _write_record(self, ring: _Ring, dst: int, msg: bytes,
                      blob, blen: int, deadline: float) -> None:
        """Reserve space (bounded blocking backpressure), write the
        record CONTIGUOUSLY (wrap-marker pad when needed), publish
        head, ring the doorbell if the consumer sleeps."""
        need = 4 + 4 + len(msg) + 8 + blen      # len slot + payload
        cap = ring.cap
        h = ring.head()
        sleep_s = 0.0002
        while True:
            pos = h % cap
            contig = cap - pos
            total = need if need <= contig else contig + need
            if total <= cap - (h - ring.tail()):
                break
            if time.monotonic() > deadline or self._stop.is_set():
                self.send_drops += 1  # counted, never silent — and the
                return                # receiver books the seq gap too
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, 0.002)
        buf = ring.mm
        if need > contig:
            if contig >= 4:
                _U32.pack_into(buf, _HDR + pos, _WRAP)
            h += contig
            pos = 0
        plen = need - 4
        _U32.pack_into(buf, _HDR + pos, plen)
        o = _HDR + pos + 4
        _U32.pack_into(buf, o, len(msg))
        o += 4
        buf[o:o + len(msg)] = msg
        o += len(msg)
        _U64.pack_into(buf, o, blen + 1 if blob is not None else 0)
        o += 8
        if blen:
            # the zero-intermediate-copy write: bytes/memoryview blobs
            # land straight in the ring (one memcpy from the source)
            buf[o:o + blen] = blob
        ring.set_head(h + need)                  # publish AFTER the data
        if ring.sleeping():
            try:
                os.write(self._db_w[dst], b"x")
            except (BlockingIOError, OSError):
                pass  # full pipe = doorbell already pending; torn peer
                # = its rings are dead anyway (heartbeats own that story)

    # ---------------------------------------------------------- receive
    def _drain_ring(self, src: int, ring: _Ring) -> int:
        """Consume every complete record currently in ``src``'s ring;
        returns #frames dispatched. Bytes are COPIED out before the tail
        advances (handlers may retain the blob past the ring slot's
        recycling)."""
        n = 0
        cap = ring.cap
        buf = ring.buf
        t = ring.tail()
        while t != ring.head():
            pos = t % cap
            contig = cap - pos
            if contig < 4:
                t += contig
                continue
            plen = _U32.unpack_from(buf, _HDR + pos)[0]
            if plen == _WRAP:
                t += contig
                continue
            o = _HDR + pos + 4
            hlen = _U32.unpack_from(buf, o)[0]
            o += 4
            raw = bytes(buf[o:o + hlen])
            o += hlen
            bflag = _U64.unpack_from(buf, o)[0]
            o += 8
            blob = bytes(buf[o:o + bflag - 1]) if bflag else None
            ring.set_tail(t + 4 + plen)          # free BEFORE dispatch:
            t = t + 4 + plen                     # a slow handler must not
            n += 1                               # backpressure the wire
            deliver_frame(self, raw, blob)
        return n

    def _drain_loopback(self) -> int:
        """Dispatch queued rank→self frames (the loopback lane) — on
        THIS thread, like every ring frame, so handler locking sees one
        delivery context whichever lane a frame took."""
        n = 0
        while True:
            try:
                head, blob = self._loop.popleft()
            except IndexError:
                return n
            n += 1
            dispatch_parsed(self._handlers, head, blob, loss=self.loss)

    def _recv_loop(self) -> None:
        rings = sorted(self._rx.items())
        while not self._stop.is_set():
            got = self._drain_loopback()
            for src, ring in rings:
                got += self._drain_ring(src, ring)
            if got:
                continue
            # nothing anywhere: advertise sleep, re-check (the producer
            # reads the flag AFTER publishing head), then park on the
            # doorbell — bounded by the same 50ms the zmq poll loop uses
            for _src, ring in rings:
                ring.set_sleeping(True)
            try:
                if self._loop \
                        or any(r.tail() != r.head() for _s, r in rings):
                    continue
                try:
                    rd, _, _ = select.select([self._db_r], [], [], 0.05)
                except OSError:
                    return  # fd torn down under us: closing
                if rd:
                    try:
                        os.read(self._db_r, 4096)  # drain the doorbell
                    except OSError:
                        pass
            finally:
                for _src, ring in rings:
                    ring.set_sleeping(False)

    # ----------------------------------------------------- observability
    def out_queue_depth(self) -> int:
        """Deepest outbound ring backlog in BYTES (frames are not
        tracked per ring; bytes are what backpressure acts on)."""
        if self._closed:
            return 0
        return max((r.head() - r.tail() for r in self._tx.values()),
                   default=0)

    @property
    def frames_lost(self) -> int:
        return self.loss.lost

    @property
    def frames_malformed(self) -> int:
        return self.loss.malformed

    def handshake(self, num_processes: int, timeout: float = 15.0) -> None:
        """Rings are lossless once attached, but a peer may publish
        before OUR attach to its ring finished — same rendezvous as the
        other backends (and the drills rely on its barrier)."""
        run_handshake(self, num_processes, timeout)

    def close(self) -> None:
        stop_bus_layers(self)  # chaos scheduler + reliable repair thread
        # _stop BEFORE the seq lock: producers blocked in a ring's
        # backpressure or turn wait (outside the lock, see _write)
        # break out on the stop flag (the frame counts as dropped;
        # teardown is an error path, the native backend's contract)
        self._stop.set()
        with self._seq_lock:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        for ring in self._tx.values():
            ring.close()
        for ring in self._rx.values():
            ring.close()
        for fd in self._db_w.values():
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            os.close(self._db_r)
        except OSError:
            pass
        try:
            os.unlink(self._db_path)
        except OSError:
            pass

    def __enter__(self) -> "ShmControlBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
