"""NativeControlBus — ctypes binding for the C++ TCP mailbox.

The reference's Mailbox is native C++ (ZeroMQ ROUTER/DEALER + per-thread
``ThreadsafeQueue`` inboxes + a Sender actor; SURVEY.md L0/L1, §2.3). This
is the rebuild's native-runtime equivalent for the surviving control plane:
``cpp/mailbox.cpp`` implements the transport (raw TCP full mesh, framed
messages, a C++ ThreadsafeQueue inbox, reader actors per connection, a
Sender actor draining an outgoing queue), and this module is the thin
Python skin exposing the exact ``ControlBus`` interface so ``ClockGossip``,
``HeartbeatMonitor``, ``BlockMaster`` etc. run unchanged on either backend.

Select with ``make_bus(..., backend="native")`` or ``MINIPS_BUS=native``.
Like the native data readers, the library builds lazily on first use and
callers degrade to the zmq backend when no compiler is available.

A copy of ``minips_tpu/comm/native_bus.py``, which imports no JAX.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional

from minips_tpu_torch.comm.bus import deliver_frame, stop_bus_layers
from minips_tpu_torch.comm.framing import encode_head, wire_fmt_from_env
from minips_tpu_torch.utils.native_lib import load_native_lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.mailbox_create.argtypes = [ctypes.c_int]
    lib.mailbox_create.restype = ctypes.c_void_p
    lib.mailbox_port.argtypes = [ctypes.c_void_p]
    lib.mailbox_port.restype = ctypes.c_int
    lib.mailbox_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int]
    lib.mailbox_connect.restype = ctypes.c_int
    lib.mailbox_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.mailbox_publish.restype = None
    lib.mailbox_send.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.mailbox_send.restype = None
    lib.mailbox_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mailbox_recv.restype = ctypes.c_int
    lib.mailbox_free_buf.argtypes = [ctypes.c_void_p]
    lib.mailbox_free_buf.restype = None
    lib.mailbox_close.argtypes = [ctypes.c_void_p]
    lib.mailbox_close.restype = None
    lib.mailbox_outbox_depth.argtypes = [ctypes.c_void_p]
    lib.mailbox_outbox_depth.restype = ctypes.c_int64
    lib.mailbox_dropped.argtypes = [ctypes.c_void_p]
    lib.mailbox_dropped.restype = ctypes.c_int64
    lib.mailbox_set_outbox_cap.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mailbox_set_outbox_cap.restype = None
    lib.mailbox_interrupt.argtypes = [ctypes.c_void_p]
    lib.mailbox_interrupt.restype = None


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libminips_comm.so", _declare)


def _parse_addr(addr: str) -> tuple[str, int]:
    """``tcp://host:port`` → (IPv4, port); hostnames (``localhost``,
    hostfile names) resolve here so the C side only sees literals."""
    import socket

    hostport = addr.split("//", 1)[-1]
    host, port = hostport.rsplit(":", 1)
    if host in ("*", "0.0.0.0", ""):
        return "0.0.0.0", int(port)
    try:
        socket.inet_aton(host)
    except OSError:
        host = socket.gethostbyname(host)
    return host, int(port)


class NativeControlBus:
    """Same interface as ``ControlBus`` (on/start/publish/handshake/close),
    backed by the C++ mailbox instead of pyzmq. Fan-out happens over the
    full mesh of outgoing TCP connections made in ``start()``."""

    def __init__(self, my_addr: str, peer_addrs: list[str], my_id: int = 0,
                 connect_timeout: float = 15.0,
                 wire_fmt: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native mailbox library unavailable")
        from minips_tpu_torch.comm.bus import FrameLossTracker

        self.my_id = my_id
        self.wire_fmt = wire_fmt or wire_fmt_from_env()
        self.bytes_sent = 0
        self.loss = FrameLossTracker()
        self._n_world = len(peer_addrs) + 1
        self._bseq = 0                       # broadcast-stream seq
        self._dseq = [0] * self._n_world     # per-dest directed seq
        self._lib = lib
        _, port = _parse_addr(my_addr)
        self._h = lib.mailbox_create(port)
        if not self._h:
            raise OSError(f"mailbox_create: cannot bind {my_addr}")
        self._peer_addrs = [_parse_addr(a) for a in peer_addrs]
        self._connect_timeout = connect_timeout
        self._handlers: dict[str, Callable[[int, dict], None]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # TWO locks, two concerns:
        # - _seq_lock holds across stamp AND the C enqueue, so wire order
        #   equals seq order even with concurrent publishers (a stamped-
        #   then-preempted frame enqueued late would read as phantom
        #   wire loss at every receiver).
        # - _life (condition) tracks handle liveness + in-flight C calls:
        #   close() interrupts pending bounded pushes, waits the count to
        #   zero, then frees the handle — no use-after-free, and depth/
        #   drop observability never queues behind a 30s backpressure
        #   stall (it takes only _life).
        self._seq_lock = threading.Lock()
        self._h_lock = threading.Lock()
        self._life = threading.Condition(self._h_lock)
        self._inflight = 0

    @staticmethod
    def available() -> bool:
        return _load() is not None

    @property
    def port(self) -> int:
        return self._lib.mailbox_port(self._h)

    def on(self, kind: str, handler: Callable[[int, dict], None]) -> None:
        self._handlers[kind] = handler

    def start(self) -> "NativeControlBus":
        # Outgoing connects retry in C until the peer's listener is up
        # (processes boot in arbitrary order, SURVEY.md §3.1).
        for host, port in self._peer_addrs:
            rc = self._lib.mailbox_connect(
                self._h, host.encode(), port,
                int(self._connect_timeout * 1000))
            if rc != 0:
                raise TimeoutError(
                    f"native bus: cannot reach peer {host}:{port}")
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        return self

    # Receive-side protocol caps (cpp/mailbox.cpp kMaxMsg/kMaxBlob). An
    # oversized frame would be written in full here but poison the peer's
    # reader thread there — the link dies silently. Reject at the source.
    MAX_MSG = 16 << 20
    MAX_BLOB = 1 << 30

    def publish(self, kind: str, payload: dict,
                blob: Optional[bytes] = None) -> None:
        """Enqueues onto the C++ Sender actor's bounded queue: nonblocking
        until the outbox holds its cap (default 8192 frames), then applies
        producer BACKPRESSURE — blocks up to 30s, after which the frame is
        counted in ``send_drops`` (never silently lost). A publish after
        close() is a silent no-op (matches zmq's at-worst-an-error
        behavior rather than a use-after-free)."""
        self._emit(-1, kind, payload, blob)

    def send(self, dest: int, kind: str, payload: dict,
             blob: Optional[bytes] = None) -> None:
        """Directed delivery to peer rank ``dest`` over its one TCP link.
        Assumes ``peer_addrs`` was built in ascending-rank order minus my
        own entry (what launch.init_from_env produces) so the connect-order
        index is recoverable from the rank."""
        if dest == self.my_id:
            raise ValueError("directed send to self (serve locally instead)")
        idx = dest if dest < self.my_id else dest - 1
        if not 0 <= idx < len(self._peer_addrs):
            raise ValueError(f"dest rank {dest} out of range")
        self._emit(idx, kind, payload, blob, dest_rank=dest)

    def _emit(self, peer_index: int, kind: str, payload: dict,
              blob: Optional[bytes], dest_rank: int = -1) -> None:
        # size caps validated BEFORE seq stamping: a raise after an
        # increment would leave a permanent stream gap the receiver's
        # loss tracker reads as a wire drop
        if blob is not None and len(blob) > self.MAX_BLOB:
            raise ValueError(f"blob {len(blob)}B exceeds the "
                             f"{self.MAX_BLOB}B protocol cap")
        head = {"kind": kind, "sender": self.my_id, "payload": payload}
        probe = encode_head(head, self.wire_fmt)
        # a stamped header adds <= ~24B (JSON '"bs": <int64>'; the
        # binary prefix carries the seq field either way)
        if len(probe) + 24 > self.MAX_MSG:
            raise ValueError(f"control frame {len(probe)}B exceeds the "
                             f"{self.MAX_MSG}B protocol cap")
        with self._seq_lock:
            with self._life:
                if self._closed:
                    return
                self._inflight += 1
            # seq stamping mirrors the zmq backend (FrameLossTracker):
            # TCP never drops post-connect, so established-stream loss
            # here means a torn link's tail. Stamp AND enqueue under
            # _seq_lock: wire order must equal seq order across threads
            # (a reordered pair would count as phantom loss forever).
            if not kind.startswith("__"):
                if peer_index < 0:
                    head["bs"] = self._bseq
                    self._bseq += 1
                else:
                    head["ds"] = self._dseq[dest_rank]
                    self._dseq[dest_rank] += 1
            msg = encode_head(head, self.wire_fmt)
            rel = getattr(self, "reliable", None)
            if rel is not None and ("bs" in head or "ds" in head):
                # under _seq_lock like the zmq backend: journal order
                # must equal wire order for NACK lookups to be sound
                rel.journal_stamped(
                    "b" if "bs" in head else "d",
                    -1 if "bs" in head else dest_rank,
                    head.get("bs", head.get("ds")), msg, blob)
            data = None if blob is None else bytes(blob)
            blen = -1 if blob is None else len(blob)
            try:
                # may BLOCK under backpressure (bounded outbox); close()
                # unblocks it via mailbox_interrupt without needing
                # _seq_lock, and the in-flight count keeps the handle
                # alive until this call returns
                if peer_index < 0:
                    self._lib.mailbox_publish(self._h, msg, len(msg),
                                              data, blen)
                else:
                    self._lib.mailbox_send(self._h, peer_index, msg,
                                           len(msg), data, blen)
            finally:
                with self._life:
                    self._inflight -= 1
                    self.bytes_sent += len(msg) + (blen if blen > 0 else 0)
                    if self._closed and self._inflight == 0:
                        self._life.notify_all()

    # ---------------------------------------------- queue observability
    def out_queue_depth(self) -> int:
        """Frames waiting on the C++ Sender actor (real depth — the zmq
        backend cannot observe its library-internal queues)."""
        with self._h_lock:
            return 0 if self._closed else int(
                self._lib.mailbox_outbox_depth(self._h))

    @property
    def send_drops(self) -> int:
        """Producer-side drops: bounded-outbox pushes that timed out
        (30s of a full queue). Zero in any healthy job."""
        with self._h_lock:
            return 0 if self._closed else int(
                self._lib.mailbox_dropped(self._h))

    def set_outbox_cap(self, cap: int) -> None:
        with self._h_lock:
            if not self._closed:
                self._lib.mailbox_set_outbox_cap(self._h, int(cap))

    @property
    def frames_lost(self) -> int:
        return self.loss.lost

    @property
    def frames_malformed(self) -> int:
        return self.loss.malformed

    def _recv_loop(self) -> None:
        msg_p = ctypes.c_char_p()
        msg_len = ctypes.c_int64()
        blob_p = ctypes.POINTER(ctypes.c_uint8)()
        blob_len = ctypes.c_int64()
        while not self._stop.is_set():
            got = self._lib.mailbox_recv(
                self._h, 50, ctypes.byref(msg_p), ctypes.byref(msg_len),
                ctypes.byref(blob_p), ctypes.byref(blob_len))
            if not got:
                continue
            try:
                raw = ctypes.string_at(msg_p, msg_len.value)
                blob = (ctypes.string_at(blob_p, blob_len.value)
                        if blob_len.value >= 0 and blob_p else None)
            finally:
                self._lib.mailbox_free_buf(msg_p)
                if blob_p:
                    self._lib.mailbox_free_buf(blob_p)
                blob_p = ctypes.POINTER(ctypes.c_uint8)()
            deliver_frame(self, raw, blob)

    def handshake(self, num_processes: int, timeout: float = 15.0) -> None:
        """TCP never drops post-connect, but a peer may publish before OUR
        connect to it finished accepting — same rendezvous as zmq."""
        from minips_tpu_torch.comm.bus import run_handshake

        run_handshake(self, num_processes, timeout)

    def close(self) -> None:
        stop_bus_layers(self)  # chaos scheduler + reliable repair thread
        with self._life:
            if self._closed:
                return
            self._closed = True
            # wake any publisher blocked in bounded-push backpressure
            # (its frame counts as dropped — teardown is an error path),
            # then wait in-flight C calls out before freeing the handle
            self._lib.mailbox_interrupt(self._h)
            if not self._life.wait_for(lambda: self._inflight == 0,
                                       timeout=35.0):
                return  # a wedged C call: leak the handle, never free it live
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                # A handler is wedged past the grace period. mailbox_close
                # would free the C++ object under the recv thread's feet
                # (use-after-free → segfault); leaking the handle is the
                # safe failure mode.
                return
        self._lib.mailbox_close(self._h)

    def __enter__(self) -> "NativeControlBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
