"""ControlBus — the surviving sliver of the reference's ZeroMQ Mailbox.

The reference routes *all* traffic (push/pull payloads, clocks, barriers,
heartbeats) through a zmq ROUTER/DEALER mailbox (SURVEY.md §2.3). In the
rebuild the data plane is XLA collectives, so the only traffic that still
needs sockets is the control plane: SSP clock gossip and heartbeats, which
must stay nonblocking while a TPU step runs (SURVEY.md §2.3 "Control
plane"). This is a deliberately tiny pub/sub bus: every process binds one
PUB socket and subscribes to all peers; messages are small
``{kind, sender, payload}`` heads framed by the shared wire codec
(comm/framing.py — binary by default, the seed JSON via
``MINIPS_WIRE_FMT=json``; receivers sniff per frame).

Tested over loopback in-process (the reference tests its mailbox the same
way — threads as nodes, SURVEY.md §4).

A copy of ``minips_tpu/comm/bus.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from minips_tpu_torch.comm.framing import (decode_head, encode_head,
                                     wire_fmt_from_env)

try:
    import zmq
    _HAS_ZMQ = True
except ImportError:  # pragma: no cover - zmq is present in the target env
    _HAS_ZMQ = False


class FrameLossTracker:
    """Receiver-side wire-loss accounting: every
    non-handshake frame a sender emits carries a per-stream sequence
    number — stream ``b`` for broadcasts (every receiver sees all of
    them) and stream ``d`` for frames directed at me. Both ride ONE
    ordered connection per (sender → receiver), so a gap in either
    stream means frames were lost on the wire (zmq HWM drop, a died
    link's tail) — exactly the loss mode zmq PUB/SUB cannot itself
    report. The FIRST frame seen per stream only synchronizes (frames
    published before a subscription lands are droppable by design; the
    handshake rendezvous bounds that window), so ``lost`` counts losses
    in ESTABLISHED streams — which must be zero in a healthy job.

    A gap is kept as an OUTSTANDING set, not a terminal verdict: a
    reordered, duplicated, or retransmitted frame whose seq eventually
    arrives reconciles ``lost`` back down — under the reliable-delivery
    layer (comm/reliable.py) a retransmit that lands late must not be
    double-booked as both 'lost' and 'delivered', and a mere adjacent
    swap (chaos reorder, a multi-path wire) was never a loss at all.
    ``dups`` counts late frames whose seq was already accounted
    delivered. The outstanding set is bounded (``GAP_CAP`` per stream);
    gaps evicted past the cap stay counted lost forever — the seed
    behavior, now only for pathological floods."""

    GAP_CAP = 4096  # outstanding gap seqs retained per (sender, stream)

    def __init__(self):
        self._next: dict[tuple, int] = {}
        self._gaps: dict[tuple, "OrderedDict[int, None]"] = {}
        self.lost = 0
        self.dups = 0
        self.malformed = 0
        self._lock = threading.Lock()

    def observe(self, sender: int, stream: str, seq: int) -> None:
        with self._lock:
            k = (sender, stream)
            exp = self._next.get(k)
            if exp is None:  # sync point: pre-subscription frames
                self._next[k] = seq + 1
                return
            if seq >= exp:
                if seq > exp:
                    self.lost += seq - exp  # O(1), like the seed
                    gaps = self._gaps.setdefault(k, OrderedDict())
                    # materialize at most GAP_CAP seqs of the jump: a
                    # stale-run/corrupt frame carrying a huge seq must
                    # not build a gap entry per missing seq under the
                    # receive thread's lock — everything below the cap
                    # stays counted lost forever (seed behavior)
                    for s in range(max(exp, seq - self.GAP_CAP), seq):
                        gaps[s] = None
                    while len(gaps) > self.GAP_CAP:
                        gaps.popitem(last=False)
                self._next[k] = seq + 1
                return
            # late frame (seq < exp): a reordered/duplicated/retransmitted
            # arrival — reconcile if its seq is an outstanding gap
            gaps = self._gaps.get(k)
            if gaps is not None and gaps.pop(seq, -1) is None:
                self.lost -= 1
            else:
                self.dups += 1

    def note_malformed(self) -> None:
        with self._lock:
            self.malformed += 1

    def prime(self, sender: int, stream: str, seq: int = 0) -> None:
        """Pin the stream's sync point (idempotent): the reliable
        channel defines every stream as starting at seq 0 — with it
        installed, a hole the journal could not repair must COUNT as
        lost even when it precedes the first delivered frame, instead
        of being forgiven by first-frame sync (which exists for the
        bare bus's pre-subscription window)."""
        with self._lock:
            self._next.setdefault((sender, stream), seq)


class ControlBus:
    """PUB/SUB gossip bus: ``publish(kind, payload)`` fans out to all peers;
    ``send(dest, ...)`` delivers to ONE peer (zmq topic-prefix subscription,
    filtered at the publisher for TCP transports — directed traffic does not
    ride every link). Handlers registered per kind run on a background
    receive thread.

    Backpressure/loss semantics (documented): zmq PUB
    sockets DROP frames silently once a subscriber's queue hits the HWM —
    they never block the publisher. Both HWMs here default to 65536 frames
    (``$MINIPS_ZMQ_HWM``) so a flood must outrun the subscriber by ~65k
    frames before anything drops, and every frame carries a sequence
    number so a drop that does happen is COUNTED at the receiver
    (``frames_lost``) instead of silently corrupting training. The native
    backend (comm/native_bus.py) blocks the producer instead (bounded
    outbox) — same observable interface, stricter guarantee."""

    def __init__(self, my_addr: str, peer_addrs: list[str],
                 my_id: int = 0, wire_fmt: Optional[str] = None):
        import os

        if not _HAS_ZMQ:
            raise RuntimeError("pyzmq not available")
        self.my_id = my_id
        # head codec (comm/framing.py): binary by default, the seed JSON
        # framing via MINIPS_WIRE_FMT=json — receive sniffs per frame,
        # so the knob only shapes what THIS rank emits
        self.wire_fmt = wire_fmt or wire_fmt_from_env()
        self.bytes_sent = 0  # wire accounting (sharded-PS slice assertions)
        self.loss = FrameLossTracker()
        self._n_world = len(peer_addrs) + 1
        self._bseq = 0                       # broadcast-stream seq
        self._dseq = [0] * self._n_world     # per-dest directed seq
        hwm = int(os.environ.get("MINIPS_ZMQ_HWM", "65536"))
        self._ctx = zmq.Context.instance()
        self._pub = self._ctx.socket(zmq.PUB)
        self._pub.setsockopt(zmq.SNDHWM, hwm)
        self._pub.bind(my_addr)
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.setsockopt(zmq.RCVHWM, hwm)
        for addr in peer_addrs:
            self._sub.connect(addr)
        # Two topics reach me: broadcast "b|" and my directed "d<id>|".
        # The trailing delimiter keeps "d1|" from prefix-matching "d12|".
        self._sub.setsockopt(zmq.SUBSCRIBE, b"b|")
        self._sub.setsockopt(zmq.SUBSCRIBE, f"d{my_id}|".encode())
        self._handlers: dict[str, Callable[[int, dict], None]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pub_lock = threading.Lock()

    def on(self, kind: str, handler: Callable[[int, dict], None]) -> None:
        """Register ``handler(sender_id, payload)`` for message kind."""
        self._handlers[kind] = handler

    def start(self) -> "ControlBus":
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        # PUB/SUB needs a beat for subscriptions to propagate (slow joiner).
        time.sleep(0.05)
        return self

    def publish(self, kind: str, payload: dict,
                blob: Optional[bytes] = None) -> None:
        """Fan out ``payload`` (small JSON) with an optional binary ``blob``
        frame (e.g. a packed ndarray of parameter deltas). Receivers find
        the blob at ``payload["__blob__"]``. JSON stays the control format
        (reference BinStream's role, SURVEY.md §2); the blob frame exists so
        host-relayed pushes need no base64 inflation."""
        self._emit(b"b|", kind, payload, blob)

    def send(self, dest: int, kind: str, payload: dict,
             blob: Optional[bytes] = None) -> None:
        """Deliver to ONE peer — the reference Mailbox's per-thread-id
        addressing (SURVEY.md §2.3), here a topic only ``dest`` subscribes
        to. Per-(publisher → subscriber) frame order still holds across
        publish() and send() on this bus: one PUB socket, one connection."""
        # validate like the native backend: a typo'd dest would otherwise
        # publish to a topic nobody subscribes and vanish silently
        if dest == self.my_id:
            raise ValueError("directed send to self (serve locally instead)")
        if not 0 <= dest < self._n_world:
            raise ValueError(f"dest rank {dest} out of range")
        self._emit(f"d{dest}|".encode(), kind, payload, blob)

    def _emit(self, topic: bytes, kind: str, payload: dict,
              blob: Optional[bytes]) -> None:
        head = {"kind": kind, "sender": self.my_id, "payload": payload}
        with self._pub_lock:
            # seq stamped under the pub lock: the stream order IS the wire
            # order. Handshake frames stay unstamped — they are the frames
            # legitimately droppable before subscriptions land.
            if not kind.startswith("__"):
                if topic == b"b|":
                    head["bs"] = self._bseq
                    self._bseq += 1
                else:
                    dest = int(topic[1:-1])
                    head["ds"] = self._dseq[dest]
                    self._dseq[dest] += 1
            msg = encode_head(head, self.wire_fmt)
            rel = getattr(self, "reliable", None)
            if rel is not None and ("bs" in head or "ds" in head):
                # journal under the pub lock: journal order == wire order,
                # so a NACKed seq is always findable or provably evicted
                rel.journal_stamped(
                    "b" if "bs" in head else "d",
                    -1 if "bs" in head else int(topic[1:-1]),
                    head.get("bs", head.get("ds")), msg, blob)
            frames = [topic, msg] if blob is None else [topic, msg, blob]
            self._pub.send_multipart(frames)
            self.bytes_sent += len(msg) + (len(blob) if blob else 0)

    @property
    def frames_lost(self) -> int:
        """Wire frames provably lost on established (sender → me) streams
        — nonzero means HWM drops or a torn link tail; see FrameLossTracker.
        With the reliable channel installed, recovered frames never count:
        this is UNRECOVERED loss."""
        return self.loss.lost

    @property
    def frames_malformed(self) -> int:
        """Undecodable control frames dropped at receive (torn JSON — a
        stale run's tail or wire corruption), counted instead of silently
        swallowed; surfaced next to frames_lost in wire_record."""
        return self.loss.malformed

    def out_queue_depth(self) -> Optional[int]:
        """zmq queues live inside the library; depth is not observable —
        the native backend reports a real number here."""
        return None

    def _recv_loop(self) -> None:
        poller = zmq.Poller()
        poller.register(self._sub, zmq.POLLIN)
        while not self._stop.is_set():
            if not dict(poller.poll(timeout=50)):
                continue
            # drain the socket per wake, not one frame per poll(): each
            # poll releases the GIL, and when the main thread is busy
            # (the overlapped pipeline's whole point) a per-frame poll
            # lets it steal the timeslice between every frame — the
            # receive thread then drains at ~1 frame per GIL handoff and
            # ack/reply latency balloons from microseconds to tens of ms
            while not self._stop.is_set():
                try:
                    frames = self._sub.recv_multipart(zmq.NOBLOCK)
                except zmq.ZMQError:
                    break  # EAGAIN: queue empty, back to poll()
                if len(frames) < 2:
                    self.loss.note_malformed()
                    continue  # topic-only frame: malformed
                deliver_frame(self, frames[1],
                              frames[2] if len(frames) > 2 else None)

    def handshake(self, num_processes: int, timeout: float = 15.0) -> None:
        """Rendezvous before real traffic: PUB/SUB drops messages published
        before a subscriber's connect lands (the zmq slow-joiner problem),
        which for the delta-gossip data path would mean silent replica
        divergence — so nobody proceeds until everyone provably hears
        everyone. Reference analog: the mailbox's startup bind/connect
        barrier (SURVEY.md §3.1)."""
        run_handshake(self, num_processes, timeout)

    def close(self) -> None:
        stop_bus_layers(self)  # chaos scheduler + reliable repair thread
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self._pub.close(linger=0)
        self._sub.close(linger=0)

    def __enter__(self) -> "ControlBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def dispatch_message(handlers: dict, raw, blob: Optional[bytes],
                     loss: Optional[FrameLossTracker] = None) -> None:
    """Shared receive-side tail for every bus backend: decode the
    control frame (format-sniffed: binary or the seed JSON,
    comm/framing.py), run it past the wire-loss tracker, attach the
    blob at ``__blob__``, invoke the handler. A malformed frame is
    COUNTED (``loss.malformed`` → ``frames_malformed``) and reported
    once to stderr instead of silently swallowed — a torn frame is a
    wire-health signal the done lines must carry. A raising handler is
    reported, not propagated — one bad handler must not kill the
    backend's receive thread (clocks/heartbeats ride the same
    thread)."""
    msg = decode_head(raw)
    if msg is None:
        _note_malformed(loss, raw)
        return
    dispatch_parsed(handlers, msg, blob, loss=loss)


def _note_malformed(loss: Optional[FrameLossTracker], raw) -> None:
    if loss is None:
        return
    loss.note_malformed()
    if loss.malformed == 1:  # first sighting: say it once, count the rest
        import sys

        head = bytes(raw[:64]) if raw is not None else b""
        print(f"bus: malformed control frame dropped (head={head!r}); "
              "counting in frames_malformed", file=sys.stderr)


def dispatch_parsed(handlers: dict, msg: dict, blob: Optional[bytes],
                    loss: Optional[FrameLossTracker] = None) -> None:
    """``dispatch_message`` minus the decode — the reliable channel's
    sequencer re-dispatches already-parsed frames through this."""
    if loss is not None:
        if "bs" in msg:
            loss.observe(msg.get("sender", -1), "b", int(msg["bs"]))
        elif "ds" in msg:
            loss.observe(msg.get("sender", -1), "d", int(msg["ds"]))
    handler = handlers.get(msg.get("kind"))
    if handler is None:
        return
    payload = msg.get("payload", {})
    if blob is not None:
        payload["__blob__"] = blob
    try:
        handler(msg.get("sender", -1), payload)
    except Exception:  # noqa: BLE001 - isolate handler faults
        import sys
        import traceback

        print(f"bus: handler for {msg.get('kind')!r} raised:",
              file=sys.stderr)
        traceback.print_exc()


def deliver_frame(bus, raw, blob: Optional[bytes]) -> None:
    """Receive chain shared by every backend, layered like the wire it
    models: (1) the chaos injector, when installed, plays the lossy
    network — it may drop, duplicate, delay, or reorder the frame;
    (2) the reliable channel, when installed, runs surviving stamped
    frames through its deliver-once in-order sequencer (gap → NACK →
    retransmit, comm/reliable.py); (3) plain handler dispatch. With
    neither installed this is byte-for-byte the seed path."""
    msg = decode_head(raw)
    if msg is None:
        _note_malformed(getattr(bus, "loss", None), raw)
        return
    chaos = getattr(bus, "chaos", None)
    if chaos is not None:
        chaos.on_wire(msg, blob)  # forwards survivors to deliver_post_wire
    else:
        deliver_post_wire(bus, msg, blob)


def deliver_post_wire(bus, msg: dict, blob: Optional[bytes]) -> None:
    """Above-the-wire half of :func:`deliver_frame` — the chaos injector
    re-enters here for frames it held (so a delayed frame is not
    re-chaosed on release)."""
    rel = getattr(bus, "reliable", None)
    if rel is not None and ("bs" in msg or "ds" in msg):
        rel.on_stamped(msg, blob)
    else:
        dispatch_parsed(bus._handlers, msg, blob, loss=bus.loss)


def stop_bus_layers(bus) -> None:
    """Quiesce the optional chaos/reliable layers before a backend tears
    its sockets down (both run their own timer threads)."""
    for attr in ("chaos", "reliable"):
        layer = getattr(bus, attr, None)
        if layer is not None:
            layer.stop()


def run_handshake(bus, num_processes: int, timeout: float = 15.0) -> None:
    """Backend-agnostic startup rendezvous over any bus exposing
    ``on``/``publish``/``my_id``/``_handlers``. Each process repeats
    ``hello``; once it has heard hello from all peers it also repeats
    ``ready``; it returns once it has heard ready from all peers (with a
    short grace of extra publishes for stragglers)."""
    import time as _time

    peers = set(range(num_processes)) - {bus.my_id}
    if not peers:
        return
    hellos: set[int] = set()
    readys: set[int] = set()
    lock = threading.Lock()

    def on_hello(sender: int, payload: dict) -> None:
        with lock:
            hellos.add(sender)

    def on_ready(sender: int, payload: dict) -> None:
        with lock:
            hellos.add(sender)
            readys.add(sender)

    bus.on("__hello", on_hello)
    bus.on("__ready", on_ready)
    deadline = _time.monotonic() + timeout
    while True:
        bus.publish("__hello", {})
        with lock:
            all_hello = hellos >= peers
            all_ready = readys >= peers
        if all_hello:
            bus.publish("__ready", {})
        if all_ready:
            break
        if _time.monotonic() > deadline:
            with lock:
                missing = peers - readys
            raise TimeoutError(
                f"bus handshake: peers {sorted(missing)} never ready")
        _time.sleep(0.02)
    for _ in range(5):  # grace: peers may still await my ready
        bus.publish("__ready", {})
        _time.sleep(0.02)
    bus._handlers.pop("__hello", None)
    bus._handlers.pop("__ready", None)


def make_bus(my_addr: str, peer_addrs: list[str], my_id: int = 0,
             backend: Optional[str] = None, *,
             chaos: Optional[str] = None,
             reliable: Optional[str] = None,
             wire_fmt: Optional[str] = None):
    """Bus factory. ``backend``: ``"zmq"`` (pyzmq PUB/SUB, default),
    ``"native"`` (the C++ TCP mailbox, cpp/mailbox.cpp — the reference's
    native-runtime analog), or ``"shm"`` (same-host shared-memory SPSC
    rings, comm/shm_bus.py — the zero-copy loopback transport); default
    from ``$MINIPS_BUS``. ``wire_fmt`` picks the head codec
    (``$MINIPS_WIRE_FMT``: ``bin`` default, ``json`` = the seed
    framing) — receivers sniff per frame, so mixed-fmt fleets decode.

    An explicit native request that cannot be satisfied raises instead of
    silently falling back: the two wire formats do not interoperate, so a
    quiet fallback on one host of a multi-host job would produce a mixed
    mesh that fails 15s later with a misleading handshake timeout. An
    shm request across hosts fails the same loud way (the ring files
    simply don't exist on the other machine — the attach times out
    naming the missing link).

    Two optional layers install on whichever backend was built (same
    observable interface either way):

    - ``reliable`` (or ``$MINIPS_RELIABLE``): the retransmission protocol
      riding the per-link seqs (comm/reliable.py) — transient wire loss
      degrades to latency instead of a timeout poison. ``"1"`` for
      defaults, or a knob string (``"journal=1024,budget=12"``).
    - ``chaos`` (or ``$MINIPS_CHAOS``): the deterministic seeded fault
      injector (comm/chaos.py), ``"<seed>:drop=0.01,dup=0.005,..."`` —
      every process must run the SAME spec for a reproducible drill.
    """
    import os

    # explicit-empty = default, like every other MINIPS_* knob (the
    # bench arms pin "" to keep an armed environment from leaking)
    backend = backend or os.environ.get("MINIPS_BUS", "").strip() or "zmq"
    if backend == "native":
        from minips_tpu_torch.comm.native_bus import NativeControlBus

        if not NativeControlBus.available():
            raise RuntimeError(
                "MINIPS_BUS=native requested but the C++ mailbox library "
                "is unavailable (no compiler?); every host must use the "
                "same backend — set MINIPS_BUS=zmq explicitly to fall back")
        bus = NativeControlBus(my_addr, peer_addrs, my_id=my_id,
                               wire_fmt=wire_fmt)
    elif backend == "zmq":
        bus = ControlBus(my_addr, peer_addrs, my_id=my_id,
                         wire_fmt=wire_fmt)
    elif backend == "shm":
        from minips_tpu_torch.comm.shm_bus import ShmControlBus

        bus = ShmControlBus(my_addr, peer_addrs, my_id=my_id,
                            wire_fmt=wire_fmt)
    else:
        raise ValueError(f"unknown bus backend {backend!r} "
                         "(expected 'zmq', 'native', or 'shm')")
    # layer order matters only conceptually: chaos models the wire (runs
    # first on receive), reliable rides above it. Install reliable first
    # so chaos-released frames find the sequencer already in place.
    reliable = (os.environ.get("MINIPS_RELIABLE", "")
                if reliable is None else reliable)
    if reliable and reliable != "0":
        from minips_tpu_torch.comm.reliable import ReliableChannel

        ReliableChannel.install(bus, reliable)
    chaos = os.environ.get("MINIPS_CHAOS", "") if chaos is None else chaos
    if chaos:
        from minips_tpu_torch.comm.chaos import ChaosBus

        ChaosBus.install(bus, chaos)
    return bus


class ClockGossip:
    """SSP clock exchange over the bus (SURVEY.md §7.4): each process
    publishes its local worker clocks; the merged global view feeds the
    host-side staleness gate."""

    def __init__(self, bus: ControlBus, num_processes: int,
                 workers_per_process: int):
        self.bus = bus
        self._clocks = {p: [0] * workers_per_process
                        for p in range(num_processes)}
        self._cond = threading.Condition()
        self._excluded: set[int] = set()
        self._listeners: list = []  # called (no locks held) on any change
        bus.on("clock", self._on_clock)

    def add_listener(self, fn) -> None:
        """``fn()`` runs after every clock/exclusion change — the server-
        side pending-buffer's re-admission hook (parked pulls re-check)."""
        self._listeners.append(fn)

    def _notify_listeners(self) -> None:
        for fn in self._listeners:
            fn()

    def _on_clock(self, sender: int, payload: dict) -> None:
        with self._cond:
            if sender not in self._clocks:
                return  # stray sender (stale run / port reuse): no ghosts
            new = list(payload.get("clocks", []))
            cur = self._clocks[sender]
            if len(cur) == len(new):
                # MONOTONE merge: clocks only advance within one bus
                # incarnation, so a clock frame arriving LATE (wire
                # reorder, a retransmit landing after fresher gossip)
                # must never regress the view — a regressed min would
                # re-park admitted pulls and stamp replies with a
                # freshness certificate older than what the rows hold
                new = [max(a, b) for a, b in zip(cur, new)]
            self._clocks[sender] = new
            self._cond.notify_all()
        self._notify_listeners()

    def publish_local(self, clocks: list[int]) -> None:
        with self._cond:
            self._clocks[self.bus.my_id] = list(clocks)
            self._cond.notify_all()
        self.bus.publish("clock", {"clocks": list(clocks)})
        self._notify_listeners()

    def exclude(self, process_id: int) -> None:
        """Drop a dead peer from min-clock computation (failure handling,
        SURVEY.md §5.3) so survivors aren't gated on a corpse forever."""
        with self._cond:
            self._excluded.add(process_id)
            self._cond.notify_all()
        self._notify_listeners()

    def include(self, process_id: int) -> None:
        """Re-admit a rank into min-clock computation — the elastic-
        membership join path (balance/membership.py): a standby rank is
        excluded at startup so its idle clock can't gate the fleet, and
        included only AFTER it published a catch-up clock (its live
        announce trails that publish on the same FIFO link, so by
        include time the stored entry is current — including a clock-0
        ghost would wedge every gate)."""
        with self._cond:
            self._excluded.discard(process_id)
            self._cond.notify_all()
        self._notify_listeners()

    def _min_locked(self) -> int:
        vals = [min(v) for p, v in self._clocks.items()
                if v and p not in self._excluded]
        return min(vals) if vals else 0

    def global_min(self) -> int:
        with self._cond:
            return self._min_locked()

    def min_excluding(self, process_id: int) -> int:
        """min clock over live processes OTHER than ``process_id`` — the
        freshness certificate an owner stamps on a pull reply to that
        process (train/sharded_ps.py row cache). The requester's own
        entry is excluded because its contribution to the reply's
        freshness is certified by a different mechanism: per-link FIFO
        means the owner has applied every push the requester sent before
        the pull, regardless of how stale the requester's *gossiped*
        clock looks here — including it would only let the slowest
        reader invalidate its own cache. With no other live process
        left to certify, fall back to the plain global min (which then
        includes the requester's own gossiped clock — conservative: a
        lower stamp only costs cache hits, never staleness)."""
        with self._cond:
            vals = [min(v) for p, v in self._clocks.items()
                    if v and p not in self._excluded and p != process_id]
            return min(vals) if vals else self._min_locked()

    @property
    def excluded(self) -> set[int]:
        with self._cond:
            return set(self._excluded)

    def wait_global_min(self, threshold: int,
                        timeout: Optional[float] = None) -> bool:
        """Block until every live process's min clock >= threshold — the
        host-side SSP gate's wait primitive (SURVEY.md §7.4.1). Returns
        False on timeout."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._min_locked() >= threshold, timeout)

    def snapshot(self) -> dict[int, list[int]]:
        with self._cond:
            return {k: list(v) for k, v in self._clocks.items()}

    @property
    def skew(self) -> int:
        """max clock − min clock over live processes (the SSP observable,
        SURVEY.md §5.5)."""
        with self._cond:
            vals = [c for p, v in self._clocks.items()
                    if v and p not in self._excluded for c in v]
            return (max(vals) - min(vals)) if vals else 0


class BlobExchange:
    """Host-side allgather of one ndarray per process per (round, tag).

    The touched-row UNION exchange for row-sparse collective syncs
    (train/cssp_ps.py): before each merge round every process publishes
    the slot ids its local steps touched; every process then holds the
    same per-rank arrays and computes the same sorted union — the index
    set the batch-rows-sized delta collective runs over. Arrays ride the
    bus's binary blob frame (no base64 inflation); the JSON head carries
    (round, tag, dtype).

    Early arrivals PARK in the store until consumed: under SSP skew a
    fast process may receive a peer's round-r+1 array while still
    draining round r — keying the store by (round, tag, sender) makes
    that reordering harmless. Hardenings against the pub/sub transport's
    nature (frames published before a peer registered its handler are
    dropped, and there is no replay):

    - a waiting ``allgather`` RE-PUBLISHES its own frame every couple of
      seconds (duplicates are idempotent — same key, same bytes);
    - a waiting ``allgather`` also REQUESTS missing frames: each
      instance retains its latest (head, blob) per tag and answers a
      ``blobx_req`` by re-sending — this covers the sender whose own
      gather already completed and who therefore stopped re-publishing
      (it no longer waits, but it still serves);
    - late/duplicate arrivals for rounds already consumed or abandoned
      are dropped at receive time by a per-tag ROUND WATERMARK (rounds
      are monotone per tag by construction).

    All publishes happen OUTSIDE the store lock: the bus receive thread
    needs that lock in ``_on``, and it also delivers clock gossip and
    heartbeats — a blocking publish (the native bus's bounded outbox)
    must never freeze failure detection. Request replies go through a
    one-shot thread for the same reason.

    A timed-out wait consults the heartbeat monitor so a dead peer
    raises PeerFailureError instead of hanging forever (the staleness
    gate's contract, SURVEY.md §5.3)."""

    KIND = "blobx"
    REQ_KIND = "blobx_req"

    def __init__(self, bus: ControlBus, num_processes: int):
        self.bus = bus
        self.n = int(num_processes)
        self._store: dict = {}
        self._done: dict = {}     # tag -> highest consumed/abandoned round
        self._sent: dict = {}     # tag -> {round: (head, blob)}, last 2
        self._cond = threading.Condition()
        bus.on(self.KIND, self._on)
        bus.on(self.REQ_KIND, self._on_req)

    def _on(self, sender: int, payload: dict) -> None:
        import numpy as np

        rnd, tag = int(payload["round"]), str(payload["tag"])
        raw = payload.get("__blob__") or b""
        arr = np.frombuffer(raw, dtype=np.dtype(payload["dtype"])).copy()
        with self._cond:
            if rnd <= self._done.get(tag, -1):
                return  # re-publish duplicate of a finished round
            self._store[(rnd, tag, sender)] = arr
            self._cond.notify_all()

    def _on_req(self, sender: int, payload: dict) -> None:
        """A peer missed our frame (registered its handler after our
        publishes, and our own gather may already be done): re-send the
        retained copy. Off-thread — the receive thread must not block
        in a publish."""
        rnd, tag = int(payload["round"]), str(payload["tag"])
        with self._cond:
            kept = self._sent.get(tag, {}).get(rnd)
        if kept is None:
            return  # nothing retained for that round (it will time out)
        head, blob = kept
        threading.Thread(target=self.bus.publish,
                         args=(self.KIND, head, blob),
                         daemon=True).start()

    def allgather(self, rnd: int, tag: str, arr, *,
                  timeout: float = 120.0, monitor=None) -> list:
        """Every process's array for (rnd, tag), ordered by rank (mine
        included). All processes must call this together — it blocks for
        the peers, like the collective it fronts."""
        import numpy as np

        arr = np.ascontiguousarray(arr)
        head = {"round": int(rnd), "tag": str(tag), "dtype": str(arr.dtype)}
        blob = arr.tobytes()
        with self._cond:
            # retain the last FOUR rounds per tag: within one round the
            # collective merges after each gather rendezvous the whole
            # group, so a peer normally lags at most one round behind a
            # server — but a round whose every union is empty launches
            # no psum (no rendezvous), and SEVERAL consecutive empty
            # rounds let a lagging peer fall further behind than a
            # 2-round window before anything re-synchronizes it. Four
            # rounds covers 3 empty rounds back-to-back; a peer lagging
            # deeper than that has missed a real rendezvous and is the
            # monitor's problem, not retention's.
            kept = self._sent.setdefault(tag, {})
            kept[int(rnd)] = (head, blob)
            for old_rnd in [r for r in kept if r < rnd - 3]:
                del kept[old_rnd]
        self.bus.publish(self.KIND, head, blob=blob)
        out: list = [None] * self.n
        out[self.bus.my_id] = arr
        peers = [p for p in range(self.n) if p != self.bus.my_id]
        deadline = time.monotonic() + timeout
        last_repair = time.monotonic()
        while True:
            with self._cond:
                missing = [p for p in peers
                           if (rnd, tag, p) not in self._store]
                if not missing:
                    for p in peers:
                        out[p] = self._store.pop((rnd, tag, p))
                    self._finish_locked(rnd, tag)
                    return out
                self._cond.wait(timeout=1.0)
                missing = [p for p in peers
                           if (rnd, tag, p) not in self._store]
                if not missing:
                    for p in peers:
                        out[p] = self._store.pop((rnd, tag, p))
                    self._finish_locked(rnd, tag)
                    return out
            # ---- lock released: monitor/deadline/repair — run EVERY
            # iteration: other traffic keeping the cond busy (peers'
            # re-publishes, other tags) must not starve failure
            # detection or let the wait overshoot its deadline
            if monitor is not None:
                dead = monitor.check()
                if dead:
                    with self._cond:
                        self._finish_locked(rnd, tag)
                    from minips_tpu_torch.consistency.gate import \
                        PeerFailureError
                    raise PeerFailureError(dead)
            if time.monotonic() > deadline:
                with self._cond:
                    self._finish_locked(rnd, tag)
                raise TimeoutError(
                    f"BlobExchange round {rnd} tag {tag!r}: "
                    f"peers {missing} never arrived")
            if time.monotonic() - last_repair > 2.0:
                # slow-joiner repair, both directions: re-offer my frame
                # (a peer may have registered after my first publish)
                # and request theirs (a peer whose gather already
                # finished no longer re-publishes, but it still serves
                # requests from its retained copies)
                self.bus.publish(self.KIND, head, blob=blob)
                for p in missing:
                    self.bus.send(p, self.REQ_KIND,
                                  {"round": int(rnd), "tag": str(tag)})
                last_repair = time.monotonic()

    def _finish_locked(self, rnd: int, tag: str) -> None:
        """Mark the round consumed/abandoned and drop any parked leftovers
        for it: the caller never comes back for an abandoned round
        (recovery relaunches with fresh state), and re-published
        duplicates of finished rounds must not re-park — the watermark
        makes _on reject them at receive time. Caller holds the lock."""
        self._done[tag] = max(self._done.get(tag, -1), rnd)
        for key in [k for k in self._store
                    if k[0] <= rnd and k[1] == tag]:
            del self._store[key]
