"""ReliableChannel — retransmission riding the per-link sequence numbers.

The buses already STAMP every non-handshake frame with a per-(sender →
receiver) stream seq and COUNT gaps (``FrameLossTracker``); this module
turns that accounting into recovery, so one dropped frame on the
sharded-PS wire costs milliseconds of latency instead of a pull-timeout
poison, a jammed ack window, or a clock-gossip stall that a heartbeat
eventually misreads as death. The protocol, end to end:

- **Send journal** (sender side): every stamped frame is retained in a
  bounded per-link ring (``journal`` frames deep, default 1024) keyed by
  its seq, recorded under the same lock that stamps it so journal order
  equals wire order. ``__``-prefixed control frames are unstamped and
  never journaled — retransmits of retransmits cannot recurse.

- **Gap detection** (receiver side): stamped frames run through a
  per-(sender, stream) SEQUENCER. Frames arriving in order dispatch
  immediately; a frame ahead of ``expected`` is buffered and the missing
  seqs become an outstanding-gap set; a frame at or below ``expected``
  (or already buffered) is a duplicate and is dropped — DELIVER-ONCE,
  the property the server-side updaters and clock gossip rely on (a
  retransmitted push applied twice would double a gradient; gossip
  additionally max-merges, comm/bus.py). Streams start at seq 0: frames
  published before a subscription landed (the zmq slow-joiner window)
  are recovered from the journal like any other loss instead of being
  silently forgiven.

- **NACK / retransmit**: a repair thread re-requests outstanding gaps
  (``__rl_nack`` directed at the sender) with exponential backoff
  (``backoff_ms`` doubling up to ``backoff_max_ms``) and a retry budget
  (``budget`` tries). The sender answers from its journal with ``__rt``
  frames (the original stamped head + blob, wrapped so the wrapper
  itself consumes no seq) or ``__rl_gone`` for seqs its ring already
  evicted.

- **Trailing loss**: a gap is only visible once a LATER frame arrives,
  and the lost frame may be the last one for a while (a clock broadcast,
  the final push before a quiesce). Senders therefore advertise their
  stream tops (``__rl_top``, every ``advert_ms`` while traffic flowed)
  so receivers can open gaps for frames they never saw any successor to.

- **Giving up stays loud**: budget exhaustion (or ``__rl_gone``) marks
  the seq permanently skipped; the sequencer advances past the hole and
  the next delivered frame's seq jump lands in ``FrameLossTracker`` —
  ``frames_lost`` stays the honest UNRECOVERED-loss counter, and the
  existing poison paths (pull deadline, drain deadline, gate timeout,
  heartbeat death) fire exactly as before. The layer converts transient
  loss to latency; it never converts persistent loss to silence.

In-order delivery is a strictly stronger guarantee than the seed's
per-link FIFO, so every staleness argument that leaned on FIFO (push
before clock, ack after apply) holds unchanged. The cost on a clean
wire is one dict update per stamped frame plus the journal retention —
the ``chaos_resilience`` bench's drop-0 arm exists to keep that tax
within noise of the bare path.

Mixed fleets degrade loudly, not silently: a reliable receiver paired
with a non-reliable sender will NACK into a void, exhaust its budget,
and count the loss; a reliable sender's journal simply goes unasked.

Enable with ``MINIPS_RELIABLE=1`` (or a knob string like
``"journal=2048,budget=10,backoff_ms=25,advert_ms=200"``), or
``make_bus(..., reliable=...)``.

A copy of ``minips_tpu/comm/reliable.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from minips_tpu_torch.comm.framing import decode_head, rt_wrap
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc

__all__ = ["ReliableChannel"]

NACK_KIND = "__rl_nack"
GONE_KIND = "__rl_gone"
TOP_KIND = "__rl_top"
RT_KIND = "__rt"

_NACK_BATCH = 256  # max seqs per NACK frame (flood valve)


class _Gap:
    __slots__ = ("tries", "due", "t0", "reopened")

    def __init__(self, due: float, t0: float = 0.0,
                 reopened: bool = False):
        self.tries = 0
        self.due = due
        self.t0 = t0  # gap registration time: the retransmit span start
        self.reopened = reopened  # second-chance gap: no third chance


class _Rx:
    """Per-(sender, stream) sequencer state."""

    __slots__ = ("exp", "buf", "gaps", "skip", "heal", "gone", "dhi")

    def __init__(self):
        self.exp = 0          # next seq to deliver
        self.buf: dict = {}   # seq -> (msg, blob), seq > exp
        self.gaps: dict = {}  # seq -> _Gap, outstanding missing seqs
        self.skip: set = set()  # given-up seqs awaiting advance
        # PARTITION-HEAL reopen state (this PR): seqs given up by
        # BUDGET exhaustion (NACKs into a cut link's void — the sender
        # may still hold them journaled) and never delivered around —
        # candidates to reopen when the link proves alive again. Seqs
        # given up by __rl_gone (journal evicted: genuinely
        # unrecoverable) never enter this set.
        self.heal: set = set()
        # seqs the sender declared __rl_gone (journal-evicted): a
        # reopen spanning them must re-skip, never re-NACK — the
        # sender already confessed, and a second gone round-trip would
        # double-count gave_up. Bounded alongside heal.
        self.gone: set = set()
        self.dhi = 0          # delivery high-water: 1 + highest seq
        #                       actually DELIVERED (skip-advances do
        #                       not move it) — the reopen soundness bar


class ReliableChannel:
    def __init__(self, bus, *, journal_frames: int = 1024,
                 journal_bytes: int = 8 << 20,
                 retry_budget: int = 12, backoff_ms: float = 25.0,
                 backoff_max_ms: float = 1000.0, advert_ms: float = 200.0,
                 settle_ms: float = 8.0, buffer_cap: int = 8192,
                 idle_tick_ms: float = 200.0,
                 clock=time.monotonic, start_thread: bool = True):
        self.bus = bus
        self.journal_frames = int(journal_frames)
        # per-link BYTE bound on top of the frame bound: pull replies and
        # push frames carry multi-KB blobs, and retaining 1024 of them
        # per link is tens of MB of allocation churn — on a loopback
        # host that cache pressure costs more than the retransmits the
        # deep tail would ever save (a gap older than megabytes of
        # subsequent traffic is headed for the deadline poison anyway)
        self.journal_bytes = int(journal_bytes)
        self.retry_budget = int(retry_budget)
        self.backoff_s = float(backoff_ms) / 1e3
        self.backoff_max_s = float(backoff_max_ms) / 1e3
        self.advert_s = float(advert_ms) / 1e3
        self.settle_s = float(settle_ms) / 1e3  # grace before first NACK:
        # plain reordering resolves itself; NACKing instantly would pay a
        # retransmit for every adjacent swap
        self.buffer_cap = int(buffer_cap)
        self.idle_tick_s = float(idle_tick_ms) / 1e3
        self._clock = clock
        self._journal: dict[tuple, OrderedDict] = {}
        self._jbytes: dict[tuple, int] = {}
        self._jlock = threading.Lock()
        self._rx: dict[tuple, _Rx] = {}
        # RLock: the sequencer dispatches handlers while holding it (two
        # release points — recv thread and chaos scheduler — must not
        # interleave one stream's frames), and a handler may send, which
        # journals under _jlock only — no cycle
        self._lock = threading.RLock()
        self.stats = {"nacks_sent": 0, "nacks_got": 0,
                      "retransmits_sent": 0, "retransmits_got": 0,
                      "recovered": 0, "gave_up": 0, "dups_dropped": 0,
                      "gone_sent": 0, "reopened": 0}
        self._last_advert = (0, ())  # (bseq, dseq tuple) last advertised
        self._advert_due = 0.0
        self._advert_sent_t = 0.0
        self._wake = threading.Event()  # gap registered: repair NOW
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        bus.reliable = self
        bus.on(NACK_KIND, self._on_nack)
        bus.on(GONE_KIND, self._on_gone)
        bus.on(TOP_KIND, self._on_top)
        bus.on(RT_KIND, self._on_rt)
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="rl-repair")
            # a bus whose sends can block on backpressure (shm rings)
            # must bound THIS thread's sends like its own recv thread's:
            # pump's _drain dispatches recovered frames' handlers under
            # self._lock, which on_stamped (recv thread) also takes — a
            # repair-thread handler reply stuck the full send budget
            # would park inbound draining transitively
            note = getattr(bus, "note_drain_critical", None)
            if note is not None:
                note(self._thread)
            self._thread.start()

    @classmethod
    def install(cls, bus, spec: str = "1") -> "ReliableChannel":
        """Build from a knob string: ``"1"`` = defaults, else
        ``"journal=1024,budget=12,backoff_ms=25,advert_ms=200"``."""
        kw: dict = {}
        names = {"journal": ("journal_frames", int),
                 "journal_bytes": ("journal_bytes", int),
                 "budget": ("retry_budget", int),
                 "backoff_ms": ("backoff_ms", float),
                 "backoff_max_ms": ("backoff_max_ms", float),
                 "advert_ms": ("advert_ms", float),
                 "settle_ms": ("settle_ms", float),
                 "idle_tick_ms": ("idle_tick_ms", float)}
        if spec not in ("1", "true", "on"):
            for entry in filter(None, (e.strip()
                                       for e in spec.split(","))):
                k, _, v = entry.partition("=")
                if k not in names:
                    raise ValueError(f"unknown reliable knob {k!r} "
                                     f"(expected one of {sorted(names)})")
                name, conv = names[k]
                kw[name] = conv(v)
        return cls(bus, **kw)

    # ------------------------------------------------------------ send side
    def journal_stamped(self, stream: str, dest: int, seq: int,
                        msg: bytes, blob: Optional[bytes]) -> None:
        """Retain a just-stamped frame for retransmission; called by the
        backend's ``_emit`` under its stamp lock. ``dest`` is -1 for the
        broadcast stream. Bounded both in frames and in bytes."""
        nb = len(msg) + (len(blob) if blob is not None else 0)
        key = (stream, dest)
        with self._jlock:
            ring = self._journal.setdefault(key, OrderedDict())
            ring[seq] = (msg, blob)
            total = self._jbytes.get(key, 0) + nb
            # keep >= 1: a single oversized frame must stay repairable
            while len(ring) > 1 and (len(ring) > self.journal_frames
                                     or total > self.journal_bytes):
                _, (m, b) = ring.popitem(last=False)
                total -= len(m) + (len(b) if b is not None else 0)
            self._jbytes[key] = total

    def _on_nack(self, sender: int, payload: dict) -> None:
        stream = str(payload.get("s", "b"))
        seqs = [int(s) for s in payload.get("seqs", [])]
        key = (stream, -1 if stream == "b" else sender)
        with self._jlock:
            ring = self._journal.get(key, {})
            found = [(s, ring[s]) for s in seqs if s in ring]
            missing = [s for s in seqs if s not in ring]
        with self._lock:
            self.stats["nacks_got"] += 1
            self.stats["retransmits_sent"] += len(found)
            self.stats["gone_sent"] += len(missing)
        for _s, (msg, blob) in found:
            # wrap the ORIGINAL stamped head: the wrapper is unstamped
            # (no new seq, never journaled), the receiver's sequencer
            # slots the inner frame by its original seq. The wrapper
            # shape lives in framing.rt_wrap — the shm backend's
            # record-cap pre-check must size the SAME wrapper
            self.bus.send(sender, RT_KIND, rt_wrap(msg), blob=blob)
        if missing:
            self.bus.send(sender, GONE_KIND,
                          {"s": stream, "seqs": missing})

    # --------------------------------------------------------- receive side
    def on_stamped(self, msg: dict, blob: Optional[bytes]) -> None:
        """Sequencer entry (from ``deliver_post_wire``): deliver-once,
        in per-link seq order; gaps become NACK work for the repair
        thread."""
        sender = int(msg.get("sender", -1))
        stream = "b" if "bs" in msg else "d"
        seq = int(msg["bs"] if stream == "b" else msg["ds"])
        now = self._clock()
        with self._lock:
            rx = self._rx_for(sender, stream)
            if rx.heal:
                # the link is speaking again: any frame from the sender
                # is the heal signal — reopen the budget-given-up hole
                # BEFORE judging this seq against exp (the reopen may
                # rewind exp below it)
                self._try_reopen(rx, sender, stream, now)
            if seq < rx.exp or seq in rx.buf:
                self.stats["dups_dropped"] += 1
                return
            gap = rx.gaps.pop(seq, None)
            if gap is not None:
                self.stats["recovered"] += 1
                tr = _trc.TRACER
                if tr is not None:
                    # the retransmit span: gap open -> frame recovered
                    tr.complete("reliable", "retransmit", gap.t0,
                                {"sender": sender, "stream": stream,
                                 "seq": seq, "tries": gap.tries},
                                t1=now)
            if seq == rx.exp:
                self._deliver(msg, blob)
                rx.exp += 1
                rx.dhi = rx.exp
                self._drain(rx)
            else:
                if seq - rx.exp > self.buffer_cap:
                    # pathological jump (a stale run's frame, or loss so
                    # catastrophic no journal could repair it): do NOT
                    # materialize a gap entry per missing seq under the
                    # receive thread's lock — resync just behind the new
                    # frame and count the abandoned range. The loss
                    # tracker books it via the seq jump at delivery.
                    self.stats["gave_up"] += seq - self.buffer_cap - rx.exp
                    rx.exp = seq - self.buffer_cap
                    rx.skip = {s for s in rx.skip if s >= rx.exp}
                    rx.gaps = {s: g for s, g in rx.gaps.items()
                               if s >= rx.exp}
                    rx.buf = {s: v for s, v in rx.buf.items()
                              if s >= rx.exp}
                    rx.heal.clear()  # a resync abandons the healable
                    #                  hole: its range is unreachable now
                    self._drain(rx)
                    if seq == rx.exp:  # the drain caught up to this frame
                        self._deliver(msg, blob)
                        rx.exp += 1
                        rx.dhi = rx.exp
                        self._drain(rx)
                        return
                rx.buf[seq] = (msg, blob)
                opened = False
                for s in range(rx.exp, seq):
                    if s not in rx.buf and s not in rx.gaps \
                            and s not in rx.skip:  # given-up stays given up
                        rx.gaps[s] = _Gap(now + self.settle_s, now)
                        opened = True
                if opened:
                    self._wake.set()  # repair thread: leave the idle tick
                # flood valve: a buffer past the cap means the gap is not
                # getting repaired while traffic floods in — give up the
                # oldest gaps rather than hold unbounded memory
                while len(rx.buf) > self.buffer_cap and rx.gaps:
                    oldest = min(rx.gaps)
                    rx.gaps.pop(oldest)
                    rx.skip.add(oldest)
                    self.stats["gave_up"] += 1
                    self._drain(rx)

    def _try_reopen(self, rx: _Rx, sender: int, stream: str,
                    now: float) -> None:
        """POST-HEAL RECOVERY REOPEN (caller holds the lock): a
        partition outlasting the NACK budget marked its seqs skipped
        and the sequencer advanced past the hole — but nothing LATER
        was ever delivered (the cut silenced the whole link), so the
        hole is still repairable in order if the sender's journal held
        on. The first frame (or top advert) from the sender proves the
        link healed: rewind ``exp`` to the hole's base, open fresh
        gaps with a fresh budget, and let the normal NACK loop finish
        the job. Sound iff no seq at or above the hole was delivered
        (``dhi`` is the bar — a delivered successor makes late
        delivery an ordering violation, and the hole stays the counted
        loss it already is). Bounded: each seq reopens at most ONCE
        (``_Gap.reopened`` — a second exhaustion is permanent), the
        heal set is capped at ``buffer_cap``, and the count lands in
        ``stats["reopened"]``."""
        lo = min(rx.heal)
        n = rx.exp - lo
        if lo < rx.dhi or n <= 0 or n > self.buffer_cap:
            rx.heal.clear()
            return
        reopened = 0
        for s in range(lo, rx.exp):
            if s in rx.gone:
                # the sender already confessed eviction for this seq:
                # re-skip it directly — re-NACKing would just buy a
                # second gone round-trip and double-count gave_up
                rx.skip.add(s)
                continue
            rx.gaps[s] = _Gap(now + self.settle_s, now, reopened=True)
            rx.skip.discard(s)
            reopened += 1
        rx.exp = lo
        rx.heal.clear()
        if reopened == 0:
            # every seq in the hole was gone: nothing to ask — drain
            # straight past the re-skipped range
            self._drain(rx)
            return
        self.stats["reopened"] += reopened
        self._wake.set()
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("reliable", "reopened",
                       {"sender": sender, "stream": stream,
                        "lo": lo, "n": reopened})
        # a heal-reopen is a recovery DECISION worth the black box (the
        # partition drill reconstructs cut -> give-up -> heal -> reopen)
        _fl.record("reliable_reopen",
                   {"sender": sender, "stream": stream, "n": reopened})

    def _rx_for(self, sender: int, stream: str) -> _Rx:
        """Stream state, created on first touch (caller holds the lock).
        Creation PRIMES the loss tracker at seq 0: this channel defines
        streams as starting there, so an unrepairable startup hole is a
        counted loss, not a forgiven sync window."""
        key = (sender, stream)
        rx = self._rx.get(key)
        if rx is None:
            rx = self._rx[key] = _Rx()
            loss = getattr(self.bus, "loss", None)
            if loss is not None:
                loss.prime(sender, stream)
        return rx

    def _drain(self, rx: _Rx) -> None:
        """Advance past buffered frames and given-up holes (caller holds
        the lock). Loss accounting for skipped seqs lands in the bus's
        FrameLossTracker via the seq jump of the next delivered frame."""
        while True:
            if rx.exp in rx.buf:
                msg, blob = rx.buf.pop(rx.exp)
                self._deliver(msg, blob)
                rx.exp += 1
                rx.dhi = rx.exp
            elif rx.exp in rx.skip:
                rx.skip.discard(rx.exp)
                rx.exp += 1
            else:
                return

    def _deliver(self, msg: dict, blob: Optional[bytes]) -> None:
        from minips_tpu_torch.comm.bus import dispatch_parsed

        dispatch_parsed(self.bus._handlers, msg, blob, loss=self.bus.loss)

    def _on_rt(self, sender: int, payload: dict) -> None:
        blob = payload.get("__blob__")
        raw = payload.get("m2", payload.get("m", ""))
        inner = decode_head(raw) if raw else None
        if inner is None:
            self.bus.loss.note_malformed()
            return
        with self._lock:
            self.stats["retransmits_got"] += 1
        if "bs" in inner or "ds" in inner:
            self.on_stamped(inner, blob)

    def _on_gone(self, sender: int, payload: dict) -> None:
        stream = str(payload.get("s", "b"))
        gone = 0
        with self._lock:
            rx = self._rx.get((sender, stream))
            if rx is None:
                return
            tr = _trc.TRACER
            for s in (int(x) for x in payload.get("seqs", [])):
                rx.heal.discard(s)  # journal-evicted: never reopenable
                if len(rx.gone) >= self.buffer_cap:
                    rx.gone.discard(min(rx.gone))
                rx.gone.add(s)      # a reopen spanning s re-skips it
                if rx.gaps.pop(s, None) is not None:
                    rx.skip.add(s)
                    self.stats["gave_up"] += 1
                    gone += 1
                    if tr is not None:
                        tr.instant("reliable", "gave_up",
                                   {"sender": sender, "stream": stream,
                                    "seq": s, "why": "gone"})
            self._drain(rx)
        if gone:
            # a journal-evicted seq is UNRECOVERED loss on a reliable
            # stream: poison-class, dump the black box (outside the
            # channel lock — the dump is file I/O)
            _fl.poison("reliable_give_up",
                       {"sender": sender, "stream": stream, "n": gone,
                        "why": "gone"})

    def _on_top(self, sender: int, payload: dict) -> None:
        """A sender's advertised stream tops: open gaps for trailing
        losses no successor frame will ever reveal."""
        now = self._clock()
        tops = [("b", payload.get("b"))]
        d_top = (payload.get("d") or {}).get(str(self.bus.my_id))
        tops.append(("d", d_top))
        with self._lock:
            for stream, top in tops:
                if top is None:
                    continue
                top = int(top)
                rx = self._rx_for(sender, stream)
                if rx.heal:
                    # post-heal advert: the link speaks again — reopen
                    # the budget-given-up hole before judging the top
                    self._try_reopen(rx, sender, stream, now)
                for s in range(rx.exp, min(top, rx.exp + self.buffer_cap)):
                    if s not in rx.buf and s not in rx.gaps \
                            and s not in rx.skip:
                        rx.gaps[s] = _Gap(now + self.settle_s, now)
                        self._wake.set()

    # -------------------------------------------------------- repair thread
    def pump(self, now: Optional[float] = None) -> None:
        """One repair pass: give up exhausted gaps, send due NACKs, and
        advertise my stream tops. Public and clock-injectable so the
        protocol is unit-testable without threads."""
        now = self._clock() if now is None else now
        nacks: list[tuple[int, str, list[int]]] = []
        gave_up: list[tuple[int, str, int]] = []
        with self._lock:
            # snapshot: _drain dispatches handlers under the lock, and a
            # handler must not invalidate this iteration by touching _rx
            for (sender, stream), rx in list(self._rx.items()):
                due = [s for s, g in rx.gaps.items() if g.due <= now]
                if not due:
                    continue
                ask = []
                for s in sorted(due):
                    g = rx.gaps[s]
                    if g.tries >= self.retry_budget:
                        rx.gaps.pop(s)
                        rx.skip.add(s)
                        self.stats["gave_up"] += 1
                        if not g.reopened:
                            # budget exhausted into a (possibly cut)
                            # void — the sender may still hold the
                            # frame journaled: remember the hole so a
                            # post-heal advert/frame can reopen it ONCE
                            # (bounded; a reopened gap's second
                            # exhaustion is permanent)
                            if len(rx.heal) >= self.buffer_cap:
                                rx.heal.discard(min(rx.heal))
                            rx.heal.add(s)
                        gave_up.append((sender, stream, s))
                        tr = _trc.TRACER
                        if tr is not None:
                            tr.instant("reliable", "gave_up",
                                       {"sender": sender,
                                        "stream": stream, "seq": s})
                    else:
                        if len(ask) >= _NACK_BATCH:
                            # this pass's NACK is full: leave the rest
                            # DUE (untouched) for the next pump — a seq
                            # must never be charged a try for a NACK
                            # that was never sent, or a burst wider
                            # than budget*batch would exhaust unasked
                            break
                        g.tries += 1
                        g.due = now + min(
                            self.backoff_s * (2 ** g.tries),
                            self.backoff_max_s)
                        ask.append(s)
                self._drain(rx)
                if ask:
                    nacks.append((sender, stream, ask))
                    self.stats["nacks_sent"] += 1
        if gave_up:
            # retry budget exhausted: the stream hole is now permanent
            # loss the wire will book at the next delivery jump —
            # poison-class, one dump per pump pass (outside the lock)
            _fl.poison("reliable_give_up",
                       {"why": "budget",
                        "links": sorted({(s, st)
                                         for s, st, _ in gave_up}),
                        "n": len(gave_up)})
        tr = _trc.TRACER
        if tr is not None:
            for sender, stream, seqs in nacks:
                tr.instant("reliable", "nack",
                           {"to": sender, "stream": stream,
                            "n": len(seqs)})
        for sender, stream, seqs in nacks:  # outside the lock: sends can
            try:                            # block (native bounded outbox)
                self.bus.send(sender, NACK_KIND,
                              {"s": stream, "seqs": seqs})
            except Exception:  # noqa: BLE001 - teardown race: bus closing
                return
        if now >= self._advert_due:
            self._advert(now)

    def _advert(self, now: float) -> None:
        self._advert_due = now + self.advert_s
        bseq = int(getattr(self.bus, "_bseq", 0))
        dseq = tuple(int(x) for x in getattr(self.bus, "_dseq", ()))
        if (bseq, dseq) == self._last_advert \
                and now - self._advert_sent_t < 10 * self.advert_s:
            # unchanged tops still REFRESH at a slow cadence: the advert
            # frame itself can be lost, and if traffic then stops, a
            # trailing gap would otherwise stay invisible until a
            # deadline poison — exactly the death this layer exists to
            # prevent
            return
        self._last_advert = (bseq, dseq)
        self._advert_sent_t = now
        try:
            self.bus.publish(TOP_KIND, {
                "b": bseq,
                "d": {str(i): s for i, s in enumerate(dseq) if s}})
        except Exception:  # noqa: BLE001 - teardown race: bus closing
            pass

    def _loop(self) -> None:
        # EVENT-DRIVEN with an adaptive tick: a repair thread that wakes
        # every few ms forces a GIL handoff from the busy training/recv
        # threads at every wake — on a host whose cores the world size
        # oversubscribes that steals timeslices measurably (the same
        # lesson as the recv loop's drain-per-wake fix, comm/bus.py).
        # So: sleep the long idle tick (advert cadence is the only idle
        # duty), get KICKED awake the moment a gap registers, and tick
        # at ~half-settle only while gaps are actually outstanding —
        # NACK latency stays tens of ms, the clean path pays ~nothing.
        fast = max(self.settle_s / 2.0, 0.004)
        while not self._stop.is_set():
            with self._lock:
                busy = any(rx.gaps for rx in self._rx.values())
            self._wake.wait(timeout=fast if busy else self.idle_tick_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            self.pump()

    # ------------------------------------------------------------- plumbing
    def outstanding_gaps(self) -> int:
        with self._lock:
            return sum(len(rx.gaps) for rx in self._rx.values())

    def gap_ages(self) -> dict[str, float]:
        """Oldest OUTSTANDING gap age in seconds per link
        (``"<sender>:<stream>"``) — the per-link health observable the
        windowed layer gauges: a gap that keeps aging is a repair loop
        losing, visible long before the give-up poison."""
        now = self._clock()
        with self._lock:
            return {f"{s}:{st}": round(now - min(g.t0 for g in
                                                 rx.gaps.values()), 4)
                    for (s, st), rx in self._rx.items() if rx.gaps}

    def oldest_gap_age(self) -> float:
        """Max over links of :meth:`gap_ages` (0.0 when gap-free) —
        the scalar the windowed layer registers as a gauge."""
        ages = self.gap_ages()
        return max(ages.values()) if ages else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
        out["outstanding_gaps"] = self.outstanding_gaps()
        ages = self.gap_ages()
        out["oldest_gap_age_s"] = (round(max(ages.values()), 4)
                                   if ages else 0.0)
        out["gap_ages_s"] = ages or None
        return out

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # unblock the idle wait
        if self._thread is not None:
            self._thread.join(timeout=2.0)
