"""ChaosBus — deterministic seeded fault injection for the PS wire.

The fault story so far is detect-then-restart (heartbeats find a corpse,
everyone reloads the checkpoint) plus *counting* wire loss
(``FrameLossTracker``). What it lacked was a way to MAKE loss happen on
demand: zmq over loopback essentially never drops below the HWM, so the
recovery machinery (comm/reliable.py retransmits, the timeout poisons,
the heartbeat ladder) ran only in production-shaped accidents. This
module is the missing half: a fault injector installed on a bus's
RECEIVE path (``deliver_frame`` in comm/bus.py) that drops, duplicates,
delays, and reorders frames from a seeded, hash-based decision function
— the same spec + seed reproduces the same fate for every frame, on
either backend, regardless of thread interleaving, so every failure mode
is a unit test instead of a 3am page.

Injection is receiver-side on purpose: a sender-side drop would happen
BEFORE the per-link sequence number is consumed, leaving no gap for the
loss tracker or the reliable channel to detect — indistinguishable from
the frame never having been sent. Dropping after the seq is on the wire
is exactly what real loss (HWM overflow, a torn link tail, a lossy
network hop) looks like to the receiver.

Spec grammar (``$MINIPS_CHAOS`` or ``make_bus(..., chaos=...)``)::

    <seed>:<entry>,<entry>,...
    entry   := <knob>=<value>
    knob    := op[@kindprefix][#senderid] | delay_ms | reorder_ms
             | slow#<link> | part | links | at | for
    op      := drop | dup | delay | reorder
    link    := <a>-<b>   (symmetric)  |  <a>><b>  (a's frames to b only)

e.g. ``MINIPS_CHAOS="1234:drop=0.01,dup=0.005,delay=0.01,delay_ms=20"``
or per-kind/per-link: ``"7:drop=0,drop@psr=0.05,drop#2=0.1"`` (pull
replies 5%, anything from rank 2 10%). The most specific matching entry
wins (kind+sender > kind > sender > global; longer kind prefixes beat
shorter ones).

**Link-level partitions (this PR).** ``part=<pseed>`` opens a partition
ENTRY (the ``MINIPS_CHAOS_KILL`` entry-assembly grammar); the
``links=``, ``at=`` and ``for=`` that follow bind to it::

    MINIPS_CHAOS="7:part=1,links=0-1+0-2,at=8,for=3s"

cuts EVERY frame on the rank-0↔1 and 0↔2 links (a full isolation of
rank 0, both directions — ``0>1`` would cut only 0's frames arriving at
1, the asymmetric half-partition) from the receiver's clock boundary 8
until 3 wall seconds later. ``at=`` and ``for=`` each take either a
step count (clock boundaries, via :meth:`ChaosBus.on_clock` — the
trainer's tick feeds it) or a wall-seconds value with an ``s`` suffix;
ranges (``at=8-12``) draw seeded-uniform from ``H(seed, pseed, tag)``
so every rank computes the same window without coordination. Caveat a
drill author must know: a duration in STEPS only closes when the
receiver's own clock advances, and a partition that stalls the whole
fleet stalls every clock — fleet-stalling cuts must use wall-second
durations (``for=3s``) or they never heal (docs/fault_tolerance.md
names the trap; the parser cannot, it does not know the fleet shape).
Partition drops land on the receive path exactly like ``drop`` fates
(after the seq is consumed, so the reliable layer sees a gap it can
repair post-heal) and are counted separately (``part_dropped``).

**Sustained per-link degradation.** ``slow#<a>-<b>=<ms>`` (or
``slow#<a>><b>=<ms>``) delays every frame on that link by a FIXED
``ms`` — latency, not loss: the constant delay preserves per-link
order, modeling a congested or long-haul link rather than a lossy one.
A frame that also draws the ``delay`` fate pays the jittered delay
PLUS the link tax; a frame that draws ``reorder`` rides the reorder
park untaxed (the park IS its delay — stacking the tax on top would
double-charge the swap window).

An optional JITTER term ``slow#<a>-<b>=<ms>~<jitter_ms>`` draws each
frame's tax seeded-uniform from ``[ms - jitter, ms + jitter]``
(clamped at 0; the draw is ``H(frame identity, "slowj")``, so the
same spec reproduces the same per-frame taxes) — the variance a real
sick NIC shows, which a fail-slow DETECTOR must not be fooled by.
Trade the drill author accepts: with jitter, two frames' taxes can
differ enough for the later one to overtake — jittered slow links may
REORDER, unlike the plain fixed tax (arm MINIPS_RELIABLE when the
workload needs per-link order back).

Determinism: each frame's fate is ``H(seed, my_id, sender, stream, seq,
op) / 2^64`` (blake2b) — a pure function of the frame's identity, not of
arrival order or RNG consumption, so two runs with the same spec and the
same frame streams inject identical faults even though threads
interleave differently. Unstamped frames (handshake, NACK/retransmit
control traffic) are keyed by a per-(sender, kind) arrival counter
instead of a seq — deterministic per receiver because each such stream
rides one FIFO link.

Every process in a drill should run the SAME spec (the launcher's env
inheritance does this for free); per-link knobs then shape asymmetry.

A copy of ``minips_tpu/comm/chaos.py``, which imports no JAX.
"""

from __future__ import annotations

import hashlib
import heapq
import struct
import threading
import time
from typing import Optional

from minips_tpu_torch.comm.framing import dup_msg
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc

__all__ = ["ChaosSpec", "ChaosBus", "PartitionEntry"]

_OPS = ("drop", "dup", "delay", "reorder")


def _parse_link(tok: str, ctx: str) -> tuple[int, int, bool]:
    """One link token → ``(a, b, bidirectional)``. ``a-b`` cuts/slows
    both directions, ``a>b`` only frames FROM a arriving AT b. Refuses
    self-links and non-int ranks loudly, naming the token — the fuzzer
    contract: a bad spec never half-configures an injector."""
    if ">" in tok:
        a_s, _, b_s = tok.partition(">")
        bidir = False
    else:
        a_s, _, b_s = tok.partition("-")
        bidir = True
    try:
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(f"{ctx}: bad link token {tok!r} "
                         "(expected <rank>-<rank> or <rank>><rank>)")
    if a < 0 or b < 0:
        raise ValueError(f"{ctx}: negative rank in link {tok!r}")
    if a == b:
        raise ValueError(f"{ctx}: self-link {tok!r} cuts nothing")
    return a, b, bidir


def _parse_window_val(val: str, knob: str) -> tuple[str, int, int,
                                                    float, float]:
    """``at=``/``for=`` value → ``(unit, lo, hi, flo, fhi)``: a step
    count (clock boundaries) or, with an ``s`` suffix, wall seconds;
    either may be a ``lo-hi`` range drawn seeded at resolve time."""
    val = val.strip()
    unit = "step"
    if val.endswith("s"):
        unit, val = "sec", val[:-1]
    lo_s, dash, hi_s = val.partition("-")
    try:
        if unit == "sec":
            flo = float(lo_s)
            fhi = float(hi_s) if dash else flo
            lo = hi = 0
        else:
            lo = int(lo_s)
            hi = int(hi_s) if dash else lo
            flo = fhi = 0.0
    except ValueError:
        raise ValueError(f"chaos {knob}={val!r}: expected <n>[-<m>] "
                         "steps or <sec>[-<sec>]s")
    if (unit == "step" and (lo < 0 or hi < lo)) \
            or (unit == "sec" and (flo < 0 or fhi < flo)):
        raise ValueError(f"chaos {knob}={val!r}: empty/negative range")
    return unit, lo, hi, flo, fhi


class PartitionEntry:
    """One seeded partition window over a set of directed links."""

    __slots__ = ("pseed", "links", "at", "dur")

    def __init__(self, pseed: int, links: list[tuple[int, int, bool]],
                 at: tuple, dur: tuple):
        self.pseed = int(pseed)
        self.links = links      # [(a, b, bidir), ...]
        self.at = at            # window-val tuple (see _parse_window_val)
        self.dur = dur

    def cuts(self, sender: int, receiver: int) -> bool:
        for a, b, bidir in self.links:
            if (a == sender and b == receiver) \
                    or (bidir and a == receiver and b == sender):
                return True
        return False

    def resolve(self, seed: int) -> tuple:
        """``(at_unit, at_value, dur_unit, dur_value)`` with ranges
        drawn from ``H(seed, pseed, tag)`` — pure, every rank agrees."""
        def draw(tag: str, lo, hi):
            if hi <= lo:
                return lo
            key = f"{seed}|part|{self.pseed}|{tag}".encode()
            h = struct.unpack(
                "<Q", hashlib.blake2b(key, digest_size=8).digest())[0]
            if isinstance(lo, int):
                return lo + h % (hi - lo + 1)
            return lo + (h / 2.0 ** 64) * (hi - lo)

        at_u, alo, ahi, aflo, afhi = self.at
        d_u, dlo, dhi, dflo, dfhi = self.dur
        at_v = draw("at", alo, ahi) if at_u == "step" \
            else draw("at", aflo, afhi)
        d_v = draw("for", dlo, dhi) if d_u == "step" \
            else draw("for", dflo, dfhi)
        return at_u, at_v, d_u, d_v


class ChaosSpec:
    """Parsed chaos schedule: seed + per-op rate entries + hold params
    + partition windows + sustained slow links."""

    def __init__(self, seed: int, rates: dict, delay_ms: float = 20.0,
                 reorder_ms: float = 50.0,
                 partitions: Optional[list] = None,
                 slow: Optional[list] = None):
        # rates: op -> list of (kind_prefix | None, sender | None, rate)
        self.seed = int(seed)
        self.rates = rates
        self.delay_ms = float(delay_ms)
        self.reorder_ms = float(reorder_ms)
        self.partitions: list[PartitionEntry] = partitions or []
        # slow: [(a, b, bidir, ms, jitter_ms)] — sustained per-link
        # delay; legacy 4-tuples (pre-jitter callers) normalize to 0
        self.slow = [(t + (0.0,) if len(t) == 4 else t)
                     for t in (slow or [])]

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        spec = spec.strip()
        if ":" in spec:
            seed_s, _, body = spec.partition(":")
        else:  # bare seed: chaos armed but all rates zero (bench control)
            seed_s, body = spec, ""
        try:
            seed = int(seed_s)
        except ValueError:
            raise ValueError(
                f"chaos spec must start with '<int seed>:', got {spec!r}")
        rates: dict = {op: [] for op in _OPS}
        delay_ms, reorder_ms = 20.0, 50.0
        partitions: list[PartitionEntry] = []
        slow: list[tuple[int, int, bool, float]] = []
        # part= opens a partition ENTRY; links=/at=/for= bind to it
        # (the MINIPS_CHAOS_KILL entry-assembly grammar)
        cur: Optional[dict] = None

        def close_part() -> None:
            nonlocal cur
            if cur is None:
                return
            if not cur["links"]:
                raise ValueError(
                    f"chaos part={cur['pseed']}: no links= bound to "
                    "the entry (a partition must name what it cuts)")
            partitions.append(PartitionEntry(
                cur["pseed"], cur["links"],
                cur["at"] or ("step", 0, 0, 0.0, 0.0),
                cur["dur"] or ("sec", 0, 0, 1e18, 1e18)))
            cur = None

        for entry in filter(None, (e.strip() for e in body.split(","))):
            if "=" not in entry:
                raise ValueError(f"chaos entry {entry!r} lacks '='")
            knob, _, val = entry.partition("=")
            if knob == "delay_ms":
                delay_ms = float(val)
                continue
            if knob == "reorder_ms":
                reorder_ms = float(val)
                continue
            if knob == "part":
                close_part()
                try:
                    pseed = int(val)
                except ValueError:
                    raise ValueError(
                        f"chaos part={val!r}: entry seed must be an int")
                cur = {"pseed": pseed, "links": [], "at": None,
                       "dur": None}
                continue
            if knob in ("links", "at", "for"):
                if cur is None:
                    raise ValueError(
                        f"chaos {entry!r}: {knob}= outside a part= "
                        "entry (part=<seed> opens one)")
                if knob == "links":
                    for tok in filter(None, (t.strip()
                                             for t in val.split("+"))):
                        cur["links"].append(_parse_link(tok, "chaos"))
                    if not cur["links"]:
                        raise ValueError(
                            f"chaos {entry!r}: empty link list")
                elif knob == "at":
                    cur["at"] = _parse_window_val(val, "at")
                else:
                    cur["dur"] = _parse_window_val(val, "for")
                continue
            if knob.startswith("slow#"):
                a, b, bidir = _parse_link(knob[len("slow#"):],
                                          "chaos slow")
                ms_s, tilde, jit_s = val.partition("~")
                try:
                    ms = float(ms_s)
                    jit = float(jit_s) if tilde else 0.0
                except ValueError:
                    raise ValueError(
                        f"chaos {entry!r}: slow needs "
                        "<ms>[~<jitter_ms>] float values")
                if ms <= 0:
                    raise ValueError(
                        f"chaos {entry!r}: slow ms must be > 0")
                if jit < 0:
                    raise ValueError(
                        f"chaos {entry!r}: slow jitter must be >= 0")
                slow.append((a, b, bidir, ms, jit))
                continue
            sender: Optional[int] = None
            if "#" in knob:
                knob, _, snd = knob.partition("#")
                try:
                    sender = int(snd)
                except ValueError:
                    raise ValueError(
                        f"chaos entry {entry!r}: sender id after '#' "
                        "must be an int")
            kind: Optional[str] = None
            if "@" in knob:
                knob, _, kind = knob.partition("@")
            if knob not in _OPS:
                raise ValueError(
                    f"unknown chaos op {knob!r} (expected one of {_OPS})")
            try:
                rate = float(val)
            except ValueError:
                raise ValueError(
                    f"chaos entry {entry!r}: rate must be a float")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"chaos rate {entry!r} outside [0, 1]")
            rates[knob].append((kind, sender, rate))
        close_part()
        return cls(seed, rates, delay_ms, reorder_ms,
                   partitions=partitions, slow=slow)

    def rate(self, op: str, kind: str, sender: int) -> float:
        """Most specific matching entry wins; 0.0 when none match."""
        best, best_score = 0.0, -1
        for kprefix, snd, rate in self.rates.get(op, ()):
            if snd is not None and snd != sender:
                continue
            if kprefix is not None and not kind.startswith(kprefix):
                continue
            score = ((len(kprefix) + 1) if kprefix is not None else 0) * 2 \
                + (1 if snd is not None else 0)
            if score > best_score:
                best, best_score = rate, score
        return best

    def active(self) -> bool:
        return (any(e for e in self.rates.values())
                or bool(self.partitions) or bool(self.slow))


class ChaosBus:
    """The injector object installed at ``bus.chaos``; ``deliver_frame``
    routes every received frame through :meth:`on_wire`, which forwards
    the survivors (possibly late, possibly twice, possibly swapped) to
    ``deliver_post_wire`` — i.e. to the reliable channel / handlers,
    which sit ABOVE the simulated wire and never see the injector."""

    def __init__(self, bus, spec: "ChaosSpec | str"):
        if isinstance(spec, str):
            spec = ChaosSpec.parse(spec)
        self.bus = bus
        self.spec = spec
        self.stats = {"frames": 0, "dropped": 0, "duplicated": 0,
                      "delayed": 0, "reordered": 0, "part_dropped": 0,
                      "slowed": 0}
        # partition windows: receiver-local clock fed by the trainer's
        # tick (on_clock); wall anchor for the 's'-suffixed windows and
        # for step-opened/seconds-long mixed windows (the fleet-stalling
        # drill shape — a cut that stalls every clock must heal by wall
        # time). _part_open maps entry index -> wall open time once a
        # step-opened window fires, so its seconds duration has an
        # anchor.
        self._clock = 0
        self._t0 = time.monotonic()
        self._part_open: dict[int, float] = {}
        self._part_state: dict[int, bool] = {}  # for open/close records
        # resolve every entry's window once (pure function of seeds)
        self._parts = [(p, p.resolve(spec.seed))
                       for p in spec.partitions]
        # sustained slow links: my inbound (tax, jitter) per sender,
        # precomputed — the per-frame cost of an armed-but-elsewhere
        # slow spec is one dict lookup that misses. Ties break by the
        # LARGER base tax (the worse link wins, like per-link drops).
        self._slow_in: dict[int, tuple[float, float]] = {}

        def _merge_slow(snd: int, ms: float, jit: float) -> None:
            cur = self._slow_in.get(snd)
            if cur is None or ms > cur[0]:
                self._slow_in[snd] = (ms, jit)

        me = int(getattr(bus, "my_id", -1))
        for a, b, bidir, ms, jit in spec.slow:
            if b == me:
                _merge_slow(a, ms, jit)
            if bidir and a == me:
                _merge_slow(b, ms, jit)
        self._lock = threading.Lock()
        self._uctr: dict[tuple, int] = {}   # (sender, kind) -> arrivals
        self._held: dict[tuple, tuple] = {}  # link -> (due, msg, blob)
        self._heap: list[tuple] = []         # (due, tie, msg, blob)
        self._tie = 0
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-sched")
        self._thread.start()

    @classmethod
    def install(cls, bus, spec: "ChaosSpec | str") -> "ChaosBus":
        bus.chaos = cls(bus, spec)
        return bus.chaos

    # ---------------------------------------------------------- partitions
    def on_clock(self, clock: int) -> None:
        """Clock-boundary feed from the trainer's tick (the same point
        the seeded kill check runs): advances the receiver-local step
        the partition windows key on. A plain int store — GIL-atomic,
        no lock on the tick path."""
        self._clock = int(clock)

    def _partition_cuts(self, sender: int) -> bool:
        """Is any partition window currently cutting ``sender`` → me?
        Called per frame ONLY when partitions are configured (the
        injector's zero-config paths never reach here)."""
        me = int(self.bus.my_id)
        now = time.monotonic()
        clock = self._clock
        cut = False
        for i, (p, (at_u, at_v, d_u, d_v)) in enumerate(self._parts):
            # window OPEN test (receiver-local): step windows open at
            # the configured boundary, second windows at wall offset
            if at_u == "step":
                opened = clock >= at_v
            else:
                opened = (now - self._t0) >= at_v
            if opened and i not in self._part_open:
                self._part_open[i] = now
            # window CLOSE test: step durations close by clock, second
            # durations by wall time since the window actually opened
            active = False
            if opened:
                if d_u == "step" and at_u == "step":
                    active = clock < at_v + d_v
                elif d_u == "step":  # sec-open: clock anchor at open
                    active = clock < d_v + self._clock_at_open(i)
                else:
                    active = now - self._part_open[i] < d_v
            if active != self._part_state.get(i, False):
                self._part_state[i] = active
                _fl.record("chaos_part_open" if active
                           else "chaos_part_heal",
                           {"entry": p.pseed, "clock": clock,
                            "links": [f"{a}{'-' if bi else '>'}{b}"
                                      for a, b, bi in p.links]})
            if active and p.cuts(sender, me):
                cut = True
        return cut

    def _clock_at_open(self, i: int) -> int:
        # sec-opened + step-duration windows need the clock at open;
        # approximate with the clock seen at first activation (stored
        # lazily) — a corner combination the drills do not use
        key = ("clk", i)
        if key not in self._part_open:
            self._part_open[key] = self._clock
        return self._part_open[key]

    # ----------------------------------------------------------- decisions
    def _u(self, op: str, sender: int, stream: str, seq: int) -> float:
        """Uniform [0,1) that is a pure function of the frame identity —
        the whole determinism story lives here."""
        key = f"{self.spec.seed}|{self.bus.my_id}|{sender}|{stream}|" \
              f"{seq}|{op}".encode()
        h = hashlib.blake2b(key, digest_size=8).digest()
        return struct.unpack("<Q", h)[0] / 2.0 ** 64

    # ------------------------------------------------------------- receive
    def on_wire(self, msg: dict, blob: Optional[bytes]) -> None:
        sender = int(msg.get("sender", -1))
        kind = str(msg.get("kind", ""))
        if "bs" in msg:
            stream, seq = "b", int(msg["bs"])
        elif "ds" in msg:
            stream, seq = "d", int(msg["ds"])
        else:
            with self._lock:
                k = (sender, kind)
                seq = self._uctr[k] = self._uctr.get(k, -1) + 1
            stream = f"u:{kind}"
        spec = self.spec
        with self._lock:
            self.stats["frames"] += 1
        if self._parts and self._partition_cuts(sender):
            # the link is CUT: every frame dies here, fates unconsulted
            # — counted apart from probabilistic drops so a drill can
            # prove the partition (not the drop rate) did the cutting.
            # The seq is already consumed, so the reliable layer sees a
            # repairable gap once the link heals — partition loss is
            # recoverable loss, by construction.
            with self._lock:
                self.stats["part_dropped"] += 1
            tr = _trc.TRACER
            if tr is not None:
                tr.instant("chaos", "part_drop",
                           {"kind": kind, "sender": sender, "seq": seq})
            self._release_held((sender, stream))
            return

        def note(op: str) -> None:
            tr = _trc.TRACER
            if tr is not None:
                # the injected fault on the timeline, next to the
                # recovery it provokes (reliable retransmit spans)
                tr.instant("chaos", op, {"kind": kind, "sender": sender,
                                         "seq": seq})

        def hit(op: str) -> bool:
            # rate first, hash only when armed: a zero-rate op must cost
            # nothing on the hot receive path (the drop-0 control arm
            # exists to measure exactly this), and skipping the draw
            # cannot change any armed op's decision — the hash is a pure
            # function of (frame identity, op), not of draw order
            r = spec.rate(op, kind, sender)
            return r > 0.0 and self._u(op, sender, stream, seq) < r

        if hit("drop"):
            with self._lock:
                self.stats["dropped"] += 1
            note("drop")
            self._release_held((sender, stream))  # a drop still advances
            return
        def slow_tax() -> float:
            # the sustained link tax for this frame, in ms: the fixed
            # base, plus the seeded per-frame jitter when configured —
            # uniform in [ms - j, ms + j] clamped at 0, a pure function
            # of the frame identity like every other fate here
            ent = self._slow_in.get(sender)
            if ent is None:
                return 0.0
            base, jit = ent
            if jit <= 0.0:
                return base
            u = self._u("slowj", sender, stream, seq)
            return max(base + (2.0 * u - 1.0) * jit, 0.0)

        dup_copy = None
        if hit("dup"):
            # copy BEFORE the first dispatch: handlers receive the payload
            # dict itself (blob attached in place) and may mutate it.
            # Codec-agnostic deep copy (framing.dup_msg): the seed's
            # json.loads(json.dumps(msg)) double-paid the codec on every
            # dup and raised on binary-only values (bytes in a
            # retransmit wrapper)
            dup_copy = (dup_msg(msg), blob)
            with self._lock:
                self.stats["duplicated"] += 1
            note("dup")
        slow_ms = slow_tax()
        if hit("delay"):
            # hold for ~delay_ms (deterministically jittered ±50%): later
            # frames on every link overtake it — delay IS reordering on
            # release, which is the point. A slowed link's tax stacks on
            # top (congestion under long-haul latency).
            jit = 0.5 + self._u("delayj", sender, stream, seq)
            self._schedule((spec.delay_ms * jit + slow_ms) / 1e3,
                           msg, blob)
            with self._lock:
                self.stats["delayed"] += 1
            note("delay")
        elif hit("reorder"):
            # adjacent swap: park until the NEXT frame on the same
            # (sender, stream) link passes, or reorder_ms elapses with no
            # successor (trailing frame: plain delay)
            link = (sender, stream)
            with self._lock:
                parked = self._held.pop(link, None)
                self._held[link] = (time.monotonic()
                                    + spec.reorder_ms / 1e3, msg, blob)
                self.stats["reordered"] += 1
                self._cond.notify()
            note("reorder")
            if parked is not None:  # two in a row: the first-held goes now
                self._forward(parked[1], parked[2])
        elif slow_ms > 0.0:
            # sustained link degradation: a fixed tax preserves
            # per-link arrival order (every frame pays the same); a
            # JITTERED tax (slow#..=ms~jit) can differ per frame by up
            # to 2*jit, so the later frame may overtake — the reorder
            # trade the module docstring documents (arm MINIPS_RELIABLE
            # when the workload needs per-link order back)
            with self._lock:
                self.stats["slowed"] += 1
            self._release_held((sender, stream))
            self._schedule(slow_ms / 1e3, msg, blob)
        else:
            self._release_held_after((sender, stream), msg, blob)
        if dup_copy is not None:
            # the duplicate lands a beat later — exercises dedup across
            # time, not just back-to-back
            self._schedule(spec.delay_ms / 1e3, *dup_copy)

    def _release_held_after(self, link: tuple, msg: dict,
                            blob: Optional[bytes]) -> None:
        """Deliver ``msg`` now; if a reorder-parked frame was waiting on
        this link, deliver it right after — the adjacent swap."""
        with self._lock:
            parked = self._held.pop(link, None)
        self._forward(msg, blob)
        if parked is not None:
            self._forward(parked[1], parked[2])

    def _release_held(self, link: tuple) -> None:
        with self._lock:
            parked = self._held.pop(link, None)
        if parked is not None:
            self._forward(parked[1], parked[2])

    def _forward(self, msg: dict, blob: Optional[bytes]) -> None:
        from minips_tpu_torch.comm.bus import deliver_post_wire

        deliver_post_wire(self.bus, msg, blob)

    # ----------------------------------------------------------- scheduler
    def _schedule(self, delay_s: float, msg: dict,
                  blob: Optional[bytes]) -> None:
        with self._lock:
            self._tie += 1
            heapq.heappush(self._heap,
                           (time.monotonic() + delay_s, self._tie, msg,
                            blob))
            self._cond.notify()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            due: list[tuple] = []
            with self._lock:
                while self._heap and self._heap[0][0] <= now:
                    due.append(heapq.heappop(self._heap))
                for link in [k for k, v in self._held.items()
                             if v[0] <= now]:
                    _, m, b = self._held.pop(link)
                    due.append((now, self._tie + 1, m, b))
                if not due:
                    if not self._heap and not self._held:
                        # fully idle: block until _schedule/park/stop
                        # notifies — an idle 20Hz poll would tax the
                        # oversubscribed host the drop-0 bench arm
                        # exists to keep honest (the repair thread's
                        # event-driven lesson, comm/reliable.py)
                        self._cond.wait()
                    else:
                        cands = [v[0] for v in self._held.values()]
                        if self._heap:
                            cands.append(self._heap[0][0])
                        self._cond.wait(timeout=max(
                            min(min(cands) - now, 0.05), 0.001))
            for _, _, m, b in due:
                if self._stop.is_set():
                    return
                self._forward(m, b)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._cond.notify_all()
        self._thread.join(timeout=2.0)


# --------------------------------------------------------------- kill drill
class KillSpec:
    """Parsed ``MINIPS_CHAOS_KILL`` — seeded deterministic process death,
    the launcher-level sibling of the frame-level injector above. The
    launcher exports the spec to every rank (env inheritance, same as
    ``MINIPS_CHAOS``); each matching rank SIGKILLs ITSELF at its chosen
    clock boundary — abrupt as an OOM kill (no atexit, no flush, no
    close), reproducible bit-for-bit because the trigger is a clock
    value, not wall time.

    Grammar::

        <seed>:rank=<r>,step=<s>[,rank=<r2>,step=<s2>,...]

    Each ``rank=`` opens a kill ENTRY and the ``step=`` that follows
    binds to it, so one spec can schedule several deaths (a coordinator
    kill composed with a server kill, the double-fault drill).
    ``rank=0`` is a legal target: since the coordinator became a LEASE
    (balance/control_plane.py) its death is a drill the plane owns, not
    an automatic gang restart — the failover drills aim the seeded kill
    at the holder on purpose. ``rank=-1`` still picks a seeded-uniform
    victim among ranks 1..n-1 (the pre-lease server-death drills keep
    their schedules); ``step=<a>-<b>`` picks a seeded-uniform step in
    ``[a, b]``. Fixed values make the seed inert but keep the spec
    shape aligned with ``MINIPS_CHAOS``.
    """

    def __init__(self, seed: int, entries: list[tuple[int, int, int]]):
        if not entries:
            raise ValueError(
                "MINIPS_CHAOS_KILL needs both rank= and step=")
        for _rank, lo, hi in entries:
            if lo < 1 or hi < lo:
                raise ValueError("chaos-kill step must be >= 1 (clock "
                                 "boundaries start at 1) with a "
                                 "non-empty range")
        self.seed = int(seed)
        self.entries = [(int(r), int(lo), int(hi))
                        for r, lo, hi in entries]
        # first-entry views: the single-kill call sites and specs
        # predate the entry list and keep reading these
        self.rank, self.step_lo, self.step_hi = self.entries[0]

    @classmethod
    def parse(cls, spec: str) -> "KillSpec":
        spec = spec.strip()
        seed_s, _, body = spec.partition(":")
        try:
            seed = int(seed_s)
        except ValueError:
            raise ValueError(
                f"MINIPS_CHAOS_KILL must start with '<int seed>:', "
                f"got {spec!r}")
        entries: list[tuple[int, int, int]] = []
        cur: Optional[list] = None  # [rank, lo, hi] being assembled
        for entry in filter(None, (e.strip() for e in body.split(","))):
            knob, _, val = entry.partition("=")
            if knob == "rank":
                if cur is not None:
                    if cur[1] is None:
                        raise ValueError(
                            "MINIPS_CHAOS_KILL needs both rank= and "
                            "step= (entry opened without a step)")
                    entries.append(tuple(cur))
                cur = [int(val), None, None]
            elif knob == "step":
                if cur is None:
                    raise ValueError(
                        "MINIPS_CHAOS_KILL needs both rank= and step= "
                        "(step= before any rank=)")
                lo, _, hi = val.partition("-")
                cur[1], cur[2] = int(lo), int(hi) if hi else int(lo)
            else:
                raise ValueError(
                    f"MINIPS_CHAOS_KILL: unknown knob {knob!r} "
                    "(expected rank=, step=)")
        if cur is None or cur[1] is None:
            raise ValueError(
                "MINIPS_CHAOS_KILL needs both rank= and step=")
        entries.append(tuple(cur))
        return cls(seed, entries)

    def resolve(self, nprocs: int) -> tuple[int, int]:
        """The FIRST entry's concrete ``(victim rank, kill clock)`` —
        the pre-list surface single-kill drills assert against."""
        return self.resolve_all(nprocs)[0]

    def resolve_all(self, nprocs: int) -> list[tuple[int, int]]:
        """Every entry's ``(victim rank, kill clock)`` for an
        ``nprocs``-rank job — a pure function of (seed, nprocs, entry
        index), so every rank computes the same schedule without
        coordination. Entry 0 draws from the exact pre-list stream
        (same rng key), keeping committed seeded drills' verdicts."""
        import numpy as np

        out = []
        for i, (rank, lo, hi) in enumerate(self.entries):
            key = (self.seed, 0x6b11, nprocs) if i == 0 \
                else (self.seed, 0x6b11, nprocs, i)
            rng = np.random.default_rng(key)
            if rank == -1:
                rank = int(rng.integers(1, max(nprocs, 2)))
            step = lo
            if hi > lo:
                step = int(rng.integers(lo, hi + 1))
            out.append((rank, step))
        return out


def install_chaos_kill(rank: int, nprocs: int):
    """Arm the seeded kill(s) for this process from
    ``$MINIPS_CHAOS_KILL``: returns ``check(clock)`` to call at every
    clock boundary (the trainer's tick does), or None when unarmed or
    every entry is aimed elsewhere. The kill is ``SIGKILL`` to self —
    delivered mid-step, before the clock frame goes out, so the
    corpse's last completed clock is ``step-1`` exactly like a machine
    loss between two ticks."""
    import os
    import signal

    spec = os.environ.get("MINIPS_CHAOS_KILL", "").strip()
    if not spec:
        return None
    kill_steps = {step for victim, step
                  in KillSpec.parse(spec).resolve_all(nprocs)
                  if victim == rank}
    if not kill_steps:
        return None

    def check(clock: int) -> None:
        if clock in kill_steps:
            os.kill(os.getpid(), signal.SIGKILL)
    return check
