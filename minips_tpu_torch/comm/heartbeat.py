"""Heartbeat / failure detection — rebuild of the reference's liveness pings.

The reference's lineage runs periodic heartbeats through the mailbox with a
master that detects dead nodes and triggers restart-from-checkpoint
(SURVEY.md §2 "Heartbeat / failure detection", §5.3). Here heartbeats ride
the control bus; a monitor flags peers whose last beat is older than
``timeout``; the recovery action (reload latest checkpoint and relaunch —
restart semantics are all-or-nothing per JAX job, SURVEY.md §7.4.5) is the
caller's, delivered via the ``on_failure`` callback.

A copy of ``minips_tpu/comm/heartbeat.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from minips_tpu_torch.comm.bus import ControlBus
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc


def _parse_heartbeat_spec() -> dict[str, float]:
    """``$MINIPS_HEARTBEAT`` as a knob dict — empty (or ``"1"``) means
    every caller default, unknown knobs and non-positive values refuse
    loudly (the shared env-spec hygiene)."""
    spec = os.environ.get("MINIPS_HEARTBEAT", "").strip()
    out: dict[str, float] = {}
    if not spec or spec in ("1", "on", "true"):
        return out
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        if "=" not in entry:
            raise ValueError(
                f"MINIPS_HEARTBEAT: expected k=v, got {entry!r}")
        k, _, v = entry.partition("=")
        k = k.strip()
        if k not in ("interval", "timeout", "stall"):
            raise ValueError(f"MINIPS_HEARTBEAT: unknown knob {k!r}")
        try:
            val = float(v)
        except ValueError as e:
            raise ValueError(
                f"MINIPS_HEARTBEAT: bad value for {k}: {v!r}") from e
        if val <= 0:
            raise ValueError(f"MINIPS_HEARTBEAT: {k} must be > 0")
        out[k] = val
    return out


def liveness_knobs(interval: float,
                   timeout: float) -> tuple[float, float]:
    """Resolve the heartbeat liveness knobs against
    ``$MINIPS_HEARTBEAT`` — ``"interval=0.1,timeout=0.8"``, either knob
    optional, empty string (or unset, or ``"1"``) meaning the caller's
    defaults — the same explicit-empty convention as ``MINIPS_BUS`` /
    ``MINIPS_SHM_RING``. Exists so the death drills can run CI-fast
    detection timeouts (and production can run lazier ones) without
    patching every app's hardcoded monitor numbers. The third knob,
    ``stall=`` (observer-stall forgiveness, seconds), is resolved by
    :func:`stall_knob` — it shapes the SWEEP, not the liveness pair."""
    kn = _parse_heartbeat_spec()
    interval = kn.get("interval", interval)
    timeout = kn.get("timeout", timeout)
    if timeout <= interval:
        raise ValueError(
            f"MINIPS_HEARTBEAT: timeout {timeout} must exceed the "
            f"interval {interval} (a beat must be able to land)")
    return interval, timeout


def stall_knob(default: float = 0.0) -> float:
    """The ``stall=`` knob of ``$MINIPS_HEARTBEAT`` (0 = off): the
    observer-stall forgiveness window in seconds — see
    ``HeartbeatMonitor.check``. Off by default: forgiveness trades
    detection latency after a stall for immunity to the oversubscribed-
    host false positive, and that trade is the operator's."""
    return _parse_heartbeat_spec().get("stall", default)


class HeartbeatMonitor:
    def __init__(self, bus: ControlBus, peer_ids: list[int],
                 interval: float = 1.0, timeout: float = 5.0,
                 on_failure: Optional[Callable[[int], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        # env knobs override the caller's numbers (liveness_knobs):
        # drills tune detection latency fleet-wide via the launcher's
        # env inheritance instead of per-app flag plumbing
        interval, timeout = liveness_knobs(interval, timeout)
        self.bus = bus
        self.interval = interval
        self.timeout = timeout
        self.on_failure = on_failure
        # control-plane piggyback (balance/control_plane.py): the lease
        # stamp provider merged into every outgoing beat, and the
        # receive hook peers observe terms through — heartbeats are the
        # one channel guaranteed to keep flowing around a partition's
        # edge, which is exactly when the lease fence matters
        self.payload_extra: Optional[Callable[[], dict]] = None
        self.on_beat_extra: Optional[Callable[[int, dict], None]] = None
        # QUORUM mode (balance/control_plane.SuspicionQuorum, armed by
        # the membership plane): with on_suspect set, a peer past the
        # timeout becomes a SUSPECT — ``on_suspect(rank, True)`` — not
        # a corpse; conviction waits for :meth:`convict` once the
        # fleet's suspicion gossip reaches a majority. A beat from a
        # suspect retracts (``on_suspect(rank, False)``). With the hook
        # unset (standalone monitors, pre-quorum fleets) the timeout
        # convicts solo, exactly the old semantics.
        self.on_suspect: Optional[Callable[[int, bool], None]] = None
        # fail-slow plumbing (obs/slowness.py via balance/membership):
        # fired once per FORGIVEN sweep — a coma observer's slow
        # ballots are retracted alongside its death suspicions (its
        # latency samples are as undateable as its silences)
        self.on_stall_forgiven: Optional[Callable[[], None]] = None
        self.stall = stall_knob()
        if self.stall and self.stall <= self.interval:
            # a stall budget at or below the sweep cadence would make
            # EVERY monitor-thread sweep "forgive" and re-baseline —
            # death detection silently disabled. Refuse as loudly as
            # timeout <= interval above.
            raise ValueError(
                f"MINIPS_HEARTBEAT: stall {self.stall} must exceed the "
                f"interval {self.interval} (every sweep would forgive)")
        self._last_sweep: Optional[float] = None
        # observer-stall forgiveness hits (the stall= window):
        # WITHOUT this counter a forgiven stall is invisible — an
        # operator cannot tell forgiveness from health, and a fleet
        # whose every sweep forgives is a fleet with detection silently
        # degraded. Surfaced via stats() -> wire_record "heartbeat".
        self.stall_forgiven = 0
        self._clock = clock
        now = clock()
        self._last_seen = {p: now for p in peer_ids if p != bus.my_id}
        self._dead: set[int] = set()
        self._suspect: set[int] = set()
        # serializes suspect-state TRANSITIONS together with their
        # on_suspect hook calls (sweep thread suspects, beat thread
        # retracts): firing the hook outside any lock let a sweep's
        # deferred suspected=True land AFTER a beat's retraction,
        # leaving a permanently stale ballot for a live rank. Ordering:
        # _sus_lock is taken FIRST, the main lock (briefly) inside —
        # never the reverse; convict() uses only the main lock, so a
        # hook that reaches convict() cannot deadlock.
        self._sus_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        bus.on("heartbeat", self._on_beat)

    def _on_beat(self, sender: int, payload: dict) -> None:
        tr = _trc.TRACER
        if tr is not None and "t" in payload:
            # the cross-rank clock-alignment sample obs/merge.py feeds
            # on: my receive timestamp (the event ts) paired with the
            # sender's send timestamp, both monotonic — min-filtered
            # NTP-style across both directions, the one-way delays
            # cancel and the per-rank clock offsets fall out
            tr.instant("hb", "hb", {"from": sender,
                                    "t_sent": float(payload["t"])})
        fl = _fl.FLIGHT
        if fl is not None and "t" in payload:
            # the flight recorder keeps only the min-filtered delay per
            # sender (a dict op per beat, no ring traffic): enough for
            # its merge CLI to align post-mortem timelines the same
            # NTP-style way with zero pre-arming
            fl.hb_sample(sender, float(payload["t"]), time.monotonic())
        with self._lock:
            if sender in self._last_seen:
                self._last_seen[sender] = self._clock()
        sus_hook = self.on_suspect
        if sus_hook is not None:
            # the suspect spoke: retract my vote before processing the
            # payload (a returning rank's first beat must not race its
            # own conviction through a stale ballot). Transition + hook
            # under _sus_lock so it serializes against the sweep's
            # suspected=True (see __init__)
            with self._sus_lock:
                with self._lock:
                    retracted = sender in self._suspect
                    self._suspect.discard(sender)
                if retracted:
                    sus_hook(sender, False)
        hook = self.on_beat_extra
        if hook is not None:
            hook(sender, payload)

    def check(self) -> set[int]:
        """Sweep for newly-dead peers; fires on_failure once per peer.

        With ``stall=`` armed (MINIPS_HEARTBEAT): a sweep arriving more
        than ``stall`` seconds after the previous one means THIS
        process was descheduled — on an oversubscribed host (the
        1-core CI box running 4-rank failover drills) a whole idle
        process can starve for seconds while its peers' beats sit
        undrained in the receive queue. An observer that was in a coma
        cannot date anyone else's silence, so it re-baselines every
        live peer instead of convicting them (a genuinely dead peer is
        re-detected one timeout after we wake — the honest earliest
        date). Off by default: existing fleets keep exact semantics."""
        newly_dead = []
        candidates = []
        forgave = False
        sus_hook = self.on_suspect
        with self._lock:
            now = self._clock()
            last, self._last_sweep = self._last_sweep, now
            if self.stall > 0 and last is not None \
                    and now - last > self.stall:
                for p in self._last_seen:
                    if p not in self._dead:
                        self._last_seen[p] = now
                forgave = True
                self.stall_forgiven += 1
                fl = _fl.FLIGHT
                if fl is not None:
                    fl.ev("hb_stall_forgiven",
                          {"gap_s": round(now - last, 3),
                           "stall_s": self.stall})
            else:
                for p, seen in self._last_seen.items():
                    if p in self._dead or now - seen <= self.timeout:
                        continue
                    if sus_hook is not None:
                        # quorum mode: silence makes a SUSPECT, not a
                        # corpse — the verdict needs corroboration.
                        # Transition deferred below: the add and its
                        # hook must be one atom under _sus_lock, or a
                        # concurrent beat's retraction can be
                        # overwritten by our deferred suspected=True
                        candidates.append(p)
                    else:
                        self._dead.add(p)
                        newly_dead.append(p)
        if forgave and sus_hook is not None:
            # a coma observer's standing suspicions are as undateable
            # as its convictions would have been: retract them along
            # with the re-baseline
            with self._sus_lock:
                with self._lock:
                    forgiven = sorted(self._suspect)
                    self._suspect.clear()
                for p in forgiven:
                    sus_hook(p, False)
        if forgave and self.on_stall_forgiven is not None:
            # ...and so are its fail-slow ballots (obs/slowness.py):
            # the same coma inflated every latency sample it took
            self.on_stall_forgiven()
        for p in candidates:
            with self._sus_lock:
                with self._lock:
                    fresh = self._clock()
                    seen = self._last_seen.get(p, fresh)
                    # re-verify under the transition lock: a beat that
                    # landed since the sweep snapshot retracts the case
                    begin = (p not in self._dead
                             and p not in self._suspect
                             and fresh - seen > self.timeout)
                    if begin:
                        self._suspect.add(p)
                if begin:
                    sus_hook(p, True)
        for p in newly_dead:
            if self.on_failure is not None:
                self.on_failure(p)
        with self._lock:
            return set(self._dead)

    def convict(self, r: int) -> None:
        """Quorum-mode conviction (balance/membership.py, once the
        fleet's suspicion gossip reached a majority): promote the rank
        to DEAD and fire ``on_failure`` exactly once — the same verdict
        path a solo timeout takes when quorum is off."""
        with self._lock:
            if r in self._dead:
                return
            self._dead.add(r)
            self._suspect.discard(r)
        if self.on_failure is not None:
            self.on_failure(r)

    @property
    def suspects(self) -> set[int]:
        """Peers past the timeout awaiting corroboration (quorum mode;
        always empty when on_suspect is unset)."""
        with self._lock:
            return set(self._suspect)

    def start(self) -> "HeartbeatMonitor":
        def loop() -> None:
            while not self._stop.wait(self.interval):
                payload = {"t": self._clock()}
                extra = self.payload_extra
                if extra is not None:
                    payload.update(extra())
                self.bus.publish("heartbeat", payload)
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    @property
    def dead(self) -> set[int]:
        with self._lock:
            return set(self._dead)

    def stats(self) -> dict:
        """Liveness-layer counters for the done line (``wire_record``
        "heartbeat" block): the stall-forgiveness window's arming and
        hits, plus the dead set size. A forgiven stall must be VISIBLE
        — it is detection latency the operator traded for."""
        with self._lock:
            return {"interval_s": self.interval,
                    "timeout_s": self.timeout,
                    "stall_s": self.stall or None,
                    "stall_forgiven": self.stall_forgiven,
                    "dead": sorted(self._dead),
                    "suspects": sorted(self._suspect)}

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
