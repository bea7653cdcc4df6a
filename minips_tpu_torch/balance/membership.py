"""Elastic membership — server ranks join and leave a LIVE job.

The reference MiniPs lineage answers a dead server with detect-and-
restart: the whole gang dies and resumes from the last checkpoint
(PARITY.md failure-model rows). This module is the production
alternative the roadmap names (item 3): reliable delivery plus
the epoch-fenced key-range migration are 80% of online resharding —
the membership state machine here is the remaining 20%, composing them
into a training SERVICE that survives preemptible fleets. Loss of a
rank degrades to latency and reduced capacity, never to a poisoned run.

Armed by ``MINIPS_ELASTIC`` (off by default — armed-but-idle is pinned
bitwise-equal to off by the lockstep drill). The world is launched at a
fixed ADDRESS SPACE of ``num_processes`` bus slots; membership is which
slots are LIVE. Three transitions, all riding the existing machinery:

**Join.** A rank configured standby (``MINIPS_ELASTIC="live=0-2"`` in a
4-slot world makes rank 3 a standby) connects and handshakes like
everyone, but is EXCLUDED from clock gossip (its idle clock must not
gate the fleet) and trains nothing. The coordinator's bootstrap plan —
a normal epoch-fenced migration at step ~0 — moves the standby's home
blocks onto live ranks (the standby ships its freshly-initialized
state via ``rbS``, so seeded init survives). When the standby announces
(``mbJ`` — at its configured join step, or whenever its operator says),
the coordinator admits it at a routing-epoch boundary: ``mbA`` carries
the catch-up clock, the admit plan returns the joiner's home blocks to
it (rows + optimizer state hand off under the existing rbS/rbA/rbF
fence — the SSP bound holds mid-join exactly as it does mid-migration),
the joiner publishes the catch-up clock and THEN its live announce
(``mbL``, same FIFO link — so every rank re-includes it in gossip only
after a current clock is stored; including a clock-0 ghost would wedge
every gate), and trains from there.

**Leave (graceful).** A rank receiving a preemption signal (SIGTERM, a
``mbDr`` control frame, or the drill's ``--drain-at``) stops training,
hard-drains its in-flight pushes, publishes the RETIRED clock sentinel
(gates never wait on it again), and asks the coordinator to plan it out
(``mbQ``, refreshed with its settle state — the coordinator plans only
over a settled leaver, the one real precondition of the fence
protocol). The leave plan is a normal migration: the leaver SHIPS its
owned blocks to survivors and releases fences only after every live
rank's adoption ack — per-link FIFO then guarantees no frame addressed
to the leaver is still in flight when it announces ``mbG`` and exits
clean: rc 0, zero restored state, zero poisons.

**Death (ungraceful).** When the ``HeartbeatMonitor`` declares a rank
dead, every rank immediately excludes it from gossip (the SSP gate
recomputes over the shrunken membership — a corpse cannot hold the
clock hostage) and unjams waits aimed at it (push windows drop their
unacked seqs, counted). The coordinator picks the newest checkpoint
step every rank holds under the current partition
(``ckpt/elastic.find_live_step``) and broadcasts a DEATH plan: the
corpse's owned blocks re-home onto survivors with the plan's ``dead``
extras, and each new owner installs ``ckpt/elastic.load_block_state``
— which reads THROUGH the save-time rebalance overlay — instead of
waiting for an rbS no corpse will send. Restored blocks serve
un-fenced: no stale push can be forwarded from a corpse, so the fence
would protect nothing; the recovery semantics are exactly "that rank's
ranges roll back to the last checkpoint". Workers re-route refused or
orphaned legs via the existing ``psE``/resend machinery; replicas on
the dead rank demote by lease expiry (serve/plane.py). A DEAD COORDINATOR is no
longer the SPOF it was: the coordinator role is a lease
(balance/control_plane.py) — on the holder's death verdict every rank
advances the term and the lowest-ranked live rank succeeds
deterministically, re-targets the in-flight ``mbJ``/``mbQ`` retry
loops (they address ``self.coord``, which succession updates), and
issues the old holder's death plan itself; a stale ex-coordinator
returning from a partition is fenced by term on every coordinator
broadcast it attempts. A death the plane CANNOT own — no checkpoint
anywhere, no live rank left to take the lease, a verdict that never
arrives within the grace window — stays exactly as loud as before:
``PeerFailureError``, exit 42, the gang-restart drill.

Spec grammar (``$MINIPS_ELASTIC``)::

    1                        # armed, all ranks live (idle plane)
    live=0-2                 # ranks 0..2 live, the rest standby
    live=0+2,grace=20        # '+'-separated list; death-verdict grace

Knob table: docs/fault_tolerance.md "The membership ladder".

A copy of ``minips_tpu/balance/membership.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from minips_tpu_torch.balance.control_plane import (CoordinatorLease,
                                              SuspicionQuorum,
                                              expand_to_domains)
from minips_tpu_torch.consistency.gate import (FencedOutError,
                                         PeerFailureError, publish_clock)
from minips_tpu_torch.obs import flight as _fl
from minips_tpu_torch.obs import tracer as _trc

__all__ = ["MembershipConfig", "Membership", "plan_evacuation",
           "plan_admission"]


def _parse_ranks(val: str) -> set[int]:
    out: set[int] = set()
    for part in filter(None, (p.strip() for p in val.split("+"))):
        lo, dash, hi = part.partition("-")
        if dash:
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(lo))
    return out


class MembershipConfig:
    """Parsed ``MINIPS_ELASTIC`` knobs (``k=v`` comma list; the bare
    string ``"1"`` arms the plane with every rank live)."""

    def __init__(self, *, live: Optional[set[int]] = None,
                 grace: float = 15.0):
        if grace <= 0:
            raise ValueError("grace must be > 0 seconds")
        self.live = None if live is None else {int(r) for r in live}
        self.grace = float(grace)  # death-verdict wait before poisoning

    @classmethod
    def parse(cls, spec: str) -> "MembershipConfig":
        spec = (spec or "").strip()
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_ELASTIC: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k == "live":
                kw["live"] = _parse_ranks(v)
            elif k == "grace":
                try:
                    kw["grace"] = float(v)
                except ValueError as e:
                    raise ValueError(
                        f"MINIPS_ELASTIC: bad value for grace: "
                        f"{v!r}") from e
            else:
                raise ValueError(
                    f"MINIPS_ELASTIC: unknown knob {k!r}")
        return cls(**kw)


def plan_evacuation(router, victims: set[int],
                    targets: list[int]) -> dict[int, int]:
    """New FULL overlay with every block currently owned by a rank in
    ``victims`` re-homed round-robin onto ``targets`` — the leave /
    death / bootstrap planner (pure, deterministic: every rank handed
    the same router state computes the same table). A block whose
    round-robin slot IS its home rank leaves the overlay (home blocks
    must be absent, BlockRouter.apply's invariant)."""
    if not targets:
        raise ValueError("plan_evacuation: no live targets left")
    _ep, ov = router.table()
    owner = router.owner_of_blocks()
    new_ov = {int(b): int(o) for b, o in ov.items()
              if int(o) not in victims}
    vb = sorted(int(b) for v in victims
                for b in np.nonzero(owner == v)[0])
    for i, b in enumerate(vb):
        dst = int(targets[i % len(targets)])
        if dst == router.home_of(b):
            new_ov.pop(b, None)
        else:
            new_ov[b] = dst
    return new_ov


def plan_admission(router, joiner: int, *,
                   reports: Optional[dict] = None,
                   live: Optional[set] = None,
                   threshold: float = 1.0,
                   max_blocks: int = 8) -> dict[int, int]:
    """New FULL overlay admitting ``joiner``: its home blocks return
    home (their interim owners ship state under the normal fence);
    everything else keeps its current assignment.

    HEAT-AWARE PLACEMENT (ROADMAP item 3's remaining headroom, 'one
    planner call away'): with the coordinator's per-rank heat
    ``reports`` (balance/rebalancer.py ``rbH`` payloads, ``live`` =
    the pre-join live set they cover), the admission plan additionally
    runs the rebalancer's bin-packer (:func:`plan_assignment`) over the
    POST-ADMISSION load picture — the joiner starts at the heat of its
    returning home blocks, interim owners are debited the same — so a
    rank joining a skewed fleet immediately absorbs hot blocks instead
    of idling on its (typically cold, freshly-bootstrapped) home range
    until the ordinary rebalance loop notices. ``threshold`` defaults
    to 1.0 here (not the steady-state hysteresis): an empty joiner IS
    the imbalance, and admission is already a migration — extra moves
    ride the same fence for free. Every rank in ``live`` must have
    reported; otherwise (or with no reports) the plan degrades to
    home-blocks-only, exactly the pre-heat behavior."""
    _ep, ov = router.table()
    new_ov = {int(b): int(o) for b, o in ov.items()
              if router.home_of(int(b)) != joiner and int(o) != joiner}
    if not reports or live is None or not live <= set(reports):
        return new_ov
    home = router.home_of
    joiner_home = {b for b in range(router.num_blocks)
                   if home(b) == joiner}
    ranks = sorted(set(live) | {joiner})
    idx = {r: i for i, r in enumerate(ranks)}
    loads = np.zeros(len(ranks), np.float64)
    candidates: dict[int, tuple[int, float]] = {}
    for r in sorted(set(live)):
        rep = reports[r]
        loads[idx[r]] = float(rep.get("total", 0.0))
        for b, h in zip(rep.get("blocks", ()), rep.get("heat", ())):
            b, h = int(b), float(h)
            if b in joiner_home:
                # this block is returning to the joiner under the
                # admission overlay: credit the joiner, debit the
                # interim owner — the planner sees the POST-join world
                loads[idx[joiner]] += h
                loads[idx[r]] -= h
                continue
            candidates[b] = (idx[r], h)
    from minips_tpu_torch.balance.rebalancer import plan_assignment

    for b, _src, dst in plan_assignment(loads, candidates, threshold,
                                        max_blocks):
        if ranks[dst] == home(b):
            new_ov.pop(b, None)
        else:
            new_ov[b] = ranks[dst]
    return new_ov


class Membership:
    """The membership state machine riding a ShardedPSTrainer — module
    docstring for the protocol. One instance per process; rank 0 holds
    the coordinator LEASE at launch (balance/control_plane.py — on its
    death the lowest-ranked live rank succeeds deterministically)."""

    JOIN_KIND = "mbJ"     # standby -> coordinator: admit me
    ADMIT_KIND = "mbA"    # coordinator broadcast: rank + catch-up clock
    LIVE_KIND = "mbL"     # joiner broadcast: include me (clock published)
    LEAVE_KIND = "mbQ"    # leaver -> coordinator: plan me out (+settle)
    GONE_KIND = "mbG"     # leaver broadcast: fences done, exiting clean
    DEATH_KIND = "mbD"    # coordinator broadcast: verdict (rstep | -1)
    DRAIN_KIND = "mbDr"   # operator -> rank: please drain (the --drain
    #                       control frame; SIGTERM is the other trigger)
    END_KIND = "mbEnd"    # coordinator broadcast at finalize: no more
    #                       admissions — un-admitted standbys exit clean
    #                       instead of timing out against a gone fleet
    HANDOVER_KIND = "mbH"  # holder broadcast: lease transferred (new
    #                        term + holder + the coordinator state the
    #                        successor installs — heat reports, queues,
    #                        autoscaler hysteresis)

    def __init__(self, trainer, cfg: MembershipConfig):
        self.trainer = trainer
        self.cfg = cfg
        self.bus = trainer.bus
        self.rank = int(trainer.bus.my_id)
        self.n = int(trainer.num_processes)
        self.coord = 0
        self.rb = trainer.rebalancer
        if self.rb is None:
            raise RuntimeError(
                "elastic membership needs the rebalancer machinery "
                "(the trainer arms it when MINIPS_ELASTIC is set)")
        all_ranks = set(range(self.n))
        live = all_ranks if cfg.live is None else set(cfg.live) & all_ranks
        if self.coord not in live:
            raise ValueError(
                "MINIPS_ELASTIC: rank 0 (the launch-time coordinator "
                "lease holder) must be in the initial live set")
        # the coordinator lease (control_plane.py): rank 0 holds term 0;
        # a holder death advances the term to the lowest live rank at
        # every rank identically — no election frames
        self.lease = CoordinatorLease(self.coord)
        # autoscaler plumbing (balance/autoscaler.py): with hold_joins
        # armed, announced standbys queue until a grant_join() credit —
        # scale-up becomes a load decision instead of an auto-admit
        self.hold_joins = False
        self._join_credits = 0
        self._lock = threading.Lock()
        self.live: set[int] = set(live)
        self.standby: set[int] = all_ranks - live
        self.dead: set[int] = set()
        self.left: set[int] = set()
        self._unrecoverable: set[int] = set()
        self._death_t: dict[int, float] = {}   # rank -> detection time
        self._verdicts: dict[int, int] = {}    # rank -> rstep (-1 bad)
        self._pending_deaths: list[int] = []   # coordinator queue
        self._pending_joins: list[int] = []    # coordinator queue
        self._leave_reqs: dict[int, dict] = {}  # rank -> latest mbQ
        self._bootstrapped = not self.standby
        self._admit_clk: Optional[int] = None  # my mbA, standby side
        self._drain = False
        self._last_join_tx = 0.0
        self._ckpt_dir: Optional[str] = None
        self.counters = {"joins": 0, "leaves": 0, "deaths": 0,
                         "plans": 0}
        # standbys are OUT of every rank's gossip view from the first
        # frame (their clocks sit at 0 and must gate nobody — the
        # joiner re-enters via include() after its catch-up publish)
        for s in self.standby:
            trainer.gossip.exclude(s)
        # death detection hook: the monitor's sweep thread fires this
        # the moment a peer's silence crosses the timeout
        # split-brain hardening: death verdicts are
        # CORROBORATED — the monitor's timeout makes a SUSPECT, the
        # suspicion gossips on the heartbeat wire next to the lease
        # stamp, and conviction needs a majority of the live view
        # (control_plane.SuspicionQuorum). A minority island cannot
        # convict the majority, so it cannot mint a term or issue plans.
        self.quorum = SuspicionQuorum(self.rank)
        self._quorum_claimed: set[int] = set()  # verdicts this rank
        #                                         recorded (dedup across
        #                                         sweep + beat threads)
        self._convicted_term: Optional[int] = None  # fleet declared ME dead
        # fail-slow quorum (obs/slowness.py, bound via bind_slowness):
        # a SECOND SuspicionQuorum over the same heartbeat gossip wire
        # — slow ballots ride as ``slw`` next to the death ballot's
        # ``sus``, and a SLOW VERDICT needs the same strict majority.
        # Unlike death, a slow verdict is NOT sticky: it stands only
        # while the quorum stands (slow_view recomputes), so a
        # recovered rank's demotion bias lifts by itself.
        self.slow_quorum = SuspicionQuorum(self.rank)
        self._slow_lock = threading.Lock()
        self._slow_verdicts: set[int] = set()
        self._slow_since: dict[int, int] = {}  # rank -> holder ticks
        self._slow_drained: set[int] = set()   # escalations issued
        self._slowness = None                  # obs.slowness monitor
        self._slow_cfg = None                  # its SlownessConfig
        self._domain_group = 1                 # hybrid-plane domains
        self.counters["slow_verdicts"] = 0
        self.counters["slow_drains"] = 0
        if trainer.monitor is not None:
            trainer.monitor.on_failure = self._on_peer_dead
            trainer.monitor.on_suspect = self._on_suspect
            # lease stamps + my suspicion ballot ride every heartbeat:
            # peers max-merge the term, so a partitioned ex-coordinator
            # learns it lost the lease from the FIRST beat it hears on
            # return (the self fence — control_plane.py module
            # docstring), and ballots reach exactly the ranks a
            # partition still lets us reach
            trainer.monitor.payload_extra = self._beat_payload
            trainer.monitor.on_beat_extra = self._on_lease_beat
        bus = self.bus
        bus.on(self.JOIN_KIND, self._on_join_req)
        bus.on(self.ADMIT_KIND, self._on_admit)
        bus.on(self.LIVE_KIND, self._on_live)
        bus.on(self.LEAVE_KIND, self._on_leave_req)
        bus.on(self.GONE_KIND, self._on_gone)
        bus.on(self.DEATH_KIND, self._on_death_verdict)
        bus.on(self.DRAIN_KIND, self._on_drain)
        self._fleet_done = False
        bus.on(self.END_KIND, self._on_end)
        bus.on(self.HANDOVER_KIND, self._on_handover)

    # ------------------------------------------------------------- plumbing
    def bind_checkpoint(self, checkpoint_dir: Optional[str]) -> None:
        """Point the death path at the shared elastic checkpoint dir
        (the app knows it; the trainer doesn't). Without one, death
        stays the reference's gang-restart failure."""
        self._ckpt_dir = checkpoint_dir or None

    @property
    def i_am_standby(self) -> bool:
        with self._lock:
            return self.rank in self.standby

    def live_view(self) -> set[int]:
        """Snapshot of the live set (the autoscaler's fleet picture)."""
        with self._lock:
            return set(self.live)

    def pending_joins(self) -> int:
        """Announced standbys queued at this (coordinator) rank."""
        with self._lock:
            return len(self._pending_joins)

    def grant_join(self) -> None:
        """Autoscaler hook: release ONE held standby admission — the
        next ``_coord_step`` boundary pops the queue. A no-op credit
        (nothing queued) is consumed by the next announce."""
        with self._lock:
            self._join_credits += 1

    # ---------------------------------------------------------- the lease
    def _retarget(self, succ: int) -> None:
        """Point every coordinator-addressed loop at the new lease
        holder: ``self.coord`` (the mbJ/mbQ retry loops and the
        coordinator-only guards read it live) and the rebalancer's rbH
        destination. Idempotent — verdict, beat-stamp, and plan-stamp
        observation may all land it."""
        self.coord = int(succ)
        self.rb.coord = int(succ)
        tr = _trc.TRACER
        if tr is not None:
            term, holder = self.lease.current()
            tr.instant("membership", "mb_lease",
                       {"term": term, "holder": holder})

    def _beat_payload(self) -> dict:
        """Every outgoing heartbeat: lease stamp + my suspicion ballot
        (empty list = explicit retraction — a voter that calmed down
        must clear its stale ballot at every receiver). With the
        fail-slow plane bound, my SLOW ballot rides next to it as
        ``slw`` — same channel, same retraction semantics; unbound
        fleets ship byte-identical beats to pre-slow ones."""
        out = {**self.lease.stamp(), "sus": self.quorum.my_suspects()}
        if self._slowness is not None:
            out["slw"] = self.slow_quorum.my_suspects()
        return out

    def _on_lease_beat(self, sender: int, payload: dict) -> None:
        """Heartbeat receive hook (monitor thread): max-merge the lease
        stamp. Learning a newer term here is the partition-return self
        fence — an ex-holder stops planning the moment it hears the
        fleet moved on, and every receiver re-targets without waiting
        for its own death verdict. Then bank the sender's suspicion
        ballot and re-check quorum — a verdict completes the moment
        the corroborating vote lands, whichever rank's beat carried
        it."""
        if self.lease.observe(payload):
            self._retarget(self.lease.holder)
        sus = payload.get("sus")
        if sus is not None:
            self.quorum.vote(sender, sus)
            self._check_quorum()
        slw = payload.get("slw")
        if slw is not None:
            self.slow_quorum.vote(sender, slw)
            self._update_slow_verdicts()

    def _on_suspect(self, r: int, suspected: bool) -> None:
        """Monitor sweep hook: MY suspicion of ``r`` began/retracted.
        The ballot updates locally and rides the next beat; quorum is
        re-checked immediately (a 2-rank fleet's solo quorum, or the
        case where peers' votes arrived before mine)."""
        mine = self.quorum.mark_local(r, suspected)
        # suspicion into the black box: the post-mortem sequence reads
        # suspicion -> quorum verdict -> term advance -> death plan
        _fl.record("hb_suspect" if suspected else "hb_unsuspect",
                   {"rank": int(r), "ballot": mine})
        if suspected:
            self._check_quorum()

    def _check_quorum(self) -> None:
        """Convict every suspect a majority of the live view now
        corroborates. Runs on the monitor thread (my sweep) and the
        bus receive thread (a peer's beat) — conviction itself is
        idempotent (``monitor.convict`` fires on_failure once, and
        ``_on_peer_dead`` re-checks under its lock)."""
        mon = self.trainer.monitor
        if mon is None:
            return
        with self._lock:
            live = set(self.live)
            already = self.dead | self.left | self._quorum_claimed
        for r in self.quorum.convictable(live):
            if r in already:
                continue
            with self._lock:
                # claim the verdict: the sweep thread (my vote) and
                # the beat thread (a peer's vote) can both reach
                # convictable at the same instant — exactly one may
                # record the quorum_verdict and convict
                if r in self._quorum_claimed:
                    continue
                self._quorum_claimed.add(r)
            if r == self.rank:
                # peers' gossiped ballots corroborate MY death (the
                # asymmetric half-partition: my outbound is cut, my
                # inbound flows) — I must not convict myself through
                # the PEER-death path (self-exclusion from my own
                # gossip, succession against myself). The majority
                # will convict on its side and its mbD reaches me on
                # the working inbound; the fenced-out path owns it.
                continue
            voters = self.quorum.voters_for(r, live)
            # the QUORUM VERDICT with its why — who corroborated, over
            # which live view — before the conviction cascades into
            # hb_death/term_advance/death_plan
            _fl.record("quorum_verdict",
                       {"rank": int(r), "voters": voters,
                        "live": sorted(live)})
            self.quorum.verdicts += 1
            self.quorum.drop_voter(r)
            mon.convict(r)

    # ---------------------------------------------------- fail-slow quorum
    def bind_slowness(self, sm, cfg) -> None:
        """Wire the fail-slow detector (obs/slowness.py) into the
        gossip/quorum plane: local suspicion transitions update my
        ``slw`` ballot (next beat carries it), and heartbeat STALL
        forgiveness retracts slow ballots exactly like death ballots —
        a coma observer's latency samples are as undateable as its
        timeout verdicts (the false-positive drill pins both)."""
        self._slowness = sm
        self._slow_cfg = cfg
        sm.on_slow = self._on_slow_suspect
        mon = self.trainer.monitor
        if mon is not None and hasattr(mon, "on_stall_forgiven"):
            mon.on_stall_forgiven = sm.retract_all

    def bind_failure_domains(self, group: int) -> None:
        """Arm whole-host failure domains (the hybrid data plane,
        ``MINIPS_HIER agg=mesh``): slow verdicts expand to the
        convicted rank's entire contiguous host group via
        ``control_plane.expand_to_domains`` — a mesh host's ranks
        share one reduce group, so demoting one member without its
        peers would leave the planner shedding load onto ranks whose
        collectives still stall behind the sick one."""
        self._domain_group = max(1, int(group))

    def _on_slow_suspect(self, r: int, suspected: bool) -> None:
        """SlownessMonitor transition (push-driving thread, its roll):
        MY slow ballot changed — gossip rides the next beat; the
        quorum re-checks immediately (a peer's corroborating vote may
        already be banked)."""
        mine = self.slow_quorum.mark_local(r, suspected)
        _fl.record("slow_suspect" if suspected else "slow_unsuspect",
                   {"rank": int(r), "ballot": mine})
        self._update_slow_verdicts()

    def _update_slow_verdicts(self) -> None:
        """Recompute the quorum's CURRENT slow-verdict set — strict
        majority of the live view, exactly :func:`quorum_needed` (a
        single complainer never convicts; a minority island cannot
        demote the majority). Not sticky: a verdict whose
        corroboration fell away CLEARS, and the demotion bias lifts
        with it. Runs on the monitor/beat threads and the roll thread;
        the transition record is deduped under ``_slow_lock``."""
        with self._lock:
            live = set(self.live)
            gone = self.dead | self.left
        cur = {r for r in self.slow_quorum.convictable(live)
               if r not in gone}
        dom_added: set[int] = set()
        if cur and self._domain_group > 1:
            # hybrid-plane failure domains: a verdict against one mesh
            # member implicates its whole host group (live peers only
            # — the dead are the death quorum's problem). Not sticky
            # either: the expansion recomputes from the base set, so a
            # cleared member verdict lifts the whole domain with it
            full = expand_to_domains(cur, self._domain_group, self.n)
            dom_added = {r for r in full
                         if r in live and r not in gone} - cur
            cur |= dom_added
        with self._slow_lock:
            new = cur - self._slow_verdicts
            cleared = self._slow_verdicts - cur
            self._slow_verdicts = cur
            for r in new:
                self.counters["slow_verdicts"] += 1
                self._slow_since.setdefault(r, 0)
            for r in cleared:
                self._slow_since.pop(r, None)
        for r in new:
            if r in dom_added:
                _fl.record("slow_domain_verdict",
                           {"rank": int(r),
                            "group": self._domain_group,
                            "live": sorted(live)})
            else:
                _fl.record("slow_verdict",
                           {"rank": int(r),
                            "voters": self.slow_quorum.voters_for(
                                r, live),
                            "live": sorted(live)})
        for r in cleared:
            _fl.record("slow_cleared", {"rank": int(r)})

    def slow_view(self) -> set[int]:
        """The current quorum-corroborated slow set — read by the
        hedge plane (immediate hedging), the rebalancer's planner
        (demotion bias), and the autoscaler (shed pressure)."""
        with self._slow_lock:
            return set(self._slow_verdicts)

    def slow_demote_bias(self) -> float:
        """The planner's load multiplier for a slow-verdict rank
        (``MINIPS_SLOW demote=``; 0/1 = no bias)."""
        cfg = self._slow_cfg
        return float(cfg.demote) if cfg is not None else 0.0

    def _slow_escalate(self) -> None:
        """The second threshold — drain-not-convict: on the LEASE
        HOLDER, a rank whose slow verdict has stood ``drain_after``
        consecutive boundaries is drained through the leave path
        (graceful: blocks ship to survivors under the fence, rc 0 —
        and if the sick rank IS the holder, ``leave()`` hands the
        lease over first). Never shrinks the fleet below 2: with one
        rank left there is nobody to absorb the blocks — the verdict
        then stays a demotion bias only."""
        cfg = self._slow_cfg
        if cfg is None or cfg.drain_after <= 0:
            return
        with self._slow_lock:
            standing = sorted(self._slow_verdicts)
            due = []
            for r in standing:
                if r in self._slow_drained:
                    continue
                self._slow_since[r] = self._slow_since.get(r, 0) + 1
                if self._slow_since[r] >= cfg.drain_after:
                    due.append(r)
        if not due:
            return
        with self._lock:
            live = set(self.live)
        for r in due:
            if r not in live or len(live) < 3:
                # len < 3: draining from a 2-fleet leaves a 1-fleet —
                # and a 2-fleet slow verdict cannot exist anyway (one
                # complainer, quorum 2); belt and braces
                continue
            with self._slow_lock:
                if r in self._slow_drained:
                    continue
                self._slow_drained.add(r)
            self.counters["slow_drains"] += 1
            _fl.checkpoint("slow_drain",
                           {"rank": int(r),
                            "since_ticks": self._slow_since.get(r),
                            "holder": self.rank})
            if r == self.rank:
                # the sick rank is the holder itself: leave() hands the
                # lease (mbH) before draining — lease-handover-aware by
                # construction
                self.begin_drain()
            else:
                self.bus.send(r, self.DRAIN_KIND,
                              {**self.lease.stamp()})

    def slow_stats(self) -> dict:
        with self._slow_lock:
            return {"slow_verdict_ranks": sorted(self._slow_verdicts),
                    "slow_drained": sorted(self._slow_drained),
                    "slow_ballots": self.slow_quorum.stats()["ballots"],
                    "demote_bias": self.slow_demote_bias() or None}

    def fence_frame(self, payload: dict) -> bool:
        """THE receive fence, in one place for every coordinator-
        originated frame (rbP plans, mbA admits, mbD verdicts, mbEnd,
        mbDr): max-merge the stamp's term (re-targeting on a newer
        one), then admit/drop by term. False = stale ex-coordinator
        frame, counted at the lease — the handler must return without
        acting."""
        if self.lease.observe(payload):
            self._retarget(self.lease.holder)
        return self.lease.admit(payload)

    @property
    def busy(self) -> bool:
        """A membership transition is queued or mid-flight — the heat
        planner yields (one planner stream at a time)."""
        with self._lock:
            return bool(self._pending_deaths or self._pending_joins
                        or self._leave_reqs or not self._bootstrapped)

    def membership_epoch(self) -> int:
        """Max routing epoch across tables — the 'versioned membership
        epoch' observability stamp (every transition bumps it)."""
        return max((t.router.epoch
                    for t in self.trainer.tables.values()), default=0)

    def stats(self) -> dict:
        with self._lock:
            out = {"live": sorted(self.live),
                   "standby": sorted(self.standby),
                   "dead": sorted(self.dead),
                   "left": sorted(self.left),
                   "coord": self.coord,
                   "held_joins": len(self._pending_joins)
                   if self.hold_joins else 0,
                   **self.counters}
        out["lease"] = self.lease.stats()
        out["quorum"] = self.quorum.stats()
        out["fenced_out"] = self._convicted_term is not None
        # the successor's ADDRESS derives from the membership table, not
        # the spawn-time env: the bus is a full mesh wired at launch, so
        # succession is a rank-id change (launch.bus_endpoint_of) — the
        # endpoint here is observability, never renegotiation
        from minips_tpu_torch.launch import bus_endpoint_of

        out["coord_endpoint"] = bus_endpoint_of(out["coord"])
        out["epoch"] = self.membership_epoch()
        out["blocks_restored"] = sum(
            t.rb_stats["blocks_restored"]
            for t in self.trainer.tables.values())
        out["pushes_lost_to_dead"] = sum(
            t.rb_stats["pushes_lost_to_dead"]
            for t in self.trainer.tables.values())
        return out

    def _live_targets(self, exclude: set[int] = frozenset()) -> list:
        with self._lock:
            return sorted(self.live - set(exclude))

    # --------------------------------------------------------------- death
    def _on_peer_dead(self, r: int) -> None:
        """Monitor verdict (heartbeat thread): exclude NOW — the gate
        must recompute over the shrunken membership immediately — and
        unjam every wait aimed at the corpse. The plan (or the
        unrecoverable verdict) follows from the coordinator."""
        # the free-vs-planned verdict keys on OWNERSHIP, not membership
        # category: a standby normally owns nothing (bootstrap moved
        # its home range away) — but a PRE-bootstrap standby or a
        # mid-admission joiner does own blocks, and skipping its death
        # plan would strand those ranges on a corpse forever
        owns = any((t.router.owner_of_blocks() == r).any()
                   for t in self.trainer.tables.values())
        free = False
        succeeded = None
        with self._lock:
            if r in self.dead or r in self.left:
                return
            self.dead.add(r)
            self.live.discard(r)
            self.standby.discard(r)
            self._death_t[r] = time.monotonic()
            self.counters["deaths"] += 1
            self._pending_joins = [j for j in self._pending_joins
                                   if j != r]
            # a leaver that died mid-drain must not leave a stale
            # request pinning `busy` (and pausing the heat planner)
            # for the rest of the run
            self._leave_reqs.pop(r, None)
            if r == self.coord:
                # LEASE SUCCESSION (control_plane.py): the verdict plus
                # the membership table give every rank the same answer —
                # term += 1, holder = lowest live rank. The successor
                # plans the old holder's death itself below; only a
                # fleet with NOBODY left to take the lease stays the
                # reference's gang-restart case.
                succ = self.lease.succeed(r, self.live)
                if succ is None:
                    self._unrecoverable.add(r)
                else:
                    self.coord = succ
                    self.rb.coord = succ
                    succeeded = succ
            if r not in self._unrecoverable:
                if not owns:
                    # nothing routed to it, gated nobody: death is free
                    self._verdicts[r] = 0
                    free = True
                elif self.rank == self.coord:
                    self._pending_deaths.append(r)
        with self._lock:
            live_snap = sorted(self.live)
        # the heartbeat DEATH VERDICT is a poison-class event whether or
        # not the plane can own it: record + dump FIRST so every
        # survivor's box opens with the verdict — the post-mortem
        # sequence reads verdict → term advance → death plan
        _fl.poison("hb_death", {"rank": int(r), "owns": bool(owns),
                                "live": live_snap})
        # a corpse's standing suspicion ballot is void — it must not
        # keep corroborating verdicts against ranks it can no longer
        # see. MY vote against the corpse deliberately PERSISTS: every
        # rank reaches its own quorum verdict independently, and the
        # first convictor retracting would starve a slower survivor of
        # the corroborating vote it still needs (its next beat would
        # gossip "sus": [] and RETRACT the vote at every receiver —
        # reproduced: the seeded-kill drills wedged with one survivor
        # convicted and the other forever one vote short). A
        # convicted-dead rank's lingering ballot entry is the settled
        # evidence, not noise.
        self.quorum.drop_voter(r)
        # the corpse's SLOW ballot is void outright (both directions:
        # its votes and any verdict against it — death outranks slow)
        self.slow_quorum.drop_voter(r)
        if self._slowness is not None:
            self._slowness.exclude(r)
        self._update_slow_verdicts()
        if succeeded is not None:
            term, holder = self.lease.current()
            tr = _trc.TRACER
            if tr is not None:
                tr.instant("membership", "mb_lease",
                           {"term": term, "holder": holder})
            # LEASE DECISION into the black box, with its WHY — the
            # ballot inputs every rank advanced on (verdict + live set)
            # — then dump: a term advance is exactly the decision a
            # post-mortem reconstructs ("who took over, from what")
            _fl.poison("term_advance",
                       {"term": term, "holder": holder,
                        "dead": int(r), "live": live_snap})
        if free and self.rank == self.coord:
            # converge laggards whose tables still route to the corpse
            # (mid-adoption views): rstep 0 = free verdict, no plan
            self.bus.publish(self.DEATH_KIND,
                             {"rank": int(r), "rstep": 0,
                              **self.lease.stamp()})
        self.trainer.gossip.exclude(r)
        for t in self.trainer.tables.values():
            t.on_ranks_dead({r})
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("membership", "mb_dead", {"rank": int(r)})

    def _on_death_verdict(self, sender: int, payload: dict) -> None:
        if not self.fence_frame(payload):
            return  # stale ex-coordinator's verdict: fenced by term
        r, rstep = int(payload.get("rank", -1)), int(
            payload.get("rstep", -1))
        if r == self.rank:
            # the fleet convicted ME dead and moved on (a partition
            # outlasted the quorum verdict): record, dump, and let the
            # training thread exit via FencedOutError at its next
            # boundary — continuing would write zombie gradients into
            # ranges the fleet already rolled back
            if self._convicted_term is None:
                self._convicted_term = int(payload.get(
                    "lt", self.lease.current()[0]))
                _fl.poison("fenced_out",
                           {"rank": self.rank, "rstep": rstep,
                            "term": self._convicted_term})
            return
        with self._lock:
            self._verdicts[r] = rstep
            if rstep < 0:
                self._unrecoverable.add(r)

    def refuses_own_death_plan(self, payload: dict) -> bool:
        """Plan receive guard (balance/rebalancer._mk_on_plan): a death
        plan whose ``dead`` extras name THIS rank must not be adopted
        here — adoption would snapshot-and-ship rbS state for blocks
        whose new owners restore from the checkpoint instead (the
        double-apply the heal drill forbids). The convicted rank stops
        participating and exits via the FencedOutError path."""
        dead = payload.get("dead")
        if not dead or self.rank not in {int(d) for d in dead}:
            return False
        if self._convicted_term is None:  # mbD normally precedes (FIFO)
            self._convicted_term = int(payload.get(
                "lt", self.lease.current()[0]))
            _fl.poison("fenced_out",
                       {"rank": self.rank, "via": "death_plan",
                        "term": self._convicted_term})
        return True

    def _raise_if_fenced_out(self) -> None:
        term = self._convicted_term
        if term is None:
            return
        # lame-duck linger: peers may still be NACK-recovering my
        # journaled partition-era frames (the repair loops ride the bus
        # threads, not this one) — one beat of grace keeps the heal's
        # zero-unrecovered-frames contract, then the poison fires
        time.sleep(1.0)
        raise FencedOutError(self.rank, term)

    def fatal_dead(self, dead: set[int]) -> set[int]:
        """The subset of monitor-dead ranks that must still POISON a
        wait. Survivable: a completed leave, a dead standby, a live
        death whose transition is planned or pending within the grace
        window. Fatal: an unrecoverable verdict (no checkpoint / dead
        coordinator), or a verdict that never arrived in time."""
        fatal: set[int] = set()
        now = time.monotonic()
        for r in set(dead):
            with self._lock:
                if r in self._unrecoverable:
                    fatal.add(r)
                    continue
                known = r in self.dead or r in self.left
                has_verdict = r in self._verdicts
                t0 = self._death_t.get(r, now)
            if not known:
                # monitor saw it before our hook did (foreign monitor
                # instance): register and re-judge next check
                self._on_peer_dead(r)
                continue
            if r in self.left or has_verdict:
                continue
            if now - t0 > self.cfg.grace:
                fatal.add(r)  # no verdict came: stop limping, restart
        return fatal

    def block_restorer(self, name: str, extras: dict):
        """The per-table restore closure a death plan's adoption runs
        (train/sharded_ps.adopt_table): block -> checkpoint state read
        through the save-time overlay (ckpt/elastic.load_block_state).
        Returns None when the plan carries no usable step (adoption
        then poisons loudly — a survivable death always carries one)."""
        step = int(extras.get("rstep", -1))
        ckpt = self._ckpt_dir
        if step < 0 or not ckpt:
            return None
        t = self.trainer.tables[name]
        # shared across one adoption's restores: a dead rank's B-block
        # restore must OPEN each shard file once, not B times (rank ->
        # NpzSliceReader — the reader slices block rows instead of
        # materializing whole shards, so the restore stages only what
        # it returns; the reads run under the table's locks)
        npz_cache: dict = {}

        def restore(b: int) -> dict:
            from minips_tpu_torch.ckpt import elastic

            blo, bln = t.router.block_span(b)
            return elastic.load_block_state(
                ckpt, step, name, b, blo, bln, t.router.home_of(b),
                t.part.shard_size, t.router.block_size,
                cache=npz_cache)
        return restore

    # ---------------------------------------------------------------- join
    def _on_join_req(self, sender: int, payload: dict) -> None:
        r = int(payload.get("rank", sender))
        with self._lock:
            if (self.rank == self.coord and r in self.standby
                    and r not in self._pending_joins):
                self._pending_joins.append(r)

    def _on_admit(self, sender: int, payload: dict) -> None:
        if not self.fence_frame(payload):
            return  # a stale ex-coordinator cannot admit anybody
        if int(payload.get("rank", -1)) == self.rank:
            self._admit_clk = int(payload.get("clk", 0))

    def _on_live(self, sender: int, payload: dict) -> None:
        r = int(payload.get("rank", sender))
        with self._lock:
            self.standby.discard(r)
            self.live.add(r)
            if self.rank == self.coord:
                self.counters["joins"] += 1
        # include AFTER its catch-up clock (same link, FIFO: the clock
        # frame precedes this announce) — gossip now gates on it
        self.trainer.gossip.include(r)
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("membership", "mb_live", {"rank": int(r)})

    def standby_loop(self, join_at: Optional[int] = None, *,
                     poll: float = 0.05,
                     timeout: float = 600.0) -> int:
        """The standby rank's whole pre-join life: serve (bus threads),
        adopt plans, announce at ``join_at`` (max live clock observed
        via gossip; None = announce immediately), block until admitted.
        Returns the catch-up clock to train from — or ``-1`` when the
        fleet FINISHED without admitting me (``mbEnd``): the run ended
        calm, which is a clean outcome for a standby, not a failure."""
        deadline = time.monotonic() + timeout
        while True:
            self.rb.adopt_now()  # pre-tick: any thread may adopt
            self._raise_if_fenced_out()
            with self._lock:
                if self._unrecoverable:
                    raise PeerFailureError(set(self._unrecoverable))
            if self._fleet_done:
                return -1
            if self._admit_clk is not None:
                break
            if self._join_due(join_at) \
                    and time.monotonic() - self._last_join_tx > 0.5:
                # repeat until admitted: the announce may race the
                # coordinator's handler registration or simply drop
                self.bus.send(self.coord, self.JOIN_KIND,
                              {"rank": self.rank})
                self._last_join_tx = time.monotonic()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"standby rank {self.rank}: never admitted")
            time.sleep(poll)
        clk = int(self._admit_clk)
        tr = self.trainer
        tr.clock = clk
        tr.gated_clock = clk
        # ORDER IS THE PROTOCOL: catch-up clock first, live announce
        # second, same FIFO link — every rank stores the clock before
        # it re-includes me, so the gate never sees a clock-0 ghost
        publish_clock(tr.gossip, clk, False)
        tr.gossip.include(self.rank)
        with self._lock:
            self.standby.discard(self.rank)
            self.live.add(self.rank)
        self.bus.publish(self.LIVE_KIND, {"rank": self.rank})
        self.rb.adopt_now()  # the admit plan may already be pending
        if _trc.TRACER is not None:
            _trc.TRACER.instant("membership", "mb_join",
                                {"rank": self.rank, "clk": clk})
        return clk

    def _join_due(self, join_at: Optional[int]) -> bool:
        if join_at is None:
            return True
        snap = self.trainer.gossip.snapshot()
        with self._lock:
            live = set(self.live)
        mx = max((max(v) for p, v in snap.items()
                  if v and p in live), default=0)
        return mx >= int(join_at)

    # --------------------------------------------------------------- leave
    def _on_drain(self, sender: int, payload: dict) -> None:
        # fenced like every coordinator frame: a partitioned
        # ex-coordinator's autoscaler must not shrink the fleet it no
        # longer runs (operator mbDr frames are unstamped and pass)
        if not self.fence_frame(payload):
            return
        self.begin_drain()

    def begin_drain(self) -> None:
        """Preemption signal landed (SIGTERM / mbDr / --drain-at): the
        training loop polls ``draining`` and hands over to leave()."""
        self._drain = True

    @property
    def draining(self) -> bool:
        return self._drain

    def _on_leave_req(self, sender: int, payload: dict) -> None:
        if self.rank != self.coord:
            return
        r = int(payload.get("rank", sender))
        with self._lock:
            if r in self.live and r != self.coord:
                self._leave_reqs[r] = dict(payload)

    def _on_gone(self, sender: int, payload: dict) -> None:
        r = int(payload.get("rank", sender))
        with self._lock:
            if r not in self.live and r not in self.standby:
                return
            self.live.discard(r)
            self.standby.discard(r)
            self.left.add(r)
            self._leave_reqs.pop(r, None)
            if self.rank == self.coord:
                self.counters["leaves"] += 1
        # the leaver published RETIRED before mbG; exclusion is the
        # belt-and-braces half (finalize/pull_all live sets, fence acks)
        self.trainer.gossip.exclude(r)
        self.quorum.drop_voter(r)  # a left rank's ballot is void too
        self.slow_quorum.drop_voter(r)
        if self._slowness is not None:
            self._slowness.exclude(r)
        self._update_slow_verdicts()
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("membership", "mb_gone", {"rank": int(r)})

    # ------------------------------------------------------------ handover
    def handover(self) -> int:
        """GRACEFUL LEASE HANDOVER (ROADMAP item 3 headroom (a),
        closed): the holder gives the lease away instead of dying with
        it. Term += 1 (``CoordinatorLease.transfer`` — any in-flight or
        journaled frame of mine is now stale-term and fences at every
        receiver, so handover is partition-proof by the same mechanism
        as succession), then ONE broadcast (``mbH``) carries the new
        ``(term, holder)`` plus the coordinator state succession would
        otherwise re-derive over several boundaries: the transition
        queues (pending joins / join credits / leave requests), the
        stored heat reports, and the autoscaler's hysteresis state —
        so the successor's next autoscale decision equals an
        uninterrupted coordinator's (pinned by test). Returns the
        successor's rank. Only the holder may call (raises
        otherwise); the caller then proceeds to :meth:`leave` — the
        drain path, which now addresses the NEW coordinator."""
        if self.rank != self.coord:
            raise RuntimeError(
                f"rank {self.rank} does not hold the lease "
                f"(holder: {self.coord}) — nothing to hand over")
        targets = self._live_targets(exclude={self.rank})
        if not targets:
            raise RuntimeError(
                "handover: no live rank left to take the lease — the "
                "last rank drains by just finishing (finalize)")
        succ = targets[0]  # sorted: the lowest live survivor, the same
        #                    pick succession would make
        tr = self.trainer
        with self._lock:
            # snapshot the coordinator queues under the lock: bus-
            # thread handlers (_on_leave_req, _on_join_req) mutate
            # them concurrently with this training-thread drain
            state: dict = {
                "joins": [int(j) for j in self._pending_joins],
                "credits": int(self._join_credits),
                "leave_reqs": {str(r): dict(req)
                               for r, req in self._leave_reqs.items()},
            }
        # heat reports re-gossip every tick anyway; shipping the store
        # means the successor's FIRST boundary sees the same load
        # picture the old holder did, not a cold start
        state["reports"] = {
            name: {str(r): dict(rep)
                   for r, rep in self.rb.heat_reports(name).items()}
            for name in tr.tables}
        a = getattr(tr, "autoscaler", None)
        if a is not None:
            state["autoscale"] = a.export_state()
        term, holder = self.lease.transfer(succ)
        self.bus.publish(self.HANDOVER_KIND,
                         {"rank": int(succ), "state": state,
                          **self.lease.stamp()})
        self._retarget(succ)
        tr2 = _trc.TRACER
        if tr2 is not None:
            tr2.instant("membership", "mb_handover",
                        {"term": term, "holder": holder})
        # a scaling-class DECISION, not a failure: checkpoint() dumps
        # the box with the transfer's why without flagging a poison
        _fl.checkpoint("lease_handover",
                       {"term": term, "holder": holder,
                        "from": self.rank})
        return int(succ)

    def _on_handover(self, sender: int, payload: dict) -> None:
        """Every receiver: observe the new term (fence_frame max-merges
        and re-targets). The NAMED successor additionally installs the
        transferred coordinator state before its next boundary runs
        the queues."""
        if not self.fence_frame(payload):
            return  # a stale ex-holder cannot hand over what it lost
        if int(payload.get("rank", -1)) != self.rank:
            return
        state = payload.get("state") or {}
        with self._lock:
            self._pending_joins = [
                int(j) for j in state.get("joins", ())
                if int(j) in self.standby
                and int(j) not in self._pending_joins] \
                + [j for j in self._pending_joins]
            self._join_credits = max(self._join_credits,
                                     int(state.get("credits", 0)))
            for r_s, req in (state.get("leave_reqs") or {}).items():
                self._leave_reqs.setdefault(int(r_s), dict(req))
        reports = state.get("reports") or {}
        if reports:
            self.rb.install_reports(
                {name: {int(r): dict(rep) for r, rep in by_rank.items()}
                 for name, by_rank in reports.items()})
        a = getattr(self.trainer, "autoscaler", None)
        a_state = state.get("autoscale")
        if a is not None and a_state:
            a.install_state(a_state)
        tr = _trc.TRACER
        if tr is not None:
            term, holder = self.lease.current()
            tr.instant("membership", "mb_handover_installed",
                       {"term": term, "holder": holder})
        _fl.record("lease_handover_installed",
                   {"from": int(sender), "holder": self.rank})

    def leave(self, timeout: float = 60.0) -> None:
        """Graceful exit of THIS rank (after its training loop broke on
        ``draining``): drain pushes, retire my clock, keep serving and
        re-asking the coordinator until every block I own has handed
        off and my fences released, then announce gone. Zero restored
        state anywhere — this is a migration, not a failure. THE LEASE
        HOLDER drains too: it hands the lease (and the
        coordinator state) to the lowest live survivor first —
        :meth:`handover`, term advances exactly once — then leaves
        like any other rank, addressing the new coordinator. The LAST
        live rank has nobody to hand to or ship blocks at: it drains
        by just finishing — flush, retire, announce gone, rc 0."""
        if self.rank == self.coord:
            if not self._live_targets(exclude={self.rank}):
                # sole survivor: no successor, no evacuation target —
                # the drain degenerates to a clean local quiesce
                for t in self.trainer.tables.values():
                    t.flush_pushes(acks=False)
                    t.residual_flush(reason="fence")
                    t.flush_pushes()
                    t.check_fatal()
                publish_clock(self.trainer.gossip,
                              self.trainer.clock, True)
                with self._lock:
                    self.live.discard(self.rank)
                    self.left.add(self.rank)
                self.bus.publish(self.GONE_KIND, {"rank": self.rank})
                return
            self.handover()
        tr = self.trainer
        self.rb.claim_drive_thread()  # adoption moves to THIS thread
        for t in tr.tables.values():
            # queue drain FIRST (a queued topk push retains fresh
            # residuals as it encodes on the sender thread), THEN the
            # residual flush — a leaver exiting rc 0 with retained
            # residuals would be silently-lost gradient — then the
            # hard ack drain covers the flush frames too
            t.flush_pushes(acks=False)
            t.residual_flush(reason="fence")
            t.flush_pushes()  # hard drain: owners hold all my updates
            t.check_fatal()
        # retire: gates and owner-side admission never wait on me again
        publish_clock(tr.gossip, tr.clock, True)
        deadline = time.monotonic() + timeout
        last_tx = 0.0
        while True:
            self.rb.adopt_now()
            with self._lock:
                if self._unrecoverable:
                    raise PeerFailureError(set(self._unrecoverable))
            for t in tr.tables.values():
                # a partition can eat an rbF after I stop training —
                # once I exit, nobody can ever release that gainer's
                # fence, so keep re-sending until every release is
                # CONFIRMED (rbG) before announcing gone
                t.resend_stale_releases()
            done = all(
                not (t.router.owner_of_blocks() == self.rank).any()
                and t.rebalance_settled()
                and t.releases_confirmed()
                for t in tr.tables.values())
            if done:
                break
            if time.monotonic() - last_tx > 0.25:
                self.bus.send(self.coord, self.LEAVE_KIND, {
                    "rank": self.rank,
                    "eps": {name: t.router.epoch
                            for name, t in tr.tables.items()},
                    "settled": all(t.rebalance_settled()
                                   for t in tr.tables.values())})
                last_tx = time.monotonic()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain of rank {self.rank}: blocks never handed "
                    "off (coordinator mute, or fleet fences stuck)")
            time.sleep(0.05)
        with self._lock:
            self.live.discard(self.rank)
            self.left.add(self.rank)
        self.bus.publish(self.GONE_KIND, {"rank": self.rank})
        if _trc.TRACER is not None:
            _trc.TRACER.instant("membership", "mb_leave",
                                {"rank": self.rank})
        # grace: my fences are released (rbF sent), so per-link FIFO
        # says every frame addressed to me has arrived — this sleep
        # only covers the mbG fan-out itself
        time.sleep(0.25)

    # ------------------------------------------------------ the tick hook
    def on_tick(self) -> None:
        """Called from ShardedPSTrainer.tick at the clock boundary,
        BEFORE the rebalancer's adoption point (a plan issued here is
        adopted in the same tick). Every rank: raise on unrecoverable
        deaths (or on having been fenced out). Coordinator: run the
        transition queues."""
        self._raise_if_fenced_out()
        with self._lock:
            if self._unrecoverable:
                raise PeerFailureError(set(self._unrecoverable))
        if self.rank != self.coord:
            return
        # fail-slow escalation before the transition queues: a drain
        # issued here rides the same boundary's queue machinery
        self._slow_escalate()
        self._coord_step()

    def poll(self) -> None:
        """Death transitions from the pull/fence WAIT paths: a
        coordinator blocked on a corpse-owned pull leg would otherwise
        wait for its own next tick to issue the very plan that unblocks
        it. Runs only on the push-driving thread (the adopt_now rule —
        plan issuance adopts locally) and only handles deaths:
        joins/leaves/bootstrap can wait for a real clock boundary."""
        self._raise_if_fenced_out()
        if self.rank != self.coord:
            return
        drive = self.rb._drive_thread
        if drive is not None and drive != threading.get_ident():
            return
        while True:
            with self._lock:
                if not self._pending_deaths:
                    return
                r = self._pending_deaths.pop(0)
            self._issue_death(r)

    def _on_end(self, sender: int, payload: dict) -> None:
        if not self.fence_frame(payload):
            return
        self._fleet_done = True

    def quiesce(self) -> None:
        """Finalize-time: no further transitions (in-flight migrations
        settle through the normal fence path). The COORDINATOR also
        tells any still-waiting standby the fleet is done (``mbEnd``):
        a run can legitimately end with held admissions (the autoscaler
        never saw load), and without this the orphaned standby would
        watch the fleet's heartbeats die one by one and convict the
        whole world instead of exiting clean."""
        with self._lock:
            self._pending_deaths.clear()
            self._pending_joins.clear()
            self._leave_reqs.clear()
            self._bootstrapped = True
            standbys_waiting = bool(self.standby)
        if standbys_waiting and self.rank == self.coord:
            self.bus.publish(self.END_KIND, {**self.lease.stamp()})

    def _next_eps(self) -> dict[str, int]:
        return {name: t.router.epoch + 1
                for name, t in self.trainer.tables.items()}

    def _issue(self, overlays: dict[str, dict],
               extras: Optional[dict] = None) -> None:
        for name, t in self.trainer.tables.items():
            self.rb.issue_plan(name, t.router.epoch + 1,
                               overlays[name], extras=extras)
        with self._lock:
            self.counters["plans"] += 1

    def _coord_step(self) -> None:
        tables = self.trainer.tables
        # -------- bootstrap: standby home ranges onto the live set
        # (a normal migration at the first boundary — standbys are live
        # SERVERS until it lands, so their seeded init ships via rbS)
        with self._lock:
            boot_needed = not self._bootstrapped
            standby = set(self.standby)
        if boot_needed:
            targets = self._live_targets()
            self._issue({name: plan_evacuation(t.router, standby,
                                               targets)
                         for name, t in tables.items()})
            with self._lock:
                self._bootstrapped = True
            return  # one transition per boundary
        # -------- deaths first: a corpse's ranges are unreachable
        with self._lock:
            death = self._pending_deaths.pop(0) \
                if self._pending_deaths else None
        if death is not None:
            self._issue_death(death)
            return
        # -------- leaves: ALL settled leavers at current epochs drain
        # in ONE evacuation plan — a whole-host drain (every rank of a
        # failure domain leaving together) is a single planned
        # redistribution instead of N independent leave transitions,
        # each of which would re-shuffle the previous one's re-homed
        # blocks (still one transition per boundary: one plan)
        with self._lock:
            leavers = [r for r, req in self._leave_reqs.items()
                       if req.get("settled")
                       and all(int(req.get("eps", {}).get(name, -1))
                               == t.router.epoch
                               for name, t in tables.items())]
            for r in leavers:
                del self._leave_reqs[r]
        if leavers:
            targets = self._live_targets(exclude=set(leavers))
            self._issue({name: plan_evacuation(t.router, set(leavers),
                                               targets)
                         for name, t in tables.items()})
            if len(leavers) > 1:
                _fl.record("mb_evacuation",
                           {"ranks": sorted(int(r) for r in leavers),
                            "targets": [int(t) for t in targets]})
            return
        # -------- joins: admit one rank per boundary. With hold_joins
        # (the autoscaler armed) an announced standby WAITS in the queue
        # until a grant_join() credit — scale-up is a load decision
        with self._lock:
            join = None
            if self._pending_joins and (not self.hold_joins
                                        or self._join_credits > 0):
                join = self._pending_joins.pop(0)
                if join not in self.standby:
                    join = None  # died (or already admitted) meanwhile
                elif self.hold_joins:
                    self._join_credits -= 1
        if join is not None:
            # clock first (the joiner trains from it), plans second —
            # both on my one FIFO link, so the joiner sees them in order
            self.bus.publish(self.ADMIT_KIND,
                             {"rank": join, "clk": self.trainer.clock,
                              **self.lease.stamp()})
            # heat-aware placement: the admit plan runs the
            # bin-packer over the coordinator's stored heat reports
            # (rbH flows even in elastic-only mode), so the joiner
            # absorbs hot blocks at admission instead of idling on its
            # cold home range; missing reports degrade to
            # home-blocks-only (plan_admission docstring)
            live = self._live_targets()
            self._issue({name: plan_admission(
                t.router, join, reports=self.rb.heat_reports(name),
                live=set(live), max_blocks=self.rb.cfg.max_blocks)
                for name, t in tables.items()})

    def _issue_death(self, r: int) -> None:
        """The death transition: verdict + plan. Unrecoverable (no
        complete checkpoint, no dir bound) broadcasts ``rstep=-1`` and
        poisons locally — the honest fallback to gang restart."""
        from minips_tpu_torch.ckpt import elastic

        step = None
        if self._ckpt_dir:
            with self._lock:
                # live ranks + the corpse must share the step (their
                # files hold the state); standbys/leavers need not —
                # a never-checkpointed standby's missing dir must not
                # veto recovery of somebody else's death
                required = self.live | {r}
            try:
                step = elastic.find_live_step(
                    self._ckpt_dir, self.trainer.tables, self.n,
                    required=required)
            except Exception:  # noqa: BLE001 - scan failure = no step
                step = None
        if step is None:
            self.bus.publish(self.DEATH_KIND,
                             {"rank": int(r), "rstep": -1,
                              **self.lease.stamp()})
            with self._lock:
                self._verdicts[r] = -1
                self._unrecoverable.add(r)
            _fl.poison("death_plan",
                       {"rank": int(r), "rstep": -1,
                        "why": "no complete checkpoint"})
            return
        targets = self._live_targets()
        extras = {"dead": [int(r)], "rstep": int(step)}
        self.bus.publish(self.DEATH_KIND,
                         {"rank": int(r), "rstep": int(step),
                          **self.lease.stamp()})
        with self._lock:
            self._verdicts[r] = int(step)
        self._issue({name: plan_evacuation(t.router, {r}, targets)
                     for name, t in self.trainer.tables.items()},
                    extras=extras)
        tr = _trc.TRACER
        if tr is not None:
            tr.instant("membership", "mb_death_plan",
                       {"rank": int(r), "rstep": int(step)})
        # the plan the successor issued, with its WHY (the restore step
        # chosen and who received the ranges) — the third line of the
        # post-mortem sequence verdict → term advance → death plan
        _fl.poison("death_plan",
                   {"rank": int(r), "rstep": int(step),
                    "targets": [int(t) for t in targets]})
