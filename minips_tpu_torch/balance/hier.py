"""Hierarchical push aggregation — the two-level topology-aware tree.

At production fleet shapes cross-host push bytes scale with total
WORKERS instead of hosts: every worker ships its own owner-split frames
to every owner even when N workers share a host. The SparCML answer
(PAPERS.md) is to combine sparse contributions close to the source:

- **level 1 (intra-host, exact)**: co-host workers ship their
  out-of-group owner slices to a per-host LEADER rank as dense f32
  contribution frames (``psH`` op ``"c"`` — the shm ring lane when
  ``MINIPS_BUS=shm``, any bus otherwise); the leader SUMS them in f64
  via the shared client-side dedup kernel before any compression, so
  the reduce is exact;
- **level 2 (cross-host, compressed)**: the leader ships ONE
  topk8/topk4 frame per owner per boundary, with error feedback folded
  in the leader's ``ResidualStore`` — one residual set per (host,
  owner) row range instead of per worker — so the unbiased-flush
  contract survives aggregation.

Topology model: ``group=g`` partitions ranks into contiguous host
groups (host of rank r = ``r // g``; ``group=local`` resolves the
launcher's ``MINIPS_LOCAL_PROCS`` colocation count). A (worker, owner)
pair is in HIER MODE iff the two ranks live in different groups AND the
worker's group has >= 2 live ranks — in-group pushes always stay on
the flat wire, and ``group=1`` (the default, armed-idle) leaves every
pair flat: bitwise-equal to off by construction.

Staleness is preserved, not relaxed: a member's clock frame no longer
certifies its cross-host pushes (they ride member -> leader -> owner,
two links — per-link FIFO does not compose), so the owner tracks a
per-contributor FLOOR advanced only by leader frames (``hfl``) whose
member boundaries rode the member->leader FIFO. Pull admission folds
``min(floors)`` into ``gate.admits`` next to the gossip min, and the
aggregated frame's stamp is the MIN over its contributors' clocks.

Leader election is deterministic (lowest live rank of the group) and
re-runs whenever the quorum convicts, drains, or retires the leader;
while leaderless — or when a sick leader lets the unacked-step window
pass ``retain`` — members FALL BACK to direct per-worker push (retained
steps re-pushed with step tags; the owner drops tags below the floor it
already applied via the dead leader, so handoff is exactly-once). A
sick leader degrades to bytes, never to loss.

Armed by ``MINIPS_HIER`` (off by default)::

    MINIPS_HIER="1"                 # armed-idle: group=1, no pairs
    MINIPS_HIER="group=2,retain=64"
    MINIPS_HIER="group=local"       # launcher-derived colocation
    MINIPS_HIER="group=2,agg=0"     # accounting-only: flat wire +
                                    # per-level byte counters (the
                                    # HIER-WIN flat arm)
    MINIPS_HIER="group=2,agg=mesh"  # hybrid plane: the leader reduces
                                    # members' contributions on the
                                    # host's device mesh (blk8 + EF)
                                    # and ships the same one frame per
                                    # owner cross-host

Knob table: docs/api.md "Hierarchical aggregation"; protocol and
honest limits: docs/architecture.md "The two-level push tree".

A copy of ``minips_tpu/balance/hier.py``, which imports no JAX.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

__all__ = ["HierConfig", "maybe_config", "host_of", "group_ranks",
           "elect"]


class HierConfig:
    """Parsed ``MINIPS_HIER`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default = armed-idle)."""

    def __init__(self, *, group: int = 1, retain: int = 64,
                 agg=1):
        if group < 1:
            raise ValueError("MINIPS_HIER: group must be >= 1 rank "
                             "per host group (1 = armed-idle, every "
                             "pair flat)")
        if retain < 1:
            raise ValueError("MINIPS_HIER: retain must be >= 1 unacked "
                             "step before the fallback hysteresis "
                             "trips")
        if agg not in (0, 1, "mesh"):
            raise ValueError("MINIPS_HIER: agg must be 0 (accounting-"
                             "only flat arm), 1 (host f64 aggregate) "
                             "or 'mesh' (leader reduces on the host's "
                             "device mesh)")
        self.group = int(group)    # ranks per contiguous host group
        self.retain = int(retain)  # unacked-step window before fallback
        # 0 = flat wire + per-level counters; 1 = leader host f64
        # dedup; "mesh" = leader deposits members' contributions into
        # a MeshAggregator and one device reduce-scatter produces the
        # cross-host aggregate (falls back to the bitwise host kernel
        # on degenerate one-device meshes)
        self.agg = agg if agg == "mesh" else int(agg)

    @classmethod
    def parse(cls, spec: str) -> "Optional[HierConfig]":
        """None = hier OFF (empty/``"0"``); a config otherwise —
        unknown knobs and bad values refuse loudly (the shared
        MINIPS_* spec hygiene, fuzzer-pinned)."""
        spec = (spec or "").strip()
        if not spec or spec == "0":
            return None
        if spec in ("1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"group": _cast_group, "retain": int, "agg": _cast_agg}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_HIER: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_HIER: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_HIER: bad value for {k}: {v!r}") from e
        return cls(**kw)


def _cast_agg(v: str):
    """``agg=`` accepts 0/1 or the string ``mesh`` — the hybrid data
    plane's in-host device reduce (train/mesh_plane.MeshAggregator)."""
    if v.strip().lower() == "mesh":
        return "mesh"
    return int(v)


def _cast_group(v: str) -> int:
    """``group=`` accepts an int or ``local`` — the launcher stamps
    ``MINIPS_LOCAL_PROCS`` (launch.py) with how many ranks it colocated
    on this host, so ``group=local`` follows the real topology without
    re-stating it per deployment. Outside a launcher (no env) ``local``
    degrades to 1: armed-idle, never a wrong tree."""
    if v.strip().lower() == "local":
        return max(1, int(os.environ.get("MINIPS_LOCAL_PROCS", "1")))
    return int(v)


def host_of(rank: int, group: int) -> int:
    """The host-group id of ``rank`` under contiguous grouping."""
    return int(rank) // max(1, int(group))


def group_ranks(rank: int, group: int, nprocs: int) -> list[int]:
    """All ranks sharing ``rank``'s host group (rank included)."""
    g = max(1, int(group))
    h = host_of(rank, g)
    return [r for r in range(h * g, min((h + 1) * g, int(nprocs)))]


def elect(ranks: Iterable[int], excluded: Iterable[int] = ()
          ) -> Optional[int]:
    """THE deterministic leader rule: lowest live rank of the group —
    every member computes it locally from the same gossip exclusion
    set, so election needs no extra protocol round (the same
    lowest-live-rank rule the coordinator lease succession uses,
    balance/control_plane.py). None when the whole group is dead."""
    live = sorted(set(int(r) for r in ranks)
                  - set(int(x) for x in excluded))
    return live[0] if live else None


def maybe_config(spec: Optional[str] = None) -> "Optional[HierConfig]":
    """Config from an explicit spec or ``$MINIPS_HIER`` (explicit
    wins); None when hier is off."""
    if spec is None:
        spec = os.environ.get("MINIPS_HIER", "")
    return HierConfig.parse(spec)
