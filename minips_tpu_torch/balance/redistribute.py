"""Planned collective redistribution — assignment changes as ROUNDS.

Every path that moves table state between ranks (the rebalancer's
epoch-fenced migration and demote-drains, the membership plane's
join/drain/death evacuations, and the elastic N→M checkpoint reshard)
used to be a bag of point-to-point whole-block transfers: peak staging
memory and hottest-link serialization scaled with table size and fleet
shape, exactly what the 1/N-memory contract cannot absorb. This module
is the planner that turns any (old assignment, new assignment) diff
into a deterministic schedule of ROUNDS — each round a set of pairwise
block-SLICE exchanges with a hard per-rank staging-byte cap and a
bounded partner fanout — computed IDENTICALLY at every rank from the
shared routing epoch's overlay diff, no coordination wire ("Memory-
efficient array redistribution through portable collective
communication", PAPERS.md, gives the theory).

Config rides ``MINIPS_RESHARD`` (off by default), e.g.::

    MINIPS_RESHARD="cap=64m,fanout=2"

``"1"`` selects all defaults; size values take k/m/g suffixes. Knob
reference: docs/api.md; protocol, fencing, and the resume/abort
contract: docs/architecture.md "Planned collective redistribution".

The planner is a PURE function (property-tested in
tests/test_reshard.py): every moved block's rows are covered by exactly
one exchange set, no round stages more than ``cap`` bytes at any rank
(sent + received both count — staging is staging whichever direction it
flows), no rank talks to more than ``fanout`` distinct partners per
round, and a degenerate plan (cap ≥ every block, fanout ≥ world) is one
round of whole-block exchanges whose shipped bytes are identical to the
point-to-point path it replaces.

Honest floor: a cap smaller than ONE row's state bytes cannot be
honored (a row is the atomic unit — optimizer state rides its row);
such a cap degrades to one-row slices and the real per-round staging is
one row's bytes. The bench gate measures, it does not trust.

A copy of ``minips_tpu/balance/redistribute.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import re
from typing import Callable, NamedTuple, Optional

__all__ = ["ReshardConfig", "Exchange", "plan_rounds",
           "peak_stage_bytes", "state_row_bytes", "maybe_config"]

_SIZE_RE = re.compile(r"^(\d+)([kmg]?)$")
_SIZE_MUL = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def _parse_size(v: str) -> int:
    m = _SIZE_RE.fullmatch(v.strip().lower())
    if m is None:
        raise ValueError(f"expected <int>[k|m|g], got {v!r}")
    return int(m.group(1)) * _SIZE_MUL[m.group(2)]


class ReshardConfig:
    """Parsed ``MINIPS_RESHARD`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default)."""

    def __init__(self, *, cap: int = 64 << 20, fanout: int = 2):
        if cap < 1:
            raise ValueError("cap must be >= 1 byte")
        if fanout < 1:
            raise ValueError("fanout must be >= 1")
        self.cap = int(cap)        # per-rank staging bytes per round
        self.fanout = int(fanout)  # distinct partners per rank per round

    @classmethod
    def parse(cls, spec: str) -> "ReshardConfig":
        spec = (spec or "").strip()
        if spec in ("", "1", "on", "true"):
            return cls()
        kw: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_RESHARD: expected k=v, got {item!r}")
            k, v = item.split("=", 1)
            k = k.strip()
            if k == "cap":
                try:
                    kw["cap"] = _parse_size(v)
                except ValueError as e:
                    raise ValueError(
                        f"MINIPS_RESHARD: bad value for cap: {v!r}") from e
            elif k == "fanout":
                try:
                    kw["fanout"] = int(v)
                except ValueError as e:
                    raise ValueError(
                        f"MINIPS_RESHARD: bad value for fanout: "
                        f"{v!r}") from e
            else:
                raise ValueError(f"MINIPS_RESHARD: unknown knob {k!r}")
        try:
            return cls(**kw)
        except ValueError as e:
            raise ValueError(f"MINIPS_RESHARD: {e}") from e


def maybe_config(spec: Optional[str] = None) -> Optional[ReshardConfig]:
    """The trainer-ctor arming rule every MINIPS_* layer shares:
    explicit spec wins, else $MINIPS_RESHARD, else off; ``""``/``"0"``
    = off, anything else parses or raises."""
    if spec is None:
        spec = os.environ.get("MINIPS_RESHARD", "")
    if spec in ("", "0"):
        return None
    return ReshardConfig.parse(spec)


class Exchange(NamedTuple):
    """One pairwise slice transfer: rows ``[lo, lo+rows)`` WITHIN block
    ``block`` move ``src`` → ``dst``. ``lo`` is block-local so the wire
    frame head stays small and the receiver's write offset needs no
    router round trip."""
    block: int
    src: int
    dst: int
    lo: int
    rows: int


def state_row_bytes(dim: int, updater: str) -> int:
    """Bytes of ONE row's full migration state on the rbS wire (w plus
    optimizer leaves, f32, + adam's per-row i32 step) — must mirror
    ``ShardedTable._encode_block_state``'s layout exactly, the
    degenerate-plan byte-identity test pins it."""
    per_row = {"sgd": 1, "adagrad": 2, "adam": 3}[updater]
    return 4 * dim * per_row + (4 if updater == "adam" else 0)


def plan_rounds(moves, rows_of: Callable[[int], int], row_bytes: int,
                *, cap: int, fanout: int) -> list[list[Exchange]]:
    """Compile block moves into a deterministic round schedule.

    ``moves`` is any iterable of ``(block, src, dst)`` (each block at
    most once — the overlay diff guarantees it); ``rows_of(block)`` its
    row count; ``row_bytes`` the wire bytes of one row's state. Pure and
    order-insensitive: the moves are canonicalized by sorting, so every
    rank handing in the same SET of moves — however iterated — computes
    the identical schedule, which is what lets the fleet share a plan
    with zero coordination frames (the overlay diff at the shared
    routing epoch IS the input).

    Greedy first-fit: each slice (≤ cap bytes, ≥ 1 row) lands in the
    earliest round where both endpoints stay under the staging cap and
    the partner fanout; a fresh round always admits one slice, so the
    schedule terminates with every row placed exactly once.
    """
    if cap < 1:
        raise ValueError("plan_rounds: cap must be >= 1")
    if fanout < 1:
        raise ValueError("plan_rounds: fanout must be >= 1")
    if row_bytes < 1:
        raise ValueError("plan_rounds: row_bytes must be >= 1")
    canon = sorted((int(b), int(s), int(d)) for b, s, d in moves)
    seen: set[int] = set()
    for b, _s, _d in canon:
        if b in seen:
            raise ValueError(
                f"plan_rounds: block {b} appears in more than one move")
        seen.add(b)
    max_rows = max(1, cap // row_bytes)
    slices: list[Exchange] = []
    for b, s, d in canon:
        n = int(rows_of(b))
        for lo in range(0, n, max_rows):
            slices.append(Exchange(b, s, d, lo, min(max_rows, n - lo)))
    rounds: list[list[Exchange]] = []
    loads: list[dict[int, int]] = []    # per round: rank -> staged bytes
    partners: list[dict[int, set]] = []  # per round: rank -> peer set
    for ex in slices:
        sb = ex.rows * row_bytes
        placed = False
        for r in range(len(rounds)):
            ld, pt = loads[r], partners[r]
            if ld.get(ex.src, 0) + sb > cap or ld.get(ex.dst, 0) + sb > cap:
                continue
            ps, pd = pt.setdefault(ex.src, set()), pt.setdefault(ex.dst,
                                                                 set())
            if (ex.dst not in ps and len(ps) >= fanout) \
                    or (ex.src not in pd and len(pd) >= fanout):
                continue
            rounds[r].append(ex)
            ld[ex.src] = ld.get(ex.src, 0) + sb
            ld[ex.dst] = ld.get(ex.dst, 0) + sb
            ps.add(ex.dst)
            pd.add(ex.src)
            placed = True
            break
        if not placed:
            rounds.append([ex])
            loads.append({ex.src: sb, ex.dst: sb})
            partners.append({ex.src: {ex.dst}, ex.dst: {ex.src}})
    return rounds


def peak_stage_bytes(rounds: list[list[Exchange]],
                     row_bytes: int) -> int:
    """Max per-rank staged bytes over the whole schedule (sent and
    received both count) — the quantity the cap bounds and the
    RESHARD-MEM gate measures."""
    peak = 0
    for rnd in rounds:
        ld: dict[int, int] = {}
        for ex in rnd:
            sb = ex.rows * row_bytes
            ld[ex.src] = ld.get(ex.src, 0) + sb
            ld[ex.dst] = ld.get(ex.dst, 0) + sb
        if ld:
            peak = max(peak, max(ld.values()))
    return peak
