"""Hedged pull legs — the READ mitigation rung of the fail-slow ladder.

A pull leg aimed at a slow-but-alive owner rides to the pull deadline:
the owner's beats land (no death verdict), its reply eventually comes
(no loss), and meanwhile the requester's step — and through the SSP
gate, the fleet's — waits. The tail-tolerant answer is the classic
hedged request: once a leg has been outstanding past a hedge delay
(or its owner carries a fleet SLOW VERDICT, in which case immediately),
re-issue JUST THAT LEG to a replica holder of its blocks and let the
first admissible reply win.

Why the semantics are provably unchanged (docs/fault_tolerance.md):

- The hedge rides the serving plane's ``svP`` wire to a holder whose
  snapshot is stamped with the owner's ``global_min`` — the holder
  serves only when ``consistency.gate.admits(stamp, clk, s)``, the
  IDENTICAL predicate the owner-side park runs, so any reply that
  arrives (owner's or hedge's) satisfies the same staleness bound a
  sole owner reply would. First-ADMISSIBLE-reply-wins is therefore
  first-reply-wins; the loser is discarded by its wire rid.
- Hedges are issued from the pull-WAIT loop (the training/reader
  thread polling its own legs), never from the bus receive thread —
  a recv-thread send is the receive-thread deadlock class this plane must not
  reintroduce.
- Hedges are counted and budget-bounded (at most one hedge per leg,
  at most ``budget`` outstanding per table): a sick fleet degrades to
  the unhedged path, never to a hedge storm.
- Armed-but-idle is bitwise-equal to off (SLOW-IDLE): with no slow
  link, no leg outlives ``max(min_ms, factor x windowed pull p99)``
  and no hedge ever fires — the drill pins it.

Honest limit: a hedge needs a REPLICA HOLDER covering the leg's
blocks (the serving plane). With the plane off, or the slow
owner's blocks cold/unreplicated, there is no second copy to read —
the leg waits exactly as before, and ``no_holder`` counts how often
that ceiling was hit.

Armed by ``MINIPS_HEDGE`` (off by default)::

    MINIPS_HEDGE="1"                       # every default
    MINIPS_HEDGE="delay_ms=0,factor=3,min_ms=25,budget=4"

``delay_ms=0`` (the default) derives the delay from the windowed pull
p99 (obs/window.py) at hedge time — the p99-derived delay of the
hedged-request literature; a fixed ``delay_ms`` pins it for drills.
Knob table: docs/api.md "Fail-slow plane".

A copy of ``minips_tpu/serve/hedge.py``, which imports no JAX.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["HedgeConfig", "maybe_config"]


class HedgeConfig:
    """Parsed ``MINIPS_HEDGE`` knobs (``k=v`` comma list; the bare
    string ``"1"`` = every default)."""

    def __init__(self, *, delay_ms: float = 0.0, factor: float = 3.0,
                 min_ms: float = 25.0, budget: int = 4):
        if delay_ms < 0:
            raise ValueError("MINIPS_HEDGE: delay_ms must be >= 0 "
                             "(0 = derive from the windowed pull p99)")
        if factor < 1.0:
            raise ValueError("MINIPS_HEDGE: factor must be >= 1 (a "
                             "hedge below the p99 fires on healthy "
                             "tails)")
        if min_ms <= 0:
            raise ValueError("MINIPS_HEDGE: min_ms must be > 0 — the "
                             "floor is what keeps armed-idle loopback "
                             "runs hedge-free (SLOW-IDLE)")
        if budget < 1:
            raise ValueError("MINIPS_HEDGE: budget must be >= 1 "
                             "outstanding hedge")
        self.delay_ms = float(delay_ms)  # fixed hedge delay (0 = auto)
        self.factor = float(factor)      # auto: p99 multiple
        self.min_ms = float(min_ms)      # auto: absolute floor
        self.budget = int(budget)        # max outstanding hedges/table

    @classmethod
    def parse(cls, spec: str) -> "Optional[HedgeConfig]":
        """None = hedging OFF (empty/``"0"``); a config otherwise —
        unknown knobs and bad values refuse loudly (the shared
        MINIPS_* spec hygiene, fuzzer-pinned)."""
        spec = (spec or "").strip()
        if not spec or spec == "0":
            return None
        if spec in ("1", "on", "true"):
            return cls()
        kw: dict = {}
        casts = {"delay_ms": float, "factor": float, "min_ms": float,
                 "budget": int}
        for item in filter(None, (e.strip() for e in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"MINIPS_HEDGE: expected k=v, got {item!r}")
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in casts:
                raise ValueError(f"MINIPS_HEDGE: unknown knob {k!r}")
            try:
                kw[k] = casts[k](v)
            except ValueError as e:
                raise ValueError(
                    f"MINIPS_HEDGE: bad value for {k}: {v!r}") from e
        return cls(**kw)


def maybe_config(spec: Optional[str] = None) -> "Optional[HedgeConfig]":
    """Config from an explicit spec or ``$MINIPS_HEDGE`` (explicit
    wins); None when hedging is off."""
    if spec is None:
        spec = os.environ.get("MINIPS_HEDGE", "")
    return HedgeConfig.parse(spec)
