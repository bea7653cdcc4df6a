"""Tenant registry — one PS fleet serving many models with isolated SLOs.

A TENANT is a table with its own service contract: its own updater and
wire tier, its own staleness bound ``s``, its own admission budget
(``rate``/``burst`` token bucket), and its own replica/hedge budgets.
The fleet-level machinery (heat accounting, migration planning, the
autoscaler's load picture, the serve plane's shed paths) historically
summed every table into one signal — and a summed
shed counter cannot tell a storming tenant from a hot fleet. This
registry is the naming layer that splits those signals: every frame
head carries the owning table's tenant id (``tb``, next to the
ws/nr/dm/rb config stamp), heat reports are stamped with it, and the
serve plane's admission/shed counters are kept per tenant so an
elastic decision can NAME the tenant that caused it.

Config rides ``MINIPS_TENANT`` (off by default). Entries are split on
``;``: each entry is a tenant — ``name`` or ``name:k=v,k=v`` where the
name is the TABLE name it governs — or a fleet-global knob written
plain ``k=v`` (no ``:``). ``"1"`` arms a single default tenant per
table with no overrides (the armed-idle drill config: bitwise-equal to
off, zero tenant counters). Examples::

    MINIPS_TENANT="1"
    MINIPS_TENANT="trn:rate=0,s=1;inf:rate=500,burst=64,s=2"
    MINIPS_TENANT="trn;inf:rate=500;shared=1"

Per-tenant knobs: ``updater`` (sgd|adagrad|adam), ``wire`` (f32|int8,
the pull wire tier), ``s`` (staleness bound, float or ``inf``),
``block`` (rebalance block rows), ``rate``/``burst`` (admission token
bucket; rate=0 = never shed), ``replicas`` (serve-plane replica
budget), ``hedge`` (hedge budget per window). Global knobs:
``shared`` (0|1 — ONE fleet-wide admission bucket shared by every
tenant instead of per-tenant buckets; the coupling contrast arm the
multi_tenant bench measures against). Unknown knobs, bad values, and
duplicate tenant names raise ValueError naming the offending token.
Knob reference: docs/api.md; protocol and the isolation argument:
docs/architecture.md "Multi-tenant tables".

Tenant ids are 1-based (0 on the wire = tenancy off): named tenants
take spec order; the bare-``"1"`` default takes sorted table-name
order at bind. Every rank must agree — the ``tb`` config stamp in the
frame head poisons a table on divergence exactly like a ws/nr/dm/rb
mismatch would, so a fleet half-armed or armed with reordered specs
fails loudly instead of silently crossing tenants' wires.

Honest limits: tenancy namespaces ACCOUNTING and ADMISSION, not
compute — tenants still share each rank's process, bus, and push
thread, so a tenant burning CPU inside its own admitted budget still
steals cycles (the bench's 10% isolation bound, not 0%). And the
registry governs tables, not requests: one table = one tenant, there
is no finer-grained per-request tenancy.

A copy of ``minips_tpu/tenant/registry.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import re
from typing import Optional

__all__ = ["TenantSpec", "TenantRegistry", "maybe_registry"]

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

_UPDATERS = ("sgd", "adagrad", "adam")
_WIRES = ("f32", "int8")


def _f_nonneg(v: str, knob: str) -> float:
    try:
        x = float(v)
    except ValueError as e:
        raise ValueError(f"bad value for {knob}: {v!r}") from e
    if not (x >= 0.0):  # refuses nan too
        raise ValueError(f"bad value for {knob}: {v!r} (must be >= 0)")
    return x


def _i_min(v: str, knob: str, lo: int) -> int:
    try:
        x = int(v)
    except ValueError as e:
        raise ValueError(f"bad value for {knob}: {v!r}") from e
    if x < lo:
        raise ValueError(
            f"bad value for {knob}: {v!r} (must be >= {lo})")
    return x


class TenantSpec:
    """One tenant's parsed service contract. Every field except
    ``name`` is Optional — ``None`` means "inherit today's behavior",
    which is what makes the bare default tenant bitwise-idle."""

    def __init__(self, name: str, *,
                 updater: Optional[str] = None,
                 wire: Optional[str] = None,
                 s: Optional[float] = None,
                 block: Optional[int] = None,
                 rate: Optional[float] = None,
                 burst: Optional[int] = None,
                 replicas: Optional[int] = None,
                 hedge: Optional[int] = None):
        self.name = name
        self.tid = 0          # assigned by the registry (1-based)
        self.updater = updater
        self.wire = wire
        self.s = s
        self.block = block
        self.rate = rate
        self.burst = burst
        self.replicas = replicas
        self.hedge = hedge

    _KNOBS = ("updater", "wire", "s", "block", "rate", "burst",
              "replicas", "hedge")

    def overrides(self) -> dict:
        """The non-None knobs, for stats/flight evidence."""
        out = {}
        for k in self._KNOBS:
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kv = ", ".join(f"{k}={v!r}" for k, v in self.overrides().items())
        return f"TenantSpec({self.name!r}, tid={self.tid}{', ' if kv else ''}{kv})"


class TenantRegistry:
    """Parsed ``MINIPS_TENANT``: the tenant set plus fleet-global
    knobs. ``bind(tables)`` (called once from the trainer ctor, before
    any balance/serve layer arms) assigns tenant ids and validates the
    spec against the constructed tables — every rank runs the same
    deterministic assignment, and the wire's ``tb`` stamp enforces
    that they actually did."""

    def __init__(self, tenants: Optional[dict[str, TenantSpec]] = None,
                 *, shared: bool = False):
        # named tenants keep SPEC order (dict insertion order); the
        # default registry (tenants=None) materializes one bare tenant
        # per table in sorted-name order at bind
        self.tenants: dict[str, TenantSpec] = dict(tenants or {})
        self.default = not self.tenants
        self.shared = bool(shared)
        self._bound = False
        for i, sp in enumerate(self.tenants.values()):
            sp.tid = i + 1

    # ------------------------------------------------------------ parse
    @classmethod
    def parse(cls, spec: str) -> "TenantRegistry":
        spec = (spec or "").strip()
        if spec in ("1", "on", "true"):
            return cls()
        tenants: dict[str, TenantSpec] = {}
        shared = False
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if ":" not in entry and "=" in entry:
                # fleet-global knob
                k, v = entry.split("=", 1)
                k, v = k.strip(), v.strip()
                if k == "shared":
                    if v not in ("0", "1"):
                        raise ValueError(
                            f"MINIPS_TENANT: bad value for shared: "
                            f"{v!r} (must be 0 or 1)")
                    shared = v == "1"
                else:
                    raise ValueError(
                        f"MINIPS_TENANT: unknown global knob {k!r}")
                continue
            name, _, body = entry.partition(":")
            name = name.strip()
            if not _NAME_RE.fullmatch(name):
                raise ValueError(
                    f"MINIPS_TENANT: bad tenant name {name!r}")
            if name in tenants:
                raise ValueError(
                    f"MINIPS_TENANT: duplicate tenant {name!r}")
            kw: dict = {}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                if "=" not in item:
                    raise ValueError(
                        f"MINIPS_TENANT: expected k=v in tenant "
                        f"{name!r}, got {item!r}")
                k, v = item.split("=", 1)
                k, v = k.strip(), v.strip()
                try:
                    if k == "updater":
                        if v not in _UPDATERS:
                            raise ValueError(
                                f"bad value for updater: {v!r}")
                        kw["updater"] = v
                    elif k == "wire":
                        if v == "float32":  # push-knob spelling
                            v = "f32"
                        if v not in _WIRES:
                            raise ValueError(
                                f"bad value for wire: {v!r}")
                        kw["wire"] = v
                    elif k == "s":
                        kw["s"] = _f_nonneg(v, "s")
                    elif k == "block":
                        kw["block"] = _i_min(v, "block", 1)
                    elif k == "rate":
                        kw["rate"] = _f_nonneg(v, "rate")
                    elif k == "burst":
                        kw["burst"] = _i_min(v, "burst", 1)
                    elif k == "replicas":
                        kw["replicas"] = _i_min(v, "replicas", 1)
                    elif k == "hedge":
                        kw["hedge"] = _i_min(v, "hedge", 0)
                    else:
                        raise ValueError(f"unknown knob {k!r}")
                except ValueError as e:
                    raise ValueError(
                        f"MINIPS_TENANT: tenant {name!r}: {e}") from e
            tenants[name] = TenantSpec(name, **kw)
        if not tenants:
            raise ValueError(
                f"MINIPS_TENANT: no tenants in spec {spec!r}")
        return cls(tenants, shared=shared)

    # ------------------------------------------------------------- bind
    def bind(self, tables: dict) -> None:
        """Assign tenant ids over the trainer's table set and validate
        the spec against what was actually constructed. Named mode:
        every table must be named (an unlisted table would silently
        run outside every SLO — refuse instead), and a spec'd
        updater/wire must MATCH the built table (the registry cannot
        rebuild a table; a mismatch means the app ignored
        ``table_kwargs``). Default mode: one bare tenant per table,
        sorted-name order. Idempotent per registry instance."""
        if self._bound:
            return
        if self.default:
            for i, name in enumerate(sorted(tables)):
                sp = TenantSpec(name)
                sp.tid = i + 1
                self.tenants[name] = sp
        else:
            missing = sorted(set(tables) - set(self.tenants))
            if missing:
                raise ValueError(
                    f"MINIPS_TENANT: table {missing[0]!r} has no "
                    f"tenant spec (every table must be named)")
            for name, sp in self.tenants.items():
                t = tables.get(name)
                if t is None:
                    continue  # spec'd tenant whose table this job lacks
                if sp.updater is not None and sp.updater != t.updater:
                    raise ValueError(
                        f"MINIPS_TENANT: tenant {name!r} spec says "
                        f"updater={sp.updater!r} but table was built "
                        f"with {t.updater!r}")
                if sp.wire is not None and sp.wire != t.pull_wire:
                    raise ValueError(
                        f"MINIPS_TENANT: tenant {name!r} spec says "
                        f"wire={sp.wire!r} but table was built with "
                        f"{t.pull_wire!r}")
        self._bound = True

    def spec_for(self, name: str) -> Optional[TenantSpec]:
        return self.tenants.get(name)

    def table_kwargs(self, name: str) -> dict:
        """Ctor overrides an app should splat into ``ShardedTable``
        for this tenant's table — the spec'd updater/wire become the
        build, so ``bind`` has nothing to refuse."""
        sp = self.tenants.get(name)
        if sp is None:
            return {}
        kw: dict = {}
        if sp.updater is not None:
            kw["updater"] = sp.updater
        if sp.wire is not None:
            kw["pull_wire"] = sp.wire
        return kw


def maybe_registry(spec: Optional[str] = None) -> Optional[TenantRegistry]:
    """The trainer-ctor arming rule every MINIPS_* layer shares:
    explicit spec wins, else $MINIPS_TENANT, else off; ``""``/``"0"``
    = off, anything else parses or raises."""
    if spec is None:
        spec = os.environ.get("MINIPS_TENANT", "")
    if spec in ("", "0"):
        return None
    return TenantRegistry.parse(spec)
