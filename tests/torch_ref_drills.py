"""Run the JAX package's drill files on the port, and on mixed fleets.

Two ways to run a reference drill file (``tests/test_rebalance.py`` and
its siblings):

- ``port_drills(file)`` renames every ``minips_tpu`` module in it to its
  ``minips_tpu_torch`` copy, points its loopback buses at the port's
  ``make_bus`` and runs the result as a module of its own: the same
  fixtures, marks, inputs and asserts, driving the port's layers (the
  waits of ``WAIT_ON_STATE`` aside, in both runners). A
  ``test_torch_*`` file exports what it returns, so pytest collects the
  drills there. The line numbers of a failure are the reference file's.
- ``fleet(file, kinds)`` runs the reference source as it stands, except
  that node ``i`` of every loopback mesh it builds, and the
  ``ShardedTable`` and ``ShardedPSTrainer`` on that node, come from
  package ``kinds[i % len(kinds)]`` (``"port"`` or ``"ref"``); a table
  with no bus (a drill's single-shard oracle) comes from ``kinds[0]``.
  Every table built on a bus is recorded, so ``states(ns)`` gives the
  shard states a drill left behind, and a mixed fleet can be held bit
  for bit against an all-reference one on the same drill.
"""

from __future__ import annotations

import importlib
import os
import re
import sys

import numpy as np

from minips_tpu import launch as jax_launch
from tests.torch_comm_util import PACKAGES, mixed_buses

TESTS = os.path.dirname(os.path.abspath(__file__))
# a launched port rank runs its step on the CPU with one intra-op thread
# (its steps are small, and the test run shares the host with other jobs)
CPU_RANK = {"MINIPS_FORCE_CPU": "1", "OMP_NUM_THREADS": "1"}
_HELPER = re.compile(r"from tests\.(test_\w+) import (\w+(?:, *\w+)*)")


def _helpers(m, call: str) -> str:
    """``from tests.test_x import a, b`` as one ``name = call("test_x.py",
    "name")`` statement per imported name."""
    return "; ".join(f'{n.strip()} = {call}("{m.group(1)}.py", '
                     f'"{n.strip()}")' for n in m.group(2).split(","))
# Waits of the reference drills that a receive thread can satisfy before
# the state they stand for exists: an owner counts a push's rows before
# it applies them, so a drill that reads the rows once the count is up
# can read them mid-apply (the reference's migration drill failed so,
# once, under -n 6). In both runners the wait holds until the rows the
# drill then asserts have arrived; a wrong value still fails, at the
# wait's timeout.
_PUSH_APPLIED = ('_wait(lambda: t1.serve["push_rows"] >= 4, '
                 'msg="push applied")')
_ROWS_APPLIED = ('_wait(lambda: t1.serve["push_rows"] >= 4 and '
                 'np.array_equal(t1._xtra[0]["w"], oracle._w[:4]), '
                 'msg="push applied")')
WAIT_ON_STATE = {"test_rebalance.py": [(_PUSH_APPLIED, _ROWS_APPLIED)],
                 "test_reshard.py": [(_PUSH_APPLIED, _ROWS_APPLIED)]}


def port_loopback_buses(n, backend="zmq", settle=0.25, **bus_kw):
    """``tests/conftest.py``'s ``mk_loopback_buses``, built by the port."""
    return mixed_buses(["port"] * n, backend, handshake=False,
                       settle=settle, **bus_kw)


def _read(ref_file: str) -> str:
    with open(os.path.join(TESTS, ref_file)) as f:
        src = f.read()
    for old, new in WAIT_ON_STATE.get(ref_file, ()):
        assert src.count(old) == 1, (ref_file, old)
        src = src.replace(old, new)
    return src


def _run(src: str, ref_file: str, name: str, extra=None) -> dict:
    ns = {"__name__": name, "__file__": os.path.join(TESTS, ref_file),
          **(extra or {})}
    exec(compile(src, ns["__file__"], "exec"), ns)
    return ns


_PORT_HELPERS: dict = {}


def port_helper(ref_file: str, name: str):
    """``name`` from the port run of ``tests/<ref_file>`` (a drill file's
    harness another drill file imports)."""
    if ref_file not in _PORT_HELPERS:
        _PORT_HELPERS[ref_file] = _port_ns(ref_file)
    return _PORT_HELPERS[ref_file][name]


def _port_ns(ref_file: str) -> dict:
    src = re.sub(r"\bminips_tpu\b", "minips_tpu_torch", _read(ref_file))
    src = src.replace(
        "from tests.conftest import mk_loopback_buses",
        "from tests.torch_ref_drills import "
        "port_loopback_buses as mk_loopback_buses")
    src = _HELPER.sub(
        lambda m: "from tests.torch_ref_drills import port_helper; "
        + _helpers(m, "port_helper"), src)
    return _run(src, ref_file, f"tests.port_{ref_file[:-3]}")


def port_drills(ref_file: str, *, leave=()) -> dict:
    """The namespace of ``tests/<ref_file>`` run on the port: its tests,
    fixtures and helpers, minus the tests named in ``leave`` (the caller
    says why each waits)."""
    ns = _port_ns(ref_file)
    for name in leave:
        del ns[name]
    return {k: v for k, v in ns.items() if not k.startswith("__")}


# ------------------------------------------------------------ mixed fleets
_SP_IMPORT = re.compile(
    r"from minips_tpu\.train\.sharded_ps import (\(([^)]*)\)|([\w ,]+))")


def _route_sp_import(m) -> str:
    body = m.group(2) if m.group(2) is not None else m.group(3)
    names = [n.strip() for n in body.split(",") if n.strip()]
    return (", ".join(names) + " = _fleet_names(" +
            ", ".join(repr(n) for n in names) + ")"
            + "\n" * m.group(0).count("\n"))


def fleet(ref_file: str, kinds, *, record=None) -> dict:
    """The namespace of ``tests/<ref_file>`` with its fleets built per
    ``kinds`` (module docstring); ``record`` is shared with the helper
    files it imports (``from tests.test_x import y``)."""
    kinds = tuple(kinds)
    record = [] if record is None else record
    mods = {k: importlib.import_module(f"{PACKAGES[k]}.train.sharded_ps")
            for k in PACKAGES}

    def kind_of(bus):
        if bus is None:
            return kinds[0]
        top = type(bus).__module__.split(".")[0]
        return "port" if top == PACKAGES["port"] else "ref"

    def table(name, num_rows, dim, bus, rank, nprocs, *a, **kw):
        t = mods[kind_of(bus)].ShardedTable(name, num_rows, dim, bus, rank,
                                           nprocs, *a, **kw)
        if bus is not None:
            record.append(t)
        return t

    def trainer(tables, bus, *a, **kw):
        return mods[kind_of(bus)].ShardedPSTrainer(tables, bus, *a, **kw)

    def buses(n, backend="zmq", settle=0.25, **bus_kw):
        return mixed_buses([kinds[i % len(kinds)] for i in range(n)],
                           backend, handshake=False, settle=settle,
                           **bus_kw)

    routed = {"ShardedTable": table, "ShardedPSTrainer": trainer}

    def names(*wanted):
        got = tuple(routed.get(n) or getattr(mods["ref"], n)
                    for n in wanted)
        return got if len(got) > 1 else got[0]

    def helper(other: str, name: str):
        return fleet(other, kinds, record=record)[name]

    src = _read(ref_file).replace(
        "from tests.conftest import mk_loopback_buses",
        "mk_loopback_buses = _fleet_buses")
    src = _HELPER.sub(lambda m: _helpers(m, "_fleet_helper"), src)
    src = _SP_IMPORT.sub(_route_sp_import, src)
    ns = _run(src, ref_file, f"tests.fleet_{ref_file[:-3]}",
              {"_fleet_buses": buses, "_fleet_names": names,
               "_fleet_helper": helper})
    ns.update(routed, _fleet_record=record)
    return ns


def states(ns) -> list:
    """The shard state of every table a fleet drill built on a bus, in
    the order the drill built them."""
    return [(t.name, t.rank, t.shard_state_dict())
            for t in ns["_fleet_record"]]


def assert_mixed_equals_reference(ref_file: str, drill: str) -> int:
    """Run ``drill`` (a test of ``tests/<ref_file>`` that takes no
    fixture) on an all-reference fleet and on both mixed fleets
    (reference node first, port node first), and hold every shard the
    mixed runs leave bit for bit to the reference run's. Returns how
    many tables the drill built."""
    ref = fleet(ref_file, ["ref"])
    ref[drill]()
    want = states(ref)
    assert want, f"{drill} built no table on a bus"
    for kinds in (["ref", "port"], ["port", "ref"]):
        mixed = fleet(ref_file, kinds)
        mixed[drill]()
        assert_equal_tree(states(mixed), want)
    return len(want)


def assert_equal_tree(a, b, path="") -> None:
    """Bitwise equality of nested dicts/lists of arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_equal_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def parse_alike(port_parse, ref_parse, spec):
    """Both packages' parsers on one spec: the same fields, or the same
    refusal (type and message). Returns the port's result."""
    outs = []
    for parse in (port_parse, ref_parse):
        try:
            outs.append(("ok", parse(spec)))
        except Exception as e:  # noqa: BLE001 - compared below
            outs.append(("err", (type(e).__name__, str(e))))
    (kp, p), (kr, r) = outs
    assert kp == kr, (spec, outs)
    if kp == "err":
        assert p == r, spec
    elif p is not None or r is not None:
        assert_equal_tree(_fields(p), _fields(r), spec)
    return p


def _fields(obj):
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _fields(v) for k, v in obj.items()}
    return {k: _fields(v) for k, v in vars(obj).items()
            if not callable(v)}


# ---------------------------------------------- launched beside the JAX job
JAX_APP = "minips_tpu.apps.sharded_ps_example"
MB_FIELDS = ("live", "standby", "dead", "left", "coord", "fenced_out",
             "epoch")


def membership_outcome(events) -> dict:
    """Per rank, the last line's event and membership fields, and the
    blocks restored fleet-wide."""
    out, restored = {}, 0
    for r, ev in enumerate(events):
        last = ev[-1] if ev else {}
        m = last.get("membership") or {}
        lease = m.get("lease") or {}
        out[r] = {"event": last.get("event"),
                  **{k: m.get(k) for k in MB_FIELDS},
                  "lease": (lease.get("term"), lease.get("holder"))}
        restored += m.get("blocks_restored", 0)
    return {"ranks": out, "blocks_restored": restored}


# JAX's persistent compilation cache for the JAX jobs beside the port's
# drills: one directory per test process, and the job signatures
# already compiled into it
_JAX_CACHE: dict = {"dir": None, "warm": set()}
# the untimed warm-up's heartbeat: long enough for any compile
_WARM_HEARTBEAT = "interval=0.1,timeout=60.0"


def _jax_job(n, extra, ck, env, timeout):
    return jax_launch.run_local_job_raw(
        n, [sys.executable, "-m", JAX_APP]
        + [ck if a.endswith("ck") else a for a in extra],
        base_port=None,
        env_extra={"MINIPS_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu",
                   **env},
        timeout=timeout, kill_on_failure=False)


def _warm_jax_cache(n, extra, env, timeout, tmp_path) -> dict:
    """The env that points a JAX job at a persistent compilation cache
    holding every program of this job: warmed once per job signature by
    an untimed run of the same job (no kill, heartbeat timeout 60 s), so
    that the compared run loads its steps from the cache instead of
    compiling them inside the drill's heartbeat window."""
    import tempfile

    if _JAX_CACHE["dir"] is None:
        _JAX_CACHE["dir"] = tempfile.mkdtemp(prefix="minips-jax-cache-")
    # plain subprocess ranks: the launcher's fork server imports jax
    # before a rank's env exists, so jax would never read these knobs
    cache = {"JAX_COMPILATION_CACHE_DIR": _JAX_CACHE["dir"],
             "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
             "MINIPS_SPAWN": "subprocess"}
    sig = (n, tuple(a for a in extra if not a.endswith("ck")))
    if sig not in _JAX_CACHE["warm"]:
        warm = {k: v for k, v in env.items() if k != "MINIPS_CHAOS_KILL"}
        warm["MINIPS_HEARTBEAT"] = _WARM_HEARTBEAT
        _jax_job(n, extra, str(tmp_path / "jax-warm" / "ck"),
                 {**warm, **cache}, timeout)
        _JAX_CACHE["warm"].add(sig)
    return cache


def drill_beside_jax(port_ns, drill, tmp_path, monkeypatch):
    """Run the port's launched ``drill`` (its own asserts), then the JAX
    example under the same flags and env, and hold the membership
    outcomes equal. Returns both outcomes.

    The JAX job runs under the drill's heartbeat timeout (1 s in the
    death drills), and a rank still compiling its step there can miss
    its beats long enough for its peers to convict it, on a loaded host:
    a fault of the host and not of either package. So the JAX job loads
    its programs from a persistent compilation cache that an untimed run
    of the same job filled (``_warm_jax_cache``). A JAX job whose ranks
    do not end as the port's did (``done`` where the port's were, the
    killed rank silent) runs once more, from a fresh checkpoint
    directory; the port's job runs once."""
    got = {}
    real = port_ns["_run_raw"]

    def capture(n, extra, env, timeout=200.0):
        got["job"] = (n, list(extra), dict(env), timeout)
        got["port"] = real(n, extra, env, timeout)
        return got["port"]

    monkeypatch.setitem(real.__globals__, "_run_raw", capture)
    port_ns[drill](tmp_path / "port")
    n, extra, env, timeout = got["job"]
    port = membership_outcome(got["port"][1])
    ends = {r: o["event"] for r, o in port["ranks"].items()}
    cache = _warm_jax_cache(n, extra, env, timeout, tmp_path)
    for attempt in range(2):
        ck = str(tmp_path / f"jax{attempt}" / "ck")
        _rc, events = _jax_job(n, extra, ck, {**env, **cache}, timeout)
        jax = membership_outcome(events)
        if {r: o["event"] for r, o in jax["ranks"].items()} == ends:
            break
    assert port == jax, (port, jax)
    done = [ev[-1] for ev in events if ev and ev[-1]["event"] == "done"]
    assert len({d["param_sum"] for d in done}) == 1, done
    return port, jax
