"""Helpers of the control-plane parity tests (``test_torch_comm.py``,
``test_torch_chaos_reliable.py``, ``test_torch_obs.py``).

A mixed fleet is one loopback mesh whose nodes are built by either
package's ``make_bus``: the wire (framing, seqs, the handshake, the
reliable layer's NACK and retransmit frames) is the contract between the
two, so a port node and a reference node must hear each other as they
hear their own kind. Ports come from the OS (``find_free_base_port``);
an shm mesh's segment names carry ``MINIPS_RUN_ID``, which the caller
sets per test, and ``shm_in`` keeps its files out of ``/dev/shm``.
``tests/conftest.py``'s ``mk_loopback_buses`` builds reference buses
only, so these build their own.
"""

from __future__ import annotations

import threading
import time

import pytest

PACKAGES = {"port": "minips_tpu_torch", "ref": "minips_tpu"}


def bus_module(pkg: str):
    """``comm.bus`` of the package named ``"port"`` or ``"ref"``."""
    import importlib

    return importlib.import_module(f"{PACKAGES[pkg]}.comm.bus")


def module(pkg: str, name: str):
    """``<package>.<name>`` of the package named ``"port"`` or ``"ref"``."""
    import importlib

    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def skip_without_native(kinds) -> None:
    """Skip where the C++ mailbox cannot build, for either package (both
    load the same ``cpp/build/libminips_comm.so``)."""
    for pkg in set(kinds):
        nb = module(pkg, "comm.native_bus")
        if not nb.NativeControlBus.available():
            pytest.skip("native mailbox unavailable")


def mixed_buses(kinds, backend: str = "zmq", *, handshake: bool = True,
                settle: float = 0.25, **bus_kw):
    """One loopback mesh of ``len(kinds)`` nodes, node ``i`` built by the
    ``make_bus`` of package ``kinds[i]`` (``"port"`` or ``"ref"``), all
    started and, with ``handshake``, past the rendezvous (run on every
    node at once, as the processes of a job would). ``bus_kw`` reach
    every ``make_bus`` (``chaos=``, ``reliable=``, ``wire_fmt=``)."""
    from minips_tpu.launch import find_free_base_port

    if backend == "native":
        skip_without_native(kinds)
    n = len(kinds)
    base = find_free_base_port(n)
    addrs = [f"tcp://127.0.0.1:{base + i}" for i in range(n)]
    buses = [bus_module(kinds[i]).make_bus(
        addrs[i], [a for j, a in enumerate(addrs) if j != i], my_id=i,
        backend=backend, **bus_kw) for i in range(n)]
    for b in buses:
        b.start()
    time.sleep(settle)  # PUB/SUB slow-joiner settle
    if handshake:
        errors: list = []

        def shake(b):
            try:
                b.handshake(n, timeout=20.0)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=shake, args=(b,)) for b in buses]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            close_all(buses)
            raise errors[0]
    return buses


def shm_in(monkeypatch, directory) -> None:
    """Put both packages' shm rings and doorbells in ``directory``
    instead of ``/dev/shm``: the JAX package's shm tests count the
    ``minips_bus_*`` files there, and a mixed fleet needs both packages
    to look in one place."""
    for pkg in PACKAGES:
        monkeypatch.setattr(module(pkg, "comm.shm_bus"), "_shm_dir",
                            lambda: str(directory))


def close_all(buses) -> None:
    for b in buses:
        b.close()


def wait_for(pred, timeout: float = 15.0, step: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def flush_link(src, dst, timeout: float = 15.0) -> None:
    """Return once every frame ``src`` put on the wire to ``dst`` before
    the call has passed ``dst``'s receive chain, its chaos injector
    included: an unstamped marker frame sent after them keeps their
    order on the link, and one that gets through shows they have passed.
    A marker the chaos drops is followed by another."""
    got: set = set()
    dst.on("__flush", lambda sender, payload: got.add(payload["i"]))
    deadline = time.monotonic() + timeout
    i = 0
    while True:
        src.send(dst.my_id, "__flush", {"i": i})
        if wait_for(lambda: i in got, timeout=0.2):
            return
        assert time.monotonic() < deadline, "no marker crossed the link"
        i += 1


def arm_obs(monkeypatch, tmp_path, rank: int = 0, *, trace: bool = False):
    """Arm each package's flight recorder (and with ``trace`` its tracer)
    explicitly, into a directory of its own under ``tmp_path``: both
    packages read the same ``MINIPS_FLIGHT`` / ``MINIPS_TRACE`` knobs and
    write the same file names, so one directory each keeps the two dumps
    apart. The knobs point into ``tmp_path`` too, so an implicit arming
    lands nowhere else. Returns ``{pkg: (flight, tracer or None)}``;
    ``disarm_obs`` undoes it."""
    monkeypatch.setenv("MINIPS_FLIGHT", str(tmp_path / "flight-env"))
    monkeypatch.setenv("MINIPS_TRACE", str(tmp_path / "trace-env")
                       if trace else "")
    out = {}
    for pkg in PACKAGES:
        fl = module(pkg, "obs.flight")
        tr = module(pkg, "obs.tracer")
        fl.reset_for_tests()
        tr.reset_for_tests()
        rec = fl.init(rank, str(tmp_path / pkg / "flight"))
        trc = tr.init(str(tmp_path / pkg / "trace"), rank) if trace \
            else None
        out[pkg] = (rec, trc)
    return out


def disarm_obs() -> None:
    for pkg in PACKAGES:
        module(pkg, "obs.flight").reset_for_tests()
        module(pkg, "obs.tracer").reset_for_tests()
