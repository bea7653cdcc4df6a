"""Process launcher — the port of ``minips_tpu/launch.py`` (the rebuild
of the reference's launch scripts, SURVEY.md §1 L7, §2 "Launch scripts").

The reference parses a hostfile and ssh-spawns one process per node with
``--my_id i``. Here the same shape: ``python -m minips_tpu_torch.launch
--hostfile hosts.txt -- python worker.py ...`` spawns one worker process
per hostfile line (locally via subprocess for 127.0.0.1/localhost lines,
via ssh otherwise) and wires each with environment variables instead of
flags, so any program can join without argparse ceremony:

- ``MINIPS_PROC_ID`` / ``MINIPS_NUM_PROCS`` — my rank / world size
  (reference ``--my_id`` + hostfile length).
- ``MINIPS_BUS_ADDRS`` — comma list of every process's control-bus PUB
  endpoint (reference: mailbox node list). Process i binds the i-th.
- ``MINIPS_COORDINATOR`` — proc 0's host:port, the rendezvous a
  multi-host ``torch.distributed`` bootstrap will read (advertised for
  wire compatibility with the JAX package's launcher; unused until
  ``comm/cluster.py`` is ported, ROADMAP.md queue 1 item 16: the data
  plane of every launched job here is the bus).
- ``MINIPS_LOCAL_RANK`` — my index among the processes on my host: a
  rank on the card runs on ``cuda:{MINIPS_LOCAL_RANK mod device_count}``
  (``apps/common.py`` ``multiproc_device``).

Failure policy matches a PS job's: first nonzero exit kills the rest
(all-or-nothing restart semantics, SURVEY.md §7.4.5).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Optional

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def find_free_base_port(span: int, *, tries: int = 128,
                        extra_offsets: tuple = (1000,)) -> int:
    """A base port such that ``base .. base+span-1`` are all bindable
    RIGHT NOW, chosen by asking the OS instead of hand-maintained bump
    lists (the cross-test port-collision flake class: every multiproc
    test file kept its own ``_PORT = [...]`` counter, and two files
    landing on overlapping ranges — or a straggler process from the
    previous test still holding its socket — produced bind failures or,
    worse, frames from a stale run).

    The check binds each port on the wildcard interface (what the bus's
    ``tcp://*:port`` bind uses) and releases it, so a small TOCTOU
    window remains — but the randomized base makes two concurrent
    pickers collide with probability ~span/36000 instead of always, and
    a straggler's held port now FAILS the probe instead of silently
    swallowing frames.

    ``extra_offsets`` probes derived ports too: ``child_env`` hands out
    ``base_port + 1000`` as the coordinator (MINIPS_COORDINATOR), so a
    base whose +1000 neighbor is taken would reintroduce the multihost
    flavor of the very flake this kills."""
    import random
    import socket

    rng = random.Random((os.getpid() << 16) ^ time.monotonic_ns())
    ports = list(range(span)) + list(extra_offsets)  # +1000 = coordinator
    for _ in range(tries):
        base = rng.randrange(20000, 60000 - span - max(extra_offsets,
                                                       default=0))
        socks = []
        try:
            for p in ports:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.bind(("", base + p))
                socks.append(s)
        except OSError:
            continue
        else:
            return base
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(
        f"find_free_base_port: no free {span}-port block after "
        f"{tries} tries")


def read_hostfile(path: str) -> list[str]:
    """One host per line; blank lines and #-comments ignored (reference
    hostfile format)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line)
    return hosts


def bus_addresses(hosts: list[str], base_port: int) -> list[str]:
    """PUB endpoint per process. Same-host processes get consecutive ports
    (colocated deployment, SURVEY.md §1). Local aliases share one port
    counter (a hostfile mixing 'localhost' and '127.0.0.1' is one machine),
    and IPv6 literals get zmq's required brackets."""
    counts: dict[str, int] = {}
    addrs = []
    for h in hosts:
        key = "127.0.0.1" if h in _LOCAL_NAMES else h
        k = counts.get(key, 0)
        counts[key] = k + 1
        ep = f"[{h}]" if ":" in h else h
        addrs.append(f"tcp://{ep}:{base_port + k}")
    return addrs


def bus_endpoint_of(rank: int,
                    addrs: Optional[list[str]] = None) -> Optional[str]:
    """The control-bus endpoint of ``rank`` as the launcher advertised
    it (``MINIPS_BUS_ADDRS``) — how a running rank turns a
    membership-table successor into an ADDRESS without respawn.

    The coordinator-succession audit this encodes: the bus is a FULL
    MESH wired at spawn (every rank binds its own slot and connects to
    all peers from the same env list), so the coordinator role was
    never an endpoint — it is a rank id, and lease succession
    (balance/control_plane.py) changes only that id. Nothing about the
    port plumbing needs renegotiating mid-run. The one genuinely
    rank-0-pinned address, ``MINIPS_COORDINATOR``, is the multi-host
    bootstrap's spawn-time rendezvous and is consumed exactly once at
    startup — a dead rank 0 after initialization does not
    invalidate it. Returns None outside a launched job (or for a rank
    beyond the address space)."""
    if addrs is None:
        addrs = [a for a in os.environ.get("MINIPS_BUS_ADDRS",
                                           "").split(",") if a]
    if 0 <= int(rank) < len(addrs):
        return addrs[int(rank)]
    return None


def child_env(rank: int, hosts: list[str], base_port: int) -> dict[str, str]:
    env = dict(os.environ)
    env["MINIPS_PROC_ID"] = str(rank)
    env["MINIPS_NUM_PROCS"] = str(len(hosts))
    # processes COLOCATED on this rank's host — what host-resource
    # divisions (e.g. native parse threads) should divide by, not the
    # world size. Local aliases normalize to one key (a hostfile mixing
    # 'localhost' and '127.0.0.1' is one machine — same rule as
    # bus_addresses; two would-be leaders would race the shared store).
    def _hkey(h):
        return "127.0.0.1" if h in _LOCAL_NAMES else h

    keys = [_hkey(h) for h in hosts]
    env["MINIPS_LOCAL_PROCS"] = str(keys.count(keys[rank]))
    # my index among those colocated processes (0 = local leader, e.g.
    # the one that parses into the shared-memory sample store)
    env["MINIPS_LOCAL_RANK"] = str(keys[:rank].count(keys[rank]))
    # one id per launcher invocation: namespaces shared-memory segments so
    # a relaunch never attaches to a crashed run's stale store
    env["MINIPS_RUN_ID"] = f"{os.getpid()}"
    env["MINIPS_BUS_ADDRS"] = ",".join(bus_addresses(hosts, base_port))
    env["MINIPS_COORDINATOR"] = f"{hosts[0]}:{base_port + 1000}"
    return env


def _sweep_shm() -> None:
    """Reclaim shared-memory leftovers of DEAD runs before spawning: a
    SIGKILLed job never reaches its atexit/close cleanup, and both the
    sample store's segments (dataset-sized) and the shm bus's ring
    files (ring-sized per link) live in tmpfs — host RAM. Each sweeper
    pid-checks the MINIPS_RUN_ID baked into the file name. The flight
    recorder's default dump dirs (obs/flight.py — small, but also
    keyed by run id in tmp) ride the same hygiene contract."""
    from minips_tpu_torch.comm.shm_bus import \
        sweep_stale_segments as sweep_bus_segments
    from minips_tpu_torch.data.shm_store import sweep_stale_segments
    from minips_tpu_torch.obs.flight import sweep_stale_dirs

    sweep_stale_segments()
    sweep_bus_segments()
    sweep_stale_dirs()


def spawn(hosts: list[str], argv: list[str], base_port: int = 5700,
          stdout=None) -> list[subprocess.Popen]:
    """Spawn one process per host entry; returns live Popen handles."""
    _sweep_shm()
    procs = []
    for rank, host in enumerate(hosts):
        env = child_env(rank, hosts, base_port)
        if host in _LOCAL_NAMES:
            cmd = argv
        else:  # remote: ssh with env inlined (reference ssh-spawn path)
            import shlex
            exports = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in env.items()
                if k.startswith("MINIPS_"))
            cmd = ["ssh", host,
                   exports + " " + " ".join(shlex.quote(a) for a in argv)]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout is not None else None))
    return procs


def wait(procs: list[subprocess.Popen], timeout: Optional[float] = None,
         kill_on_failure: bool = True) -> int:
    """Join all; on first nonzero exit (optionally) terminate the rest and
    return that code. Returns 0 when everyone exited clean."""
    deadline = None if timeout is None else time.monotonic() + timeout
    live = list(procs)
    rc = 0
    while live:
        for p in list(live):
            code = p.poll()
            if code is None:
                continue
            live.remove(p)
            if code != 0 and rc == 0:
                rc = code
                if kill_on_failure:
                    for q in live:
                        q.terminate()
        if deadline is not None and time.monotonic() > deadline:
            for q in live:
                q.kill()
            # reap: SIGKILLed children must not linger as zombies
            for q in live:
                try:
                    q.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            return rc or -signal.SIGKILL
        time.sleep(0.05)
    return rc


# --------------------------------------------------------------- fork spawn
#
# Local smoke/bench jobs spawn O(100) short-lived ranks per test tier, and
# each subprocess rank pays seconds just importing torch before it runs a
# line of app code. The forkserver path preloads torch ONCE in a clean
# server process (started fresh via exec, so no inherited threads from
# the pytest runner) and forks ranks from it in ~100ms; the app module
# itself is imported post-fork from disk, so children run current code
# with the process isolation the drills rely on (own pid, killable with
# SIGKILL). Production spawns (`spawn()`, ssh, ranks on the card) keep
# plain subprocess: a process that has initialized CUDA cannot fork a
# child that uses it, so only ranks pinned to the CPU (MINIPS_FORCE_CPU)
# take the fast path, and the server never touches the device (importing
# minips_tpu_torch initializes no CUDA context; kernels build at first
# use). Opt out with MINIPS_SPAWN=subprocess.

_FORK_CTX = None


def _fork_ctx():
    global _FORK_CTX
    if _FORK_CTX is None:
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        # preloading minips_tpu_torch (not just torch) means ranks fork
        # with the whole framework imported — the app module itself is the
        # only import left post-fork. The package has no import-time state
        # that differs from a fresh import (no module-level pids/uuids/
        # clocks; atexit hooks register at runtime, and the forked rank
        # replays them at exit — see _fork_child_main's finally), so the
        # fork copy behaves like a cold import. Caveat: the server lives
        # for the parent process's lifetime, so code edits between two
        # jobs of ONE parent are invisible to the second job — a fresh
        # pytest/bench invocation gets a fresh server.
        ctx.set_forkserver_preload(["torch", "minips_tpu_torch"])
        _FORK_CTX = ctx
    return _FORK_CTX


def stop_fork_server() -> None:
    """Stop the fork server, if one runs, and wait for it to exit. Left
    alone it ends only once its parent has exited, and then tears torch
    down for a second or so after it; a parent that must leave no process
    running calls this once its jobs are done. A later forked rank starts
    a fresh server."""
    global _FORK_CTX
    if _FORK_CTX is None:
        return
    from multiprocessing import forkserver

    forkserver._forkserver._stop()
    _FORK_CTX = None


def _fork_child_main(argv: list[str], env: dict, out_path: str) -> None:
    """Runs inside the forked rank: adopt the launcher-built env, wire
    stdout+stderr to the harvest file (the smoke protocol reads JSON
    lines from it), then execute ``python -m <module>`` semantics via
    runpy. SystemExit propagates to multiprocessing's bootstrap, which
    maps it to the process exit code exactly like a subprocess would."""
    import runpy

    fd = os.open(out_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.environ.clear()
    os.environ.update(env)
    i = argv.index("-m")
    mod, args = argv[i + 1], argv[i + 2:]
    sys.argv = [mod] + list(args)
    try:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
    finally:
        # multiprocessing's bootstrap leaves via os._exit, which skips
        # atexit — but a subprocess rank WOULD have run its atexit hooks
        # (the shm_store leader's segment unlink registers there, and so
        # do torch's own teardown hooks). Run them explicitly so the fork
        # path keeps subprocess exit semantics; then flush the block-
        # buffered file stdout so the harvester sees the result line.
        import atexit

        try:
            atexit._run_exitfuncs()
        except Exception:
            pass
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass


class _ForkProc:
    """Popen-shaped handle over a forked rank — just enough surface for
    :func:`wait` (poll/terminate/kill/wait) and the drills (.pid)."""

    def __init__(self, proc):
        self._p = proc
        self.pid = proc.pid

    def poll(self):
        return self._p.exitcode  # None while running; -signum on kill

    def terminate(self):
        self._p.terminate()

    def kill(self):
        self._p.kill()

    def wait(self, timeout=None):
        self._p.join(timeout)
        if self._p.exitcode is None:
            raise subprocess.TimeoutExpired(cmd="<forked rank>",
                                            timeout=timeout)
        return self._p.exitcode


def _spawn_rank(argv: list[str], env: dict, outfile):
    """One local rank: forked from the torch-warm server when eligible
    (CPU-pinned, ``python -m`` form), else a plain subprocess."""
    spawn_mode = (env.get("MINIPS_SPAWN")
                  or os.environ.get("MINIPS_SPAWN", "fork"))
    if (spawn_mode != "subprocess"
            and env.get("MINIPS_FORCE_CPU")
            and len(argv) >= 3 and argv[0] == sys.executable
            and argv[1] == "-m"):
        p = _fork_ctx().Process(
            target=_fork_child_main, args=(argv, env, outfile.name))
        p.start()
        return _ForkProc(p)
    return subprocess.Popen(argv, env=env, stdout=outfile,
                            stderr=subprocess.STDOUT)


def run_local_job(n: int, argv: list[str], *,
                  base_port: Optional[int] = None,
                  env_extra: Optional[dict] = None,
                  env_per_rank: Optional[dict] = None,
                  timeout: float = 240.0) -> list[dict]:
    """Spawn ``n`` local ranks of ``argv`` over loopback, wait, and harvest
    the last JSON line each rank printed (the smoke/bench protocol: every
    worker prints one result dict). Raises with the worker's captured
    output if a rank produced no JSON or the job failed — shared by
    tests/test_distributed_smoke.py and bench_ssp.py so the spawn/harvest
    protocol lives in one place. ``base_port=None`` (the default) asks
    the OS for a free block via :func:`find_free_base_port`.
    ``env_per_rank`` maps rank -> extra env for THAT rank only — the
    elastic-membership drills aim per-rank knobs (a joiner's standby
    config, a drain trigger) without giving every rank the flag."""
    import json
    import tempfile

    if base_port is None:
        base_port = find_free_base_port(n)
    _sweep_shm()
    hosts = ["localhost"] * n
    outs = [tempfile.NamedTemporaryFile("w+", delete=False) for _ in hosts]
    procs = []
    for rank in range(n):
        env = child_env(rank, hosts, base_port)
        if env_extra:
            env.update(env_extra)
        if env_per_rank and rank in env_per_rank:
            env.update(env_per_rank[rank])
        procs.append(_spawn_rank(argv, env, outs[rank]))
    rc = wait(procs, timeout=timeout)
    # read EVERY rank's output before judging any single one: the rank
    # that violates the protocol is often an innocent victim (killed by
    # the launcher after the real culprit crashed), so error messages
    # always carry all ranks' tails, not just the first bad one's
    texts = []
    for f in outs:
        f.flush()
        f.seek(0)
        texts.append(f.read())
        f.close()
        os.unlink(f.name)
    raw = "\n".join(f"--- rank {r} output tail ---\n{t[-1200:]}"
                    for r, t in enumerate(texts))
    results = []
    for text in texts:
        lines = []
        last_brace_ok = True
        for ln in text.splitlines():
            if not ln.strip().startswith("{"):
                continue
            try:  # tolerate non-JSON log lines that start with '{'
                lines.append(json.loads(ln))
                last_brace_ok = True
            except json.JSONDecodeError:
                last_brace_ok = False
        if not lines:
            raise RuntimeError(
                f"worker produced no JSON output (rc={rc}):\n{raw}")
        if not last_brace_ok:
            # the FINAL brace line is the result-dict protocol slot; if
            # it is malformed, surfacing an earlier metrics line as the
            # "result" would silently corrupt the harvest
            raise RuntimeError(
                f"worker's final brace line is not JSON (rc={rc}):\n{raw}")
        results.append(lines[-1])
    if rc != 0:
        # a rank can print its done line and STILL exit nonzero (teardown
        # failure); the parsed results alone would hide the traceback
        raise RuntimeError(f"job failed rc={rc}: {results}\n{raw}")
    return results


def run_local_job_raw(n: int, argv: list[str], *,
                      base_port: Optional[int] = None,
                      env_extra: Optional[dict] = None,
                      env_per_rank: Optional[dict] = None,
                      timeout: float = 240.0,
                      kill_on_failure: bool = False,
                      per_rank: bool = False):
    """Spawn ``n`` local ranks and harvest ALL JSON lines per rank,
    tolerating failures — the fault-drill twin of :func:`run_local_job`
    (which asserts success and returns only result lines). Returns
    ``(rc, events)`` with ``events[rank]`` the rank's parsed JSON lines;
    with ``per_rank=True`` the first item is instead every rank's own exit
    code, in rank order (a kill drill checks the victim's and the
    survivor's apart). ``kill_on_failure=False`` by default: kill drills
    need survivors to detect a death THEMSELVES, not be mercy-killed by
    the launcher. ``base_port=None`` auto-picks a free block
    (find_free_base_port); ``env_per_rank`` aims per-rank drill knobs like
    run_local_job's."""
    import json
    import tempfile

    if base_port is None:
        base_port = find_free_base_port(n)
    _sweep_shm()
    hosts = ["localhost"] * n
    outs = [tempfile.NamedTemporaryFile("w+", delete=False) for _ in hosts]
    procs = []
    for rank in range(n):
        env = child_env(rank, hosts, base_port)
        if env_extra:
            env.update(env_extra)
        if env_per_rank and rank in env_per_rank:
            env.update(env_per_rank[rank])
        procs.append(_spawn_rank(argv, env, outs[rank]))
    rc = wait(procs, timeout=timeout, kill_on_failure=kill_on_failure)
    events = []
    for f in outs:
        f.flush()
        f.seek(0)
        text = f.read()
        f.close()
        os.unlink(f.name)
        rank_events = []
        for ln in text.splitlines():
            if ln.strip().startswith("{"):
                try:
                    rank_events.append(json.loads(ln))
                except json.JSONDecodeError:
                    pass  # log lines that merely start with a brace
        events.append(rank_events)
    if per_rank:
        return [p.poll() for p in procs], events
    return rc, events


def init_from_env():
    """Worker-side: build my ControlBus from the launcher's env vars.
    Returns ``(proc_id, num_procs, bus)``; bus is None single-process.
    Backend honors ``$MINIPS_BUS`` (zmq | native C++ mailbox | shm
    same-host rings); head codec honors ``$MINIPS_WIRE_FMT``."""
    from minips_tpu_torch.comm.bus import make_bus

    rank = int(os.environ.get("MINIPS_PROC_ID", "0"))
    n = int(os.environ.get("MINIPS_NUM_PROCS", "1"))
    addrs = [a for a in os.environ.get("MINIPS_BUS_ADDRS", "").split(",") if a]
    if n <= 1 or not addrs:
        return rank, 1, None
    peers = [a for i, a in enumerate(addrs) if i != rank]
    # bind on all interfaces at my advertised port; peers connect by name
    port = addrs[rank].rsplit(":", 1)[1]
    bus = make_bus(f"tcp://*:{port}", peers, my_id=rank).start()
    return rank, n, bus


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="spawn one worker process per hostfile line")
    ap.add_argument("--hostfile", help="one host per line")
    ap.add_argument("--n", type=int, default=0,
                    help="shortcut: n local processes (no hostfile)")
    ap.add_argument("--base-port", type=int, default=5700)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- program args...")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no worker command given (use: -- python worker.py ...)")
    if args.hostfile:
        hosts = read_hostfile(args.hostfile)
    elif args.n > 0:
        hosts = ["localhost"] * args.n
    else:
        ap.error("need --hostfile or --n")
    procs = spawn(hosts, cmd, base_port=args.base_port)
    return wait(procs, timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
