"""Shared-memory sample store — parse once per host, map everywhere.

The reference colocates server and worker threads in ONE process per node
(SURVEY.md §1), so its in-memory sample store is naturally shared by every
worker on the host. The rebuild's launcher starts one *process* per worker
(process isolation is what makes the SSP/fault drills honest), which would
multiply both parse time and resident memory by the colocation factor —
N processes each parsing the same Criteo/libsvm file into N private
copies.

``shared_load`` restores the reference's economics: the host's local
leader (``MINIPS_LOCAL_RANK`` 0) runs the loader once — typically the
native C++ parser (data/native.py) writing straight into files under
/dev/shm — and every colocated process maps the same physical pages
read-only via ``np.memmap``. One parse, one copy of the dataset in host
memory, zero-copy views for all.

Coordination is file-based (atomic rename of a JSON manifest), so it works
before the control bus exists and for bus-less apps. Segments are
namespaced by ``MINIPS_RUN_ID`` (set per launcher invocation) so a
relaunch after a crash never attaches to a stale store; the leader
unlinks its segments at exit (mapped pages survive until the last reader
exits — POSIX semantics).

A copy of ``minips_tpu/data/shm_store.py``, which imports no JAX.
"""

from __future__ import annotations

import atexit
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np

_PREFIX = "minips_shm"
_CLEANUP_GRACE_S = 30.0  # max leader-exit wait for peers to attach


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _names(tag: str, directory: str) -> tuple[str, str]:
    run = os.environ.get("MINIPS_RUN_ID", "solo")
    base = os.path.join(directory, f"{_PREFIX}_{run}_{tag}")
    return base, base + ".manifest.json"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _atomic_write_array(path: str, arr: np.ndarray) -> None:
    """arr.tofile streams the buffer — no tobytes() copy of a
    dataset-sized array on the very host-memory path this store exists
    to relieve."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        arr.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def make_tag(prefix: str, *parts) -> str:
    """Stable cross-process tag from arbitrary key parts (PYTHONHASHSEED
    makes hash() useless here). All colocated callers that pass the same
    parts share one store."""
    import hashlib

    digest = hashlib.md5("|".join(map(repr, parts)).encode()).hexdigest()
    return f"{prefix}_{digest[:12]}"


def sweep_stale_segments(directory: Optional[str] = None) -> int:
    """Delete segments whose run (MINIPS_RUN_ID = launcher pid) is dead.
    A SIGKILLed job never runs its atexit cleanup; without this, every
    crash+relaunch cycle would leave another dataset-sized copy in tmpfs.
    Called by the launcher before spawning. Returns #files removed."""
    directory = directory or _shm_dir()
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    for name in entries:
        if not name.startswith(_PREFIX + "_"):
            continue
        run = name[len(_PREFIX) + 1:].split("_", 1)[0]
        if not run.isdigit():
            continue  # non-pid run id (e.g. tests): not ours to judge
        from minips_tpu_torch.comm.shm_bus import _pid_alive
        if _pid_alive(int(run)):
            continue  # launcher still alive (portable: /proc is
            # Linux-only and this store runs wherever the bus does)
        try:
            os.unlink(os.path.join(directory, name))
            removed += 1
        except OSError:
            pass
    return removed


def shared_load(
    tag: str,
    loader: Callable[[], dict],
    *,
    local_rank: Optional[int] = None,
    local_procs: Optional[int] = None,
    directory: Optional[str] = None,
    timeout: float = 300.0,
    writable_copy: bool = False,
) -> dict:
    """Load ``loader() -> {name: ndarray}`` once per host, share via mmap.

    ``local_rank``/``local_procs`` default to the launcher's
    ``MINIPS_LOCAL_RANK``/``MINIPS_LOCAL_PROCS``; single-process (or
    unlaunched) callers just run the loader directly. The local leader
    materializes each array into a file under /dev/shm and publishes a
    manifest; peers poll for the manifest (up to ``timeout`` — parsing a
    big file takes a while) and return read-only ``np.memmap`` views of
    the same physical pages. ``writable_copy=True`` gives peers private
    copies instead (copy-on-use) when the caller must mutate batches.
    """
    if local_rank is None:
        local_rank = int(os.environ.get("MINIPS_LOCAL_RANK", "0") or 0)
    if local_procs is None:
        local_procs = int(os.environ.get("MINIPS_LOCAL_PROCS", "1") or 1)
    if local_procs <= 1:
        return loader()
    directory = directory or _shm_dir()
    base, manifest_path = _names(tag, directory)

    if local_rank == 0:
        data = loader()
        manifest = {}
        paths = [manifest_path]
        for key, arr in data.items():
            arr = np.ascontiguousarray(arr)
            path = f"{base}.{key}.bin"
            _atomic_write_array(path, arr)
            paths.append(path)
            manifest[key] = {"dtype": arr.dtype.str,
                             "shape": list(arr.shape)}
        _atomic_write(manifest_path, json.dumps(manifest).encode())

        def _cleanup(paths=paths, base=base, n_peers=local_procs - 1,
                     grace=_CLEANUP_GRACE_S):  # captured NOW: atexit runs
            # after test monkeypatches are unwound
            # A leader that finishes quickly must not unlink before slower
            # peers attach (they'd time out on a vanished manifest): wait
            # for the attach markers, bounded so dead peers can't wedge
            # leader shutdown. Mapped pages survive the unlink (POSIX).
            deadline = time.monotonic() + grace
            def attached():
                return sum(os.path.exists(f"{base}.attached.{i}")
                           for i in range(1, n_peers + 1))
            while attached() < n_peers and time.monotonic() < deadline:
                time.sleep(0.05)
            for i in range(1, n_peers + 1):
                paths.append(f"{base}.attached.{i}")
            for p in paths:  # names vanish; peers' mappings stay valid
                try:
                    os.unlink(p)
                except OSError:
                    pass
            # tombstone: a peer arriving after reclamation fails fast with
            # the true story instead of polling out its whole timeout on
            # "leader never published" (tiny file; swept with the run)
            try:
                _atomic_write(base + ".tombstone", b"1")
            except OSError:
                pass

        atexit.register(_cleanup)
        return data

    deadline = time.monotonic() + timeout
    tombstone = base + ".tombstone"
    while not os.path.exists(manifest_path):
        if os.path.exists(tombstone):
            raise RuntimeError(
                f"shared_load({tag!r}): the leader already exited and "
                "reclaimed this store — this process attached too late "
                "(raise the leader-side grace or start peers sooner)")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"shared_load({tag!r}): leader never published "
                f"{manifest_path} within {timeout}s")
        time.sleep(0.05)
    with open(manifest_path, "rb") as f:
        manifest = json.loads(f.read())
    out = {}
    for key, meta in manifest.items():
        mm = np.memmap(f"{base}.{key}.bin", dtype=np.dtype(meta["dtype"]),
                       mode="r", shape=tuple(meta["shape"]))
        out[key] = np.array(mm) if writable_copy else mm
    # tell the leader we hold mappings — it may now unlink the names
    _atomic_write(f"{base}.attached.{local_rank}", b"1")
    return out
