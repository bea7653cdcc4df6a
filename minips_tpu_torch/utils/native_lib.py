"""Shared lazy build-and-load of the C++ runtime libraries under cpp/ —
a copy of ``minips_tpu/utils/native_lib.py``, which finds the repo's
``cpp/`` from this file's own path (two packages up).

Both native modules (data readers, control-plane mailbox) follow the same
protocol: invoke ``make -C cpp`` on first use (a no-op when fresh, a
rebuild when sources are newer than a stale .so), serialized across
processes by an flock (the launcher starts several local workers at once;
without it two g++ runs can interleave writes to the .so while a third
dlopens the torso), then dlopen and let the caller declare prototypes.
Everything degrades to ``None`` (callers fall back to Python/zmq paths)
when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional

REPO_CPP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "cpp")
_lock = threading.Lock()
_cache: dict[str, Optional[ctypes.CDLL]] = {}


def load_native_lib(
    lib_filename: str,
    declare: Callable[[ctypes.CDLL], None],
) -> Optional[ctypes.CDLL]:
    """Build (lazily, flock-serialized) and load ``cpp/build/<lib_filename>``.
    ``declare(lib)`` sets argtypes/restypes; it may raise AttributeError for
    optional symbols it handles itself. Returns None when the library can
    neither be built nor found (cached — one attempt per process)."""
    with _lock:
        if lib_filename in _cache:
            return _cache[lib_filename]
        lib_path = os.path.join(REPO_CPP, "build", lib_filename)
        try:
            os.makedirs(os.path.join(REPO_CPP, "build"), exist_ok=True)
            import fcntl

            with open(os.path.join(REPO_CPP, "build", ".lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                subprocess.run(["make", "-C", REPO_CPP], check=True,
                               capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(lib_path):
                _cache[lib_filename] = None
                return None
        try:
            lib = ctypes.CDLL(lib_path)
            declare(lib)
        except OSError:
            _cache[lib_filename] = None
            return None
        _cache[lib_filename] = lib
        return lib
