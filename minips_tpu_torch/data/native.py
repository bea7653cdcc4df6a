"""ctypes binding for the C++ data-path library (cpp/libsvm_reader.cpp,
cpp/criteo_reader.cpp) — a copy of ``minips_tpu/data/native.py``. These
are host parsers, not device code.

The reference's loaders are native C++ (SURVEY.md §2 "Data loading");
pybind11 is absent in this image so the boundary is a plain C ABI + ctypes
(zero-copy into numpy buffers). The library is built lazily on first use
(one ~1s g++ invocation) and everything degrades to the pure-Python parser
when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from minips_tpu_torch.utils.native_lib import load_native_lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.libsvm_count.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.libsvm_count.restype = ctypes.c_int
    lib.libsvm_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    lib.libsvm_parse.restype = ctypes.c_int
    try:  # a stale .so surviving a failed rebuild lacks these symbols
        lib.criteo_count.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.criteo_count.restype = ctypes.c_int
        lib.criteo_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        lib.criteo_parse.restype = ctypes.c_int
    except AttributeError:
        lib.criteo_count = None
    try:  # multi-threaded parse entry points (chunked, line-aligned);
        # a stale .so predating them raises AttributeError here
        lib.criteo_parse_mt.argtypes = (
            list(lib.criteo_parse.argtypes) + [ctypes.c_int])
        lib.criteo_parse_mt.restype = ctypes.c_int
        lib.libsvm_parse_mt.argtypes = (
            list(lib.libsvm_parse.argtypes) + [ctypes.c_int])
        lib.libsvm_parse_mt.restype = ctypes.c_int
    except AttributeError:
        lib.criteo_parse_mt = None
        lib.libsvm_parse_mt = None
    try:  # in-memory libsvm entry points (parse a bytes chunk)
        lib.libsvm_count_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.libsvm_count_mem.restype = ctypes.c_int
        lib.libsvm_parse_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int64)]
        lib.libsvm_parse_mem.restype = ctypes.c_int
    except AttributeError:
        lib.libsvm_count_mem = None
        lib.libsvm_parse_mem = None
    try:  # in-memory streaming entry points (parse a bytes chunk)
        lib.criteo_count_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.criteo_count_mem.restype = ctypes.c_int
        lib.criteo_parse_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int64)]
        lib.criteo_parse_mem.restype = ctypes.c_int
    except AttributeError:
        lib.criteo_count_mem = None
        lib.criteo_parse_mem = None


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libminips_data.so", _declare)


def _num_threads(threads: Optional[int]) -> int:
    if threads is not None:
        return max(1, threads)
    env = os.environ.get("MINIPS_PARSE_THREADS")
    if env:
        return max(1, int(env))
    # divide the machine between COLOCATED launcher workers (set by
    # launch.child_env; remote hosts in a hostfile don't share cores so
    # the world size would be the wrong divisor), capping after the split
    procs = max(1, int(os.environ.get("MINIPS_LOCAL_PROCS", "1") or 1))
    return max(1, min((os.cpu_count() or 1) // procs, 16))


def read_libsvm_native(path: str, max_features: Optional[int] = None,
                       threads: Optional[int] = None) -> Optional[dict]:
    """Native fast path for data.libsvm.read_libsvm. Returns None when the
    library is unavailable (caller falls back to pure Python). ``threads``
    defaults to min(cpu_count, 16); 1 forces the single-scan path."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    w = ctypes.c_int64()
    if lib.libsvm_count(path.encode(), ctypes.byref(n), ctypes.byref(w)):
        return None  # unreadable file: let the Python path surface the OSError
    rows, width = n.value, w.value
    if max_features is not None:
        width = min(width, max_features)
    width = max(width, 1)
    y = np.zeros(rows, np.float32)
    idx = np.zeros((rows, width), np.int32)
    val = np.zeros((rows, width), np.float32)
    mask = np.zeros((rows, width), np.float32)
    if getattr(lib, "libsvm_parse_mt", None) is not None:
        rc = lib.libsvm_parse_mt(path.encode(), rows, width, y, idx, val,
                                 mask, _num_threads(threads))
    else:
        rc = lib.libsvm_parse(path.encode(), rows, width, y, idx, val, mask)
    if rc != 0:
        raise ValueError(f"libsvm_parse failed with code {rc} on {path}")
    return {"y": y, "idx": idx, "val": val, "mask": mask}


def read_criteo_native(path: str,
                       threads: Optional[int] = None) -> Optional[dict]:
    """Native fast path for data.criteo.read_criteo. Returns None when the
    library is unavailable (caller falls back to pure Python). ``threads``
    defaults to min(cpu_count, 16); 1 forces the single-scan path."""
    from minips_tpu_torch.data.criteo import NUM_CAT, NUM_DENSE

    lib = _load()
    if lib is None or lib.criteo_count is None:
        return None
    n = ctypes.c_int64()
    if lib.criteo_count(path.encode(), ctypes.byref(n)):
        return None  # unreadable file: let the Python path surface the OSError
    rows = n.value
    y = np.zeros(rows, np.float32)
    dense = np.zeros((rows, NUM_DENSE), np.float32)
    dense_mask = np.zeros((rows, NUM_DENSE), np.float32)
    cat = np.zeros((rows, NUM_CAT), np.int64)
    if getattr(lib, "criteo_parse_mt", None) is not None:
        rc = lib.criteo_parse_mt(path.encode(), rows, y, dense, dense_mask,
                                 cat, _num_threads(threads))
    else:
        rc = lib.criteo_parse(path.encode(), rows, y, dense, dense_mask, cat)
    if rc != 0:
        raise ValueError(f"criteo_parse failed with code {rc} on {path}")
    return {"y": y, "dense": dense, "dense_mask": dense_mask, "cat": cat}


def parse_libsvm_bytes(data: bytes, width: int,
                       where: str = "<bytes>") -> Optional[dict]:
    """Parse a libsvm chunk already in memory to the padded block schema
    (fixed ``width``). Returns None when the native library (or the mem
    entry points) is unavailable — the caller falls back to the Python
    line parser. Per-chunk {-1,1}→{0,1} label normalization, matching
    data/libsvm.py ``parse_libsvm_lines``."""
    lib = _load()
    if lib is None or getattr(lib, "libsvm_parse_mem", None) is None:
        return None
    n = ctypes.c_int64()
    if lib.libsvm_count_mem(data, len(data), ctypes.byref(n)):
        return None
    rows = n.value
    y = np.zeros(rows, np.float32)
    idx = np.zeros((rows, width), np.int32)
    val = np.zeros((rows, width), np.float32)
    mask = np.zeros((rows, width), np.float32)
    done = ctypes.c_int64()
    rc = lib.libsvm_parse_mem(data, len(data), rows, width, y, idx, val,
                              mask, ctypes.byref(done))
    if rc != 0 or done.value != rows:
        # rc 3 = malformed line — strict like the Python parser's raise
        raise ValueError(
            f"libsvm_parse_mem parsed {done.value}/{rows} rows "
            f"(rc={rc}) on {where}")
    return {"y": y, "idx": idx, "val": val, "mask": mask}


def native_mem_available() -> bool:
    """True when the in-memory Criteo entry points are loadable (bench and
    tests report which parser actually ran)."""
    lib = _load()
    return lib is not None and getattr(lib, "criteo_parse_mem",
                                       None) is not None


def parse_criteo_bytes(data: bytes,
                       where: str = "<bytes>") -> Optional[dict]:
    """Parse a Criteo TSV chunk already in memory (whole lines). Returns
    None when the native library (or the mem entry points) is
    unavailable; the caller falls back to the Python line parser."""
    from minips_tpu_torch.data.criteo import NUM_CAT, NUM_DENSE

    lib = _load()
    if lib is None or getattr(lib, "criteo_parse_mem", None) is None:
        return None
    n = ctypes.c_int64()
    if lib.criteo_count_mem(data, len(data), ctypes.byref(n)):
        return None
    rows = n.value
    y = np.zeros(rows, np.float32)
    dense = np.zeros((rows, NUM_DENSE), np.float32)
    dense_mask = np.zeros((rows, NUM_DENSE), np.float32)
    cat = np.zeros((rows, NUM_CAT), np.int64)
    done = ctypes.c_int64()
    rc = lib.criteo_parse_mem(data, len(data), rows, y, dense, dense_mask,
                              cat, ctypes.byref(done))
    if rc != 0:
        raise ValueError(
            f"criteo_parse_mem failed with code {rc} on {where}")
    if done.value != rows:
        raise ValueError(
            f"criteo_parse_mem parsed {done.value} of {rows} rows on "
            f"{where}")
    return {"y": y, "dense": dense, "dense_mask": dense_mask, "cat": cat}
