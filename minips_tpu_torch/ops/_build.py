"""Build and load the port's CUDA kernels.

Each ``minips_tpu_torch/csrc/<name>.cu`` has a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/minips_tpu_torch/`` beside the package (a directory
``.gitignore`` lists), then loaded with ``ctypes``. The library's file
name carries a hash of the source and of the headers beside it, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.

``build_all`` starts one ``nvcc`` per missing source, all at once, and
waits for them together, so the build costs the slowest file, not the sum.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "minips_tpu_torch"
# sm_90a, not sm_90: wgmma exists only for the "a" target. No -lcuda: the
# one libcuda function the kernels need (cuTensorMapEncodeTiled, for TMA
# maps) is resolved at run time. -Xptxas -v prints registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from minips_tpu_torch/csrc at first use and need the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to. The hash covers the source and
    every ``csrc/*.cuh`` header beside it (any source may include any of
    them), so that an edited header rebuilds too."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns each newly built source's ``nvcc`` output (``-Xptxas -v``
    prints registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
