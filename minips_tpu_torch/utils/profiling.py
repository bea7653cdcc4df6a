"""Profiling hooks — ``torch.profiler`` made first-class (SURVEY.md §5.1).

The port of ``minips_tpu/utils/profiling.py``. The reference has only
glog-timestamped iteration timers; on the card the real tool is
``torch.profiler`` (Kineto over CUPTI): it records every host operator and
every kernel, copy and fill the device ran, with microsecond durations.
Because the primary metric is samples/sec per device, profiling is not an
afterthought: ``StepWindowProfiler`` wraps a window of training steps, and
``TrainLoop`` exposes it via ``profile_dir``/``profile_range``.

A capture is written as a gzipped Chrome trace,
``<log_dir>/<host>_<pid>.<n>.pt.trace.json.gz``, which
``utils/trace_analysis.py`` summarizes and ``obs/merge.py --xla``
interleaves with the wire traces. Unlike the reference, a profiler that
fails to start or to export raises: a silent no-op would leave the
analysis reading an older capture.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from typing import Iterator, Optional

import torch

from minips_tpu_torch.parallel.mesh import DeviceLike

# In a long-lived process the profiler has missed the device events of the
# first ~0.1 s after it starts on the H100 (the first 13 and 15 of 16
# flash kernels; in a process ~12 minutes old, 16 one-element adds, a
# 0.1 s idle and the whole first step of a window after them; in a fresh
# one, nothing). So on the card the profiler is readied first and this
# many one-element adds run and the card idles for _CUDA_SETTLE_S before
# the capture window opens, which keeps them out of the trace, and the
# window opens on another _CUDA_EDGE_S of idle.
_CUDA_WARMUP_KERNELS = 1024
_CUDA_SETTLE_S = 1.0
_CUDA_EDGE_S = 0.2
_seq = itertools.count()


def _on_cuda(device: DeviceLike) -> bool:
    """CUDA activity is recorded for a CUDA ``device``, and for ``None``
    whenever CUDA is available: the profiler observes whatever runs and
    runs nothing itself."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def profile_trace(log_dir: str, device: DeviceLike = None
                  ) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (CPU activity, and CUDA activity on the card, with input shapes) and
    yield the profiler. On exit the card is synchronized, so every kernel
    the block queued is in the capture, and the trace is exported as a
    gzipped Chrome trace under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _on_cuda(device)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, record_shapes=True)
    if cuda:
        torch.cuda.synchronize()  # work queued before the block stays out
    prof.prepare_trace()
    if cuda:
        warm = torch.zeros(1, device=device if device is not None
                           else "cuda")
        for _ in range(_CUDA_WARMUP_KERNELS):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(_CUDA_SETTLE_S)
    prof.start_trace()
    try:
        if cuda:
            time.sleep(_CUDA_EDGE_S)
        yield prof
    finally:
        # written on an error too: the steps before it are the evidence
        if cuda:
            torch.cuda.synchronize()
        prof.stop_trace()
        name = f"{socket.gethostname()}_{os.getpid()}.{next(_seq)}"
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"{name}.pt.trace.json.gz"))


class StepWindowProfiler:
    """Trace exactly the steps in [start, stop) — skipping the early
    steps that load kernels, warm the allocator and autotune the GEMMs,
    which would drown the steady-state timeline. ``profile`` is the
    ``torch.profiler`` of the last window closed (None before)."""

    def __init__(self, log_dir: str, start: int, stop: int):
        if stop <= start:
            raise ValueError("profile window must be non-empty")
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self.profile: Optional[torch.profiler.profile] = None
        self._open: Optional[torch.profiler.profile] = None
        self._ctx: Optional[contextlib.AbstractContextManager] = None

    def on_step(self, step: int) -> None:
        """Call once per step with the 0-based step index (before work)."""
        if step == self.start and self._ctx is None:
            self._ctx = profile_trace(self.log_dir)
            self._open = self._ctx.__enter__()
        elif step == self.stop and self._ctx is not None:
            self.close()

    def close(self) -> None:
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(None, None, None)
            self.profile = self._open


class Annotation:
    """Named host-side span that also shows up in profiler traces via
    ``torch.profiler.record_function``; accumulates wall time per name so
    hot host phases (data loading, checkpoint snapshot) are quantified
    even without a device trace."""

    totals: dict[str, float] = {}

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.monotonic()
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        self._ann.__exit__(*exc)
        Annotation.totals[self.name] = (
            Annotation.totals.get(self.name, 0.0)
            + time.monotonic() - self._t0)
        return False
