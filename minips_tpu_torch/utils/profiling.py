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

``Annotation`` is the program's span and ``count`` its counter. They
record only while a profiler session runs (``profile_trace``,
``StepWindowProfiler``, every app's ``--profile_dir``, or any
``torch.profiler.profile``); otherwise a span costs a flag test and its
host ``totals``, and a counter nothing (its callers test ``tracing()``).
Where they are, by name:

- ``train/ps_step.py`` ``PSTrainStep``: ``ps_step`` (one call),
  ``ps_step.route.<table>`` (the keys and their route: the hash),
  ``ps_step.gather.<table>`` (K1), ``ps_step.loss_grad`` (the dense pull,
  the loss, ``autograd.grad``, the gradient scale), ``ps_step.dense_update``
  (push, updater, ``p + updates``) and ``ps_step.sparse_update.<table>``
  (``to_owners`` and ``row_update``);
- ``ops/sparse_update.py``: ``sparse.dedup`` (argsort and segment sum of
  a sort-dedup push), ``sparse.scatter`` (the dense-accumulate push's
  scratch scatter), and the counters ``sparse.rows`` (a sort-dedup push's
  distinct rows, from the dedup) and ``sparse.entries`` (the length of the
  index its row scatters are issued with, counted where they are);
- ``tables/dense.py`` ``make_step``'s step: ``dense_step`` (one call),
  ``dense_step.pull``, ``dense_step.grad`` (``grad_fn`` with its casts; the
  microbatch loop under ``accum``) and ``dense_step.update`` (from the
  gradient's ravel to the return);
- ``parallel/moe.py`` ``moe_dropless`` (LFM2's MoE layer): ``moe`` (one
  layer's forward), inside it ``moe.route``, ``moe.dispatch`` (sort,
  offsets, the row gather), ``moe.experts`` (the grouped GEMMs and SwiGLU)
  and ``moe.combine``, and the counters ``moe.routes`` (the routes that
  land on held experts) and ``moe.max_load`` (the busiest held expert's
  routes), 0-d device tensors, once a layer a step;
- ``models/transformer.py`` ``_lfm2_conv``: ``conv`` (one gated
  short-conv mixer, in_proj to out_proj).

The LFM2 spans sit inside the remat checkpoint of their layer, so they
record the forward and again its recompute, which autograd's engine runs
in the backward; the rest of the backward runs outside them. The MoE
counters skip the recompute.

A capture shows each span as a ``user_annotation`` on the host and a
``gpu_user_annotation`` on the device. The registry keeps the newest
``RING`` instances of each span (a CUDA event pair on the step's stream,
or host clock readings off the card) and counter (an int, or a 0-d
device tensor kept by reference); ``span_names``, ``span_ms`` and
``counter_sum`` read it once the queue has drained, and ``reset`` empties
it. A span's parent is whichever span's interval holds it. A span's time
is the stream's window between its two events, idle time included, not
the busy time of the kernels inside it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from collections import deque
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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


def tracing() -> bool:
    """True while a ``torch.profiler`` session runs in this process: the
    one switch of the program's spans and counters."""
    return _autograd_profiler._is_profiler_enabled


def _mark(device: DeviceLike):
    """A CUDA event recorded on ``device``'s current stream, or the host
    clock for any other device."""
    if device is not None and torch.device(device).type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(device))
        return e
    return time.perf_counter()


class Annotation:
    """The program's span: a named interval that, while a profiler runs,
    enters ``torch.profiler.record_function`` and records its start and
    end on ``device`` (CUDA events on the current stream, never waited
    for; the host clock off the card) in the registry ``spans``. With or
    without a profiler it adds its host wall time to ``totals``, so hot
    host phases (data loading, checkpoint snapshot) are quantified even
    without a device trace."""

    RING = 1024
    totals: dict[str, float] = {}
    spans: dict[str, deque] = {}
    counters: dict[str, deque] = {}

    def __init__(self, name: str, device: DeviceLike = None):
        self.name = name
        self.device = device

    def __enter__(self):
        self._t0 = time.monotonic()
        self._on = tracing()
        if self._on:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
            self._start = _mark(self.device)
        return self

    def __exit__(self, *exc):
        if self._on:
            end = _mark(self.device)
            self._ann.__exit__(*exc)
            Annotation.spans.setdefault(
                self.name, deque(maxlen=self.RING)).append((self._start, end))
        Annotation.totals[self.name] = (
            Annotation.totals.get(self.name, 0.0)
            + time.monotonic() - self._t0)
        return False


def count(name: str, value: int | torch.Tensor) -> None:
    """Add ``value`` to counter ``name``. Callers call it only under
    ``tracing()``, so that a counter records, and a value that takes a
    kernel is computed, only while a profiler runs. A tensor (0-d) is
    kept as it is and read by ``counter_sum``."""
    Annotation.counters.setdefault(
        name, deque(maxlen=Annotation.RING)).append(value)


def span_names(prefix: str = "") -> list[str]:
    """The recorded span names that begin with ``prefix``, sorted."""
    return sorted(n for n in Annotation.spans if n.startswith(prefix))


def span_ms(name: str) -> list[float]:
    """Each recorded instance of span ``name``, oldest first, in ms: device
    time between its CUDA events (waiting for the end event), or host
    time off the card."""
    out = []
    for start, end in Annotation.spans.get(name, ()):
        if isinstance(start, float):
            out.append(1e3 * (end - start))
        else:
            end.synchronize()
            out.append(start.elapsed_time(end))
    return out


def counter_sum(name: str) -> int:
    """The sum of counter ``name``'s recorded values (0 if none)."""
    return sum(int(v) for v in Annotation.counters.get(name, ()))


def reset() -> None:
    """Empty the registry: spans, counters and ``totals``."""
    Annotation.spans.clear()
    Annotation.counters.clear()
    Annotation.totals.clear()
