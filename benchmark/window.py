"""The measured window and the traced steps after it.

Each step boundary is marked with a CUDA event recorded on the stream,
which never blocks the host; the window's rate takes all of its work over
all of its time on the host clock, from a drained queue to a drained queue.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

# The profiler has missed the first ~0.1 s of device events after it starts
# in a long-lived process on the H100, so it is readied first, this many
# one-element adds run and the card idles before the capture opens, and the
# capture opens on a short idle (the repo's utils/profiling.py does the
# same, where it was measured).
WARMUP_KERNELS = 1024
SETTLE_S = 1.0
EDGE_S = 0.2


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """Step-boundary marks: CUDA events on the card, the host clock
    elsewhere (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        """Each step's time, in ms (after the queue has drained)."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


@dataclass
class Window:
    steps: int
    seconds: float
    step_ms: list[float]
    launch_s: float  # host time spent inside the step calls
    losses: list = field(repr=False, default_factory=list)


def measure(program, seconds: float, device: torch.device) -> Window:
    """Run ``program.step()`` until ``seconds`` have passed on the host
    clock, then drain the queue: every step issued is in the window."""
    clock = StepClock(device)
    losses, launch = [], 0.0
    sync(device)
    t0 = time.perf_counter()
    clock.mark()
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        losses.append(program.step())
        launch += time.perf_counter() - a
        clock.mark()
    sync(device)
    total = time.perf_counter() - t0
    return Window(len(losses), total, clock.step_ms(), launch, losses)


def trace(program, steps: int, device: torch.device, *,
          host: bool = True) -> str:
    """Profile ``steps`` more steps; returns the path of the gzipped Chrome
    trace, in a fresh directory under the temporary directory (the caller
    removes it). ``host`` False on the card records the device's activity
    alone, without the host's operator events and their cost."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda and not host else
            [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                      else []))
    prof = profile(activities=acts)
    sync(device)
    prof.prepare_trace()
    if cuda:
        warm = torch.zeros(1, device=device)
        for _ in range(WARMUP_KERNELS):
            warm.add_(1)
        sync(device)
        time.sleep(SETTLE_S)
    prof.start_trace()
    try:
        if cuda:
            time.sleep(EDGE_S)
        for _ in range(steps):
            program.step()
        sync(device)
    finally:
        prof.stop_trace()
    path = os.path.join(tempfile.mkdtemp(prefix="bench-trace-"),
                        "window.pt.trace.json.gz")
    prof.export_chrome_trace(path)
    return path
