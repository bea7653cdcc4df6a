"""Arithmetic the metric readers share (``benchmark/metrics/``). A reader
takes the run's record: ``setup_s``, ``window`` (``steps``, ``seconds``,
``step_ms``, ``launch_s``), ``units`` (what a step does, e.g.
``{"tokens": 8192}``), ``trace`` (``devtrace.summarize`` of the traced
steps, and their count as ``steps``; None untraced), ``work`` (the
family's ``work()``, traced runs only) and ``kind`` (the card's name). A
reader that finds nothing to read returns None."""

from __future__ import annotations

import statistics

from benchmark import devtrace


def rate(record, unit: str):
    """``unit`` a second over the whole window."""
    per_step = record.units.get(unit)
    if per_step is None or not record.window.steps:
        return None
    return per_step * record.window.steps / record.window.seconds


def p90(values: list[float]):
    """The 90th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def idle_share(record):
    """Percent of the measured window's time in which the device ran
    nothing: 100 less the device's busy time a traced step (from the
    trace) over the window's time a step (the host clock, untraced). The
    traced steps' own length is not the denominator: the profiler's cost
    on the host lengthens a host-bound step's gaps."""
    tr, w = record.trace, record.window
    if not tr or tr["busy_s"] <= 0 or not w.steps:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / (w.seconds / w.steps))


def kernel_roofline(record, bound_s: float, *needles: str):
    """Percent: ``bound_s`` (the least time of the kernels' work over the
    traced steps) over their summed device time."""
    if not record.trace:
        return None
    n, secs = devtrace.kernel_seconds(record.trace, *needles)
    if not n or secs <= 0:
        return None
    return 100.0 * bound_s / secs
