"""``step_ms_p90``: the 90th percentile of the window's step times, each
between the CUDA events recorded at its two boundaries on the stream: the
stalls a user sees as a slow step (garbage collections, allocator and
host hiccups, update spikes)."""

from benchmark import readers

LAYER = None
UNIT = "ms"
MOVES = None


def read(record):
    return readers.p90(record.window.step_ms)
