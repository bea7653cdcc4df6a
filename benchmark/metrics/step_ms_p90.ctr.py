"""``step_ms_p90.ctr``: the 90th percentile of the CTR window's step
times between CUDA events (the tail the host paces: allocator, update
spikes, host hiccups)."""

from benchmark import readers

LAYER = "step: train/ps_step.py PSTrainStep"
UNIT = "ms"
MOVES = "samples_per_s"


def read(record):
    return readers.p90(record.window.step_ms)
