"""``idle_share.lfm2``: percent of the LFM2 window's time in which the
card ran no kernel, copy or fill: the device's busy time a step, from the
traced steps, over the window's time a step (``readers.idle_share``)."""

from benchmark import readers

LAYER = "device"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    return readers.idle_share(record)
