"""``idle_share.ctr``: percent of the CTR window's time in which the card
ran no kernel, copy or fill: the device's busy time a step, from the
traced steps, over the window's time a step (``readers.idle_share``)."""

from benchmark import readers

LAYER = "device"
UNIT = "%"
MOVES = "samples_per_s"


def read(record):
    return readers.idle_share(record)
