"""``setup_s``: seconds from the process's start to the first timed step:
imports, the program's build from the seed (and, in a fresh checkout, its
kernels' build), the pool of batches, the checked steps and the warm-up."""

LAYER = None
UNIT = "s"
MOVES = None


def read(record):
    return record.setup_s
