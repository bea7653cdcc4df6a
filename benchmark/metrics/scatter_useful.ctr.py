"""``scatter_useful.ctr``: percent of the entries that the CTR's
sort-dedup row scatters are issued with that update a distinct row (the
rest add zero to row 0): the program's counters ``sparse.rows`` (each
push's distinct rows, from its dedup) over ``sparse.entries`` (the length
of the index the row scatters are issued with, counted where they are),
summed over the traced pushes. Read from the program's registry
(``minips_tpu_torch/utils/profiling.py``), which counts only while the
traced steps' profiler runs. None where the program counts no such push,
or has no registry."""

from minips_tpu_torch.utils import profiling

LAYER = "tables and updaters"
UNIT = "%"
MOVES = "samples_per_s"


def read(record):
    if not hasattr(profiling, "counter_sum"):
        return None
    entries = profiling.counter_sum("sparse.entries")
    if not entries:
        return None
    return 100.0 * profiling.counter_sum("sparse.rows") / entries
