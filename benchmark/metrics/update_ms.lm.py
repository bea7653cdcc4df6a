"""``update_ms.lm``: device ms a step in the LM's table update: the median
over the traced steps of the ``dense_step.update`` span
(``DenseTable.make_step``'s step from the gradient's ravel to its return:
the pad, the push codec, the mean, the clip, Adam and ``params +
updates``). Read from the program's span registry
(``minips_tpu_torch/utils/profiling.py``), which records only while the
traced steps' profiler runs; the median leaves out the one step that the
host's events stretch. A span reads the stream's window between its
two CUDA events, idle time included, not the busy time of its kernels.
None where the program records no such span, or has no registry."""

import statistics

from minips_tpu_torch.utils import profiling

LAYER = "tables and updaters"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(record):
    if not hasattr(profiling, "span_ms"):
        return None
    ms = profiling.span_ms("dense_step.update")
    return statistics.median(ms) if ms else None
