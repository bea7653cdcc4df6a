"""``sparse_update_ms.ctr``: device ms a step in the CTR's row updates:
the sum over the ``ps_step.sparse_update.<table>`` spans (each table's
``to_owners`` and ``row_update`` inside ``PSTrainStep``) of each one's
median over the traced steps. Read from the program's span registry
(``minips_tpu_torch/utils/profiling.py``), which records only while the
traced steps' profiler runs; the median leaves out the one step that the
host's events stretch. A span reads the stream's window between its
two CUDA events, idle time included, not the busy time of its kernels.
None where the program records no such span, or has no registry."""

import statistics

from minips_tpu_torch.utils import profiling

LAYER = "tables and updaters"
UNIT = "ms"
MOVES = "samples_per_s"


def read(record):
    if not hasattr(profiling, "span_names"):
        return None
    ms = [profiling.span_ms(n)
          for n in profiling.span_names("ps_step.sparse_update.")]
    ms = [statistics.median(v) for v in ms if v]
    return sum(ms) if ms else None
