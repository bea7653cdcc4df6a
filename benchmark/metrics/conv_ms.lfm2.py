"""``conv_ms.lfm2``: device ms a step inside the program's ``conv`` spans
(``models/transformer.py``'s gated short-conv mixer, in_proj to out_proj;
every conv layer's forward and its remat recompute), the median over the
recorded steps (``lfm2_work.span_ms_per_step``). Read from the program's
span registry (``minips_tpu_torch/utils/profiling.py``), which records
only while the traced steps' profiler runs. A span reads the stream's
window between its two CUDA events, idle time included. None where the
program records no such span, or has no registry."""

from benchmark import lfm2_work
from minips_tpu_torch.utils import profiling

LAYER = "model: LFM2 short-conv mixers and dropless MoE"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(record):
    return lfm2_work.span_ms_per_step(profiling, "conv")
