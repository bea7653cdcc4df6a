"""``expert_load.lfm2``: the held experts' imbalance, 100 x the busiest
held expert's routes x the experts held over the routes that land on held
experts: 100 where every held expert takes the same routes. The program's
counters ``moe.max_load`` and ``moe.routes`` (``parallel/moe.py``, once a
MoE layer a step), summed over the traced steps. Read from the program's
registry (``minips_tpu_torch/utils/profiling.py``), which counts only
while the traced steps' profiler runs. None where the program counts no
routes, or has no registry."""

from minips_tpu_torch.utils import profiling

LAYER = "model: LFM2 short-conv mixers and dropless MoE"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    experts = record.work.get("experts") if record.work else None
    if not experts or not hasattr(profiling, "counter_sum"):
        return None
    routes = profiling.counter_sum("moe.routes")
    if not routes:
        return None
    return 100.0 * profiling.counter_sum("moe.max_load") * experts["held"] \
        / routes
