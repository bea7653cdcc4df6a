"""``experts_roofline.lfm2``: the expert grouped GEMMs of the step
(``parallel/moe.py``'s ``torch._grouped_mm`` over the held routes, forward
and backward, and a remat recompute's forward), by kernel name in the
trace: their least time over their summed device time, in percent. The
least time: a step's ``lfm2_work.expert_gemm_work`` at the routes the
program counted (``moe.routes`` over the recorded steps), times the traced
steps, over the bf16 peak or the memory rate, whichever bounds it. None
where the program counts no routes, or the trace holds no such kernel."""

from benchmark import lfm2_work, readers, roofline
from minips_tpu_torch.utils import profiling

LAYER = "kernel: parallel/moe.py expert grouped GEMMs"
UNIT = "%"
MOVES = "tokens_per_s"
# the grouped GEMM kernels torch._grouped_mm launches on the H100
KERNELS = ("GroupProblemShape",)


def read(record):
    tr, work = record.trace, record.work
    if (not tr or "experts" not in work or not roofline.has_peaks(record.kind)
            or not hasattr(profiling, "counter_sum")):
        return None
    steps = lfm2_work.recorded_steps(profiling)
    routes = profiling.counter_sum("moe.routes")
    if not steps or not routes:
        return None
    e = work["experts"]
    flops, nbytes = lfm2_work.expert_gemm_work(routes / steps, e["d"], e["f"],
                                               e["held"])
    bound = tr["steps"] * roofline.least_seconds(flops, nbytes)
    return readers.kernel_roofline(record, bound, *KERNELS)
