"""``mfu.ctr``: the CTR step's least time (the larger of its flops over the
bf16 peak and its bytes over the memory rate, ``roofline.py``) over its
time in the window, in percent."""

from benchmark import roofline

LAYER = "step: train/ps_step.py PSTrainStep"
UNIT = "%"
MOVES = "samples_per_s"


def read(record):
    work, w = record.work, record.window
    if ("step_flops" not in work or not w.steps
            or not roofline.has_peaks(record.kind)):
        return None
    least = roofline.least_seconds(work["step_flops"], work["step_bytes"])
    return 100.0 * least / (w.seconds / w.steps)
