"""``flash_roofline.lm``: K2, K3 and K4 (``ops/flash_attention.py``) in the
step: the sum over their launches in the trace of each launch's least time
(causal live pairs at 4·D, 6·D and 8·D flops, or its bytes, whichever
bounds it) over their summed device time, in percent."""

from benchmark import devtrace, readers, roofline

LAYER = "kernel: ops/flash_attention.py K2-K4"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    tr, work = record.trace, record.work
    if (not tr or "flash_flops_bytes" not in work
            or not roofline.has_peaks(record.kind)):
        return None
    bound = 0.0
    for name, (flops, nbytes) in work["flash_flops_bytes"].items():
        n, _ = devtrace.kernel_seconds(tr, name)
        bound += n * roofline.least_seconds(flops, nbytes)
    return readers.kernel_roofline(record, bound, *work["flash_flops_bytes"])
