"""``mfu.lm``: model flops a token (PaLM appendix B: 6 a matmul parameter
and the causal attention once, no recompute; ``roofline.py``) times the
window's tokens a second, over the bf16 peak, in percent."""

from benchmark import readers, roofline

LAYER = "step: tables/dense.py make_step"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    rate = readers.rate(record, "tokens")
    if (rate is None or "flops_per_token" not in record.work
            or not roofline.has_peaks(record.kind)):
        return None
    return 100.0 * record.work["flops_per_token"] * rate \
        / roofline.PEAK_BF16_FLOPS
