"""``k1_roofline.ctr``: the row gather K1 (``ops/gather.py``,
``csrc/gather_rows.cu``) where it runs, in the step: its byte bound over
the traced steps (each table's indices read, each distinct row read once,
every gathered row written; both tables) over its summed device time, in
percent."""

from benchmark import readers, roofline

LAYER = "kernel: ops/gather.py K1"
UNIT = "%"
MOVES = "samples_per_s"
KERNELS = ("gather_rows_kernel", "gather_narrow_kernel")


def read(record):
    if (not record.trace or "k1_bytes" not in record.work
            or not roofline.has_peaks(record.kind)):
        return None
    bound = record.work["k1_bytes"] * record.trace["steps"] / roofline.MEM_BW
    return readers.kernel_roofline(record, bound, *KERNELS)
