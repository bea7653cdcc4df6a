"""``launch_ms.ctr``: host milliseconds inside the step's two
``PSTrainStep`` calls, with no synchronize: what the host pays to issue a
step, summed over the window and divided by its steps."""

LAYER = "host and engine"
UNIT = "ms"
MOVES = "samples_per_s"


def read(record):
    w = record.window
    return 1e3 * w.launch_s / w.steps if w.steps else None
