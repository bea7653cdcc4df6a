"""BSP / SSP / ASP consistency controllers — a copy of
``minips_tpu/consistency`` (host-side clock bookkeeping, no JAX). The SPMD
gate (``consistency/gate.py``) is not carried over yet: it needs the
``obs`` flight recorder and tracer (ROADMAP.md queue 1 item 14)."""

from minips_tpu_torch.consistency.tracker import PendingBuffer, ProgressTracker  # noqa: F401
from minips_tpu_torch.consistency.controllers import (  # noqa: F401
    ASP,
    BSP,
    SSP,
    ConsistencyController,
    make_controller,
)
