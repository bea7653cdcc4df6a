"""BSP / SSP / ASP consistency — a copy of ``minips_tpu/consistency``
(host-side clock bookkeeping, no JAX): the controllers and tracker the
threaded Engine gates on, and the multi-process admission rule of
``consistency/gate.py`` (``admits``, ``publish_clock``, ``StalenessGate``
and its ``PeerFailureError`` / ``FencedOutError``), which records into
this package's ``obs`` tracer and flight recorder."""

from minips_tpu_torch.consistency.tracker import PendingBuffer, ProgressTracker  # noqa: F401
from minips_tpu_torch.consistency.controllers import (  # noqa: F401
    ASP,
    BSP,
    SSP,
    ConsistencyController,
    make_controller,
)
from minips_tpu_torch.consistency.gate import (  # noqa: F401
    RETIRED_CLOCK,
    FencedOutError,
    PeerFailureError,
    StalenessGate,
    admits,
    publish_clock,
)
