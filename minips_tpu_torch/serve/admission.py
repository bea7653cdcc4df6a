"""Per-owner pull admission: a token bucket on the wire serve path.

The serving plane's load-shedding decision point (docs/serving.md): an
owner under read storm consumes one token per arriving pull REQUEST
(frames, not rows — the per-frame serve cost is what saturates an
owner's receive thread, and rows already have their own byte
accounting). An empty bucket never silently drops the request: the
caller sheds it to a replica (``svS``) or refuses it with an explicit
retry-after (``svB``) — loss of capacity degrades to latency, never to
silence, the same ladder the reliable layer established for loss of
frames.

The bucket is deliberately the classic shape: ``rate`` tokens/sec
refill, ``burst`` capacity, monotonic-clock lazy refill, one lock
(taken on the bus receive thread only; the critical section is a few
float ops). ``rate=0`` disables admission entirely — the bucket always
admits — so arming the serve plane for replicas alone costs the serve
path one attribute check.

Tenancy (tenant/registry.py): with ``MINIPS_TENANT`` armed each
table's ``TableServeState`` builds its bucket from its TENANT's
``rate``/``burst`` — one bucket per tenant, so tenant A's storm can
never drain the tokens tenant B's requests needed. The registry's
``shared=1`` contrast arm hands every table ONE plane-level instance
of this same class instead (the lock already makes it safe to share
across tables on one receive thread); the multi_tenant bench measures
the coupling that re-introduces.

A copy of ``minips_tpu/serve/admission.py``, which imports no JAX.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Lazy-refill token bucket; ``now_fn`` is injectable for tests."""

    def __init__(self, rate: float, burst: int, *, now_fn=time.monotonic):
        if rate < 0:
            raise ValueError("rate must be >= 0 (0 = admission off)")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self._now = now_fn
        self._tokens = self.burst
        self._t_last = now_fn()
        self._lock = threading.Lock()
        self.admitted = 0
        self.denied = 0

    def take(self, n: float = 1.0) -> bool:
        """Consume ``n`` tokens if available; False = shed/refuse."""
        if self.rate <= 0:
            self.admitted += 1  # admission off: everything passes
            return True
        with self._lock:
            now = self._now()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last)
                               * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                self.admitted += 1
                return True
            self.denied += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"admitted": self.admitted, "denied": self.denied,
                    "tokens": round(self._tokens, 2)}
