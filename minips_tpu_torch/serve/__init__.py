"""Read-mostly serving plane for the sharded PS — the port of
``minips_tpu/serve/``, which imports no JAX.

Snapshot-consistent hot-range read replicas, lease/epoch invalidation
riding the rebalance fence machinery, per-owner token-bucket admission
with a replica shed path, SLO latency gates over the obs/ log2
histograms (:mod:`minips_tpu_torch.serve.plane`,
:mod:`minips_tpu_torch.serve.admission`), and the hedged-pull config
(``MINIPS_HEDGE``, :mod:`minips_tpu_torch.serve.hedge`).

Env-gated via ``MINIPS_SERVE`` (off by default); protocol walkthrough
and the staleness argument: docs/serving.md.
"""

from minips_tpu_torch.serve.admission import TokenBucket
from minips_tpu_torch.serve.plane import (ServeConfig, ServePlane,
                                          TableServeState)

__all__ = ["ServeConfig", "ServePlane", "TableServeState", "TokenBucket"]
