"""Load balance + control plane for the sharded PS (``train/sharded_ps.py``)
— the port of ``minips_tpu/balance/``, which imports no JAX.

Cooperating modules, deliberately separable:

- :mod:`minips_tpu_torch.balance.heat` — decayed per-key-block touch
  counters kept by every owner on its serve path (bounded memory,
  vectorized), the observability that makes range-partition skew
  measurable before it is fixed;
- :mod:`minips_tpu_torch.balance.rebalancer` — the coordinator that
  collects per-shard heat, computes a new block→owner assignment (greedy
  bin-pack with hysteresis) and drives the epoch-fenced online migration
  through the tables' wire protocol (``MINIPS_REBALANCE``);
- :mod:`minips_tpu_torch.balance.redistribute` — the planned collective
  redistribution's config (``MINIPS_RESHARD``) and its round planner;
- :mod:`minips_tpu_torch.balance.membership` — elastic membership over
  the same migration machinery: ranks join, drain, and die without
  killing the job (``MINIPS_ELASTIC``);
- :mod:`minips_tpu_torch.balance.control_plane` +
  :mod:`minips_tpu_torch.balance.autoscaler` — the coordinator as a LEASE
  with deterministic succession and term-fenced broadcasts, and the
  closed-loop autoscaler that drives membership from load signals
  (``MINIPS_AUTOSCALE``);
- :mod:`minips_tpu_torch.balance.hier` — the hierarchical push tree's
  config (``MINIPS_HIER``) and its group and leader rules.

Knob reference in docs/api.md; protocol walkthroughs in
docs/architecture.md and docs/fault_tolerance.md.
"""

from minips_tpu_torch.balance.heat import HeatAccountant
from minips_tpu_torch.balance.rebalancer import (RebalanceConfig,
                                                 Rebalancer,
                                                 plan_assignment)

__all__ = ["HeatAccountant", "RebalanceConfig", "Rebalancer",
           "plan_assignment"]
