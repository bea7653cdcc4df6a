"""Load balance for the sharded PS (``train/sharded_ps.py``) — the part of
``minips_tpu/balance/`` ported so far: the config layers the trainer's
constructor reads whether or not their layer is armed.

- :mod:`minips_tpu_torch.balance.redistribute`: the planned collective
  redistribution's config (``MINIPS_RESHARD``) and its round planner;
- :mod:`minips_tpu_torch.balance.hier`: the hierarchical push tree's
  config (``MINIPS_HIER``) and its group and leader rules.

The heat accountant, the rebalancer, the coordinator lease, elastic
membership and the autoscaler (``heat``, ``rebalancer``,
``control_plane``, ``membership``, ``autoscaler``) wait for ROADMAP.md
queue 1 item 14.2b; arming them raises ``NotImplementedError``.
"""
