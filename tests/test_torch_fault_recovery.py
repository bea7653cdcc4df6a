"""The JAX package's fault drills (``tests/test_fault_recovery.py``) run
on the port through ``port_drills``: 3 launched ``ssp_lr_example``
processes, rank 2 killed at step 15, the survivors' heartbeat detection
(exit 42, ``peer_failure``), the relaunch with ``--resume`` from the
newest checkpoint to the end with agreeing replicas; and the same drill
on the port's MF ``--exec multiproc`` with its shard checkpoints. Slow
marks carry over.
"""

from __future__ import annotations

from tests.torch_ref_drills import port_drills

globals().update(port_drills("test_fault_recovery.py"))
