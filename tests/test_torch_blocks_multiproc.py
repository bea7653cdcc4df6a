"""The JAX package's launched block-assignment drills
(``tests/test_blocks_multiproc.py``) on the port through ``port_drills``:
``ssp_lr_example --data-file`` on 3 launched processes, rank 0 the
``BlockMaster``, every rank a ``BlockClient``; under SSP the skew bound
holds and every block is consumed once; a killed rank's blocks re-queue
to the survivors. Slow marks carry over.
"""

from __future__ import annotations

from tests.torch_ref_drills import port_drills

globals().update(port_drills("test_blocks_multiproc.py"))
