"""Checkpointing — the port of ``minips_tpu/ckpt/``: the native npz
backend (``checkpoint.py``) and the factory the apps and the Engine call.

The JAX package's second backend, Orbax, maps to
``torch.distributed.checkpoint`` with the multi-host port (ROADMAP.md
queue 1 item 16), and ``convert_checkpoint`` between the two backends
with it.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from minips_tpu_torch.ckpt.checkpoint import Checkpointer
from minips_tpu_torch.parallel.mesh import Group


def make_checkpointer(directory: str, tables: dict[str, Any],
                      controllers: Optional[dict[str, Any]] = None,
                      *, keep: int = 3, async_save: bool = False,
                      backend: Optional[str] = None,
                      group: Group = None) -> Checkpointer:
    """``backend`` = "native" (npz dirs, the default), from
    ``$MINIPS_CKPT_BACKEND`` when not given. "orbax" is not ported yet.
    ``group``: the process group the tables are sharded over (rank 0
    writes, every rank restores); ``None`` is one device."""
    backend = backend or os.environ.get("MINIPS_CKPT_BACKEND", "native")
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend is not ported yet (ROADMAP.md "
            "queue 1 item 16: it maps to torch.distributed.checkpoint); "
            "use backend='native'")
    if backend != "native":
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'native' or 'orbax')")
    return Checkpointer(directory, tables, controllers, keep=keep,
                        async_save=async_save, group=group)
