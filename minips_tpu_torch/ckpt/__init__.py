"""Checkpointing — the port of ``minips_tpu/ckpt/``: the native npz
backend (``checkpoint.py``), the ``"orbax"`` backend on
``torch.distributed.checkpoint`` (``orbax_backend.py``), the factory the
apps and the Engine call, and :func:`convert_checkpoint` between the two
backends.
"""

from __future__ import annotations

from typing import Any, Optional

from minips_tpu_torch.ckpt.checkpoint import Checkpointer  # noqa: F401
from minips_tpu_torch.ckpt.orbax_backend import make_checkpointer  # noqa: F401
from minips_tpu_torch.parallel.mesh import Group


def convert_checkpoint(src_dir: str, dst_dir: str, tables: dict,
                       controllers: Optional[dict[str, Any]] = None, *,
                       src_backend: str, dst_backend: str,
                       step: Optional[int] = None,
                       group: Group = None) -> int:
    """Migrate a checkpoint between the native (npz-dir) and orbax (DCP)
    formats: the same content, so a restore through one and a save
    through the other is lossless. ``tables`` (and optional
    ``controllers``) are the live objects whose state carries the
    checkpoint across; their state is overwritten by ``src`` and then
    persisted to ``dst``. Returns the migrated step."""
    src = make_checkpointer(src_dir, tables, controllers,
                            backend=src_backend, group=group)
    step = src.restore(step)
    src.close()
    dst = make_checkpointer(dst_dir, tables, controllers,
                            backend=dst_backend, group=group)
    dst.save(step=step)
    dst.wait()
    dst.close()
    return step
