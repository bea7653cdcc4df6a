"""Device handle for the PyTorch port — the counterpart of
``minips_tpu/parallel/mesh.py``.

The JAX package builds a ``(data, model)`` device mesh and lets GSPMD
place every table shard. This slice of the port runs on one card, so the
mesh collapses to one explicit ``torch.device`` and a world size of 1;
multi-GPU table sharding over NCCL comes in a later slice and keeps the
``data`` axis name.

Every entry point of the port takes ``device=``. Left out, it resolves to
the card, and the call raises when CUDA is absent: nothing quietly runs on
the CPU. Callers that mean the CPU (the parity tests) say so.
"""

from __future__ import annotations

import math
from typing import Union

import torch

DATA_AXIS = "data"
WORLD_SIZE = 1  # one card; the NCCL process group arrives with sharding

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device is refused when CUDA is not
    available, so a missing card is an error, never a CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "minips_tpu_torch runs on a CUDA device by default and CUDA is "
            "not available here; pass device='cpu' to run the plain CPU "
            "versions explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def padded_size(n: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= n (range-partition padding)."""
    return shards * math.ceil(max(n, 1) / shards)
