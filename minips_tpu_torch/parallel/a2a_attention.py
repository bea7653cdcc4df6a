"""All-to-all (Ulysses-style) sequence parallelism — the port of
``minips_tpu/parallel/a2a_attention.py``, ring attention's twin.

One all-to-all re-shards q/k/v from sequence-sharded ``[B, T/n, H, D]``
to head-sharded over the whole sequence ``[B, T, H/n, D]``; each rank
runs a single-device attention on its head group (``reference_attention``,
or the port's ``flash_attention``: K2–K4 on the card); one all-to-all
brings the output back. Two collectives per attention whatever n; the
heads must divide by n. RoPE is applied to the sequence shards before the
exchange, at their global positions. With fewer kv heads than ranks
(``Hk % n``), K/V are expanded to the full head count before the exchange.
Gradients flow back through the exchanges' backward (the inverse
exchange).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from minips_tpu_torch.ops.flash_attention import _expand_kv
from minips_tpu_torch.parallel.mesh import Group, all_to_all_axes, world
from minips_tpu_torch.parallel.ring_attention import reference_attention


def a2a_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group: Group, causal: bool = False,
                        scale: Optional[float] = None,
                        inner: Optional[Callable] = None) -> torch.Tensor:
    """Per-rank body: q/k/v ``[B, T_local, H, D]`` are this rank's sequence
    shards; returns this rank's shard of full attention over the gathered
    sequence, in q's type. ``inner(q, k, v, causal=, scale=)`` runs on the
    head-sharded whole sequence, with ``causal`` and ``scale`` always
    passed; the default is the float32 ``reference_attention``."""
    n = world(group)[1]
    H, Hk = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(
            f"a2a sequence parallelism needs heads ({H}) divisible by the "
            f"group size ({n}) — head-group sharding")
    if Hk % n:
        k, v = _expand_kv(q, k, v)  # the wire grows from Hk to H heads
    if inner is None:
        inner = reference_attention

    def to_heads(x):  # [B, T/n, h, D] -> [B, T, h/n, D]
        return all_to_all_axes(x, group, split_axis=2, concat_axis=1)

    out = inner(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                scale=scale)
    # [B, T, H/n, D] -> [B, T/n, H, D]
    return all_to_all_axes(out, group, split_axis=1,
                           concat_axis=2).to(q.dtype)
