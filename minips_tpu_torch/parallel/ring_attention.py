"""Plain attention oracle — the port of ``reference_attention`` from
``minips_tpu/parallel/ring_attention.py``.

Only the O(T^2) oracle behind ``attn_impl="reference"`` is ported here;
the ring functions (sequence parallelism over ``torch.distributed``) wait
for ROADMAP.md queue 1 item 13.
"""

from __future__ import annotations

from typing import Optional

import torch

from minips_tpu_torch.ops.flash_attention import NEG_INF, _expand_kv


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain ``softmax(QK^T·scale)V`` on ``[B, T, H, D]``. Scores and the
    softmax run in float32 whatever the input type; the output has q's
    type. K/V with fewer heads (GQA) are repeated up to Q's head count;
    the causal mask is ``-1e30``."""
    D = q.shape[-1]
    k, v = _expand_kv(q, k, v)
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bqkh", q.float(), k.float()) * scale
    if causal:
        T, S = q.shape[1], k.shape[1]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = torch.where(mask[None, :, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=2)
    return torch.einsum("bqkh,bkhd->bqhd", p, v.float()).to(q.dtype)
