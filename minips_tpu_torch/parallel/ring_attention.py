"""Ring attention — the port of ``minips_tpu/parallel/ring_attention.py``:
sequence-parallel exact attention over a ``torch.distributed`` group.

The sequence axis of Q/K/V is sharded over the group's ranks: rank ``r``
keeps its Q shard, and the K/V shards rotate around the ring with
:func:`~minips_tpu_torch.parallel.mesh.ppermute` (n − 1 hops on an n-way
ring). Attention accumulates with the online softmax (running max ``m``,
normaliser ``l``, accumulator ``o``, all float32 whatever the input type),
so the result equals full attention on the gathered sequence with O(T/n)
K/V per rank. The causal mask comes from global positions: Q rows on rank
``r`` cover ``[r·Tq, (r+1)·Tq)``, and after ``s`` hops a rank holds the
K/V shard of rank ``(r − s) mod n``. Whole blocks that the mask hides
still compute and add nothing, as in the JAX package. Gradients flow back
around the ring through ``ppermute``'s backward.

``reference_attention`` is the O(T^2) oracle behind
``attn_impl="reference"``. The ring with the flash kernels doing each
step is ``ops/flash_attention.py:ring_flash_attention_local``.
"""

from __future__ import annotations

from typing import Optional

import torch

from minips_tpu_torch.ops.flash_attention import NEG_INF, _expand_kv
from minips_tpu_torch.parallel.mesh import Group, ppermute, world


def _online_block(o, m, l, q, k, v, mask, scale):
    """Fold one K/V block into the float32 ``(o, m, l)`` state.
    q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]``, mask ``[Tq, Tk]`` or None;
    the scores and ``P·V`` in float32 (the JAX package keeps bf16 operands
    with float32 sums; here the operands are cast first)."""
    s = torch.einsum("bqhd,bkhd->bqkh", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, :, :, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=2))
    p = torch.exp(s - m_new[:, :, None, :])
    if mask is not None:
        p = torch.where(mask[None, :, :, None], p, 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=2)
    o = o * alpha[..., None] + torch.einsum("bqkh,bkhd->bqhd", p, v.float())
    return o, m_new, l


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, group: Group, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Per-rank body: q/k/v ``[B, T_local, H, D]`` are this rank's shards
    of the sequence (k/v may carry fewer heads, GQA). Returns this rank's
    ``[B, T_local, H, D]`` of full attention over the gathered sequence,
    in q's type. Every rank of ``group`` calls it together; ``None`` is a
    ring of one."""
    r, n = world(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Tq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Tq, H), dtype=torch.float32, device=q.device)
    q_pos = r * Tq + torch.arange(Tq, device=q.device)
    for step in range(n):
        mask = None
        if causal:
            src = (r - step) % n  # the rank whose shard is visiting
            k_pos = src * Tk + torch.arange(Tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        # GQA: expand the visiting shard only; the rotation carries the
        # kv heads
        k_exp, v_exp = _expand_kv(q, k, v)
        o, m, l = _online_block(o, m, l, q, k_exp, v_exp, mask, scale)
        if step < n - 1:
            k, v = ppermute(k, group), ppermute(v, group)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def make_ring_attention(group: Group, *, causal: bool = False,
                        scale: Optional[float] = None):
    """Sequence-parallel attention over ``group``: ``attn(q, k, v)`` on this
    rank's shards; ``attn.shard(x)`` cuts this rank's shard of a whole
    ``[B, T, ...]`` tensor along T."""
    r, n = world(group)

    def attn(q, k, v):
        return ring_attention_local(q, k, v, group=group, causal=causal,
                                    scale=scale)

    def shard(x):
        t = x.shape[1] // n
        return x[:, r * t:(r + 1) * t]

    attn.shard = shard
    return attn


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
