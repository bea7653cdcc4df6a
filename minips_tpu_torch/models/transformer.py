"""Decoder-only transformer LM — the port of ``minips_tpu/models/transformer.py``
(the single-program path).

Plain-tree params like the other models, so the whole LM lives in one
``DenseTable``: pre-LN blocks, learned positional embeddings (or RoPE), a
GELU MLP, a weight-tied head. Matmuls run in ``compute_dtype`` (bf16 by
default) with float32 params; the residual stream turns float32 after the
first block's attention projection, exactly where the JAX package casts.
Attention is ``reference`` (plain O(T^2) scores) or ``flash`` (K2–K4 on the
card, their plain versions on the CPU).

Not ported here: dropout > 0 (its masks come from ``jax.random``, which
torch cannot replay; it waits for an RNG contract of its own), the
selective remat modes ``"attn"``, ``"dots"``, ``"hybrid"`` and
``"hybrid_qkv"``, and the sequence-, tensor-, pipeline- and
expert-parallel variants (``apply_sp``, ``apply_tp``, ``apply_pp``, the MoE
LM, ``sp_train_wiring``). ROADMAP.md queue 1 lists each.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.parallel.ring_attention import reference_attention
from minips_tpu_torch.utils.tree import tree_map, value_and_grad


def init(gen: torch.Generator, *, vocab: int = 256, dim: int = 64,
         heads: int = 4, depth: int = 2, max_len: int = 1024,
         mlp_mult: int = 4, kv_heads: Optional[int] = None,
         rope: bool = False, device: DeviceLike = None):
    """The JAX package's ``init`` tree and scales, drawn from ``gen`` (a
    ``torch.Generator`` on ``device``): ``kv_heads < heads`` builds the
    grouped-query layout (``wq`` and a fused ``wkv`` [dim, 2, kv width]),
    otherwise one fused ``qkv`` [dim, 3, dim]; ``rope=True`` has no
    ``pos_emb``. torch draws other numbers than ``jax.random``: parity
    tests carry the JAX package's weights across instead."""
    device = resolve_device(device)
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")
    gqa = kv_heads is not None and kv_heads != heads
    if gqa and (kv_heads < 1 or heads % kv_heads):
        raise ValueError(f"kv_heads {kv_heads} must be >= 1 and divide "
                         f"heads {heads}")
    hd = dim // heads
    if rope and hd % 2:
        raise ValueError(f"rope needs an even head dim (dim/heads = {hd})")

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def ln():
        return {"g": torch.ones(dim, device=device),
                "b": torch.zeros(dim, device=device)}

    scale = dim ** -0.5
    params = {"tok_emb": normal(vocab, dim, scale=scale), "ln_f": ln(),
              "blocks": []}
    if not rope:
        params["pos_emb"] = normal(max_len, dim, scale=scale)
    for _ in range(depth):
        blk = {"ln1": ln(), "ln2": ln(),
               "proj": normal(dim, dim, scale=scale),
               "mlp_in": normal(dim, mlp_mult * dim, scale=scale),
               "mlp_out": normal(mlp_mult * dim, dim,
                                 scale=(mlp_mult * dim) ** -0.5)}
        if gqa:
            blk["wq"] = normal(dim, dim, scale=scale)
            blk["wkv"] = normal(dim, 2, kv_heads * hd, scale=scale)
        else:
            blk["qkv"] = normal(dim, 3, dim, scale=scale)
        params["blocks"].append(blk)
    return params


def _ln(x, p):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)  # jnp.var: population
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _block(h, blk, heads, attn_fn, compute_dtype):
    """One pre-LN block: attention, then :func:`_block_tail`."""
    B, T, _ = h.shape
    x = _ln(h, blk["ln1"]).to(compute_dtype)
    # q/k/v stay in compute_dtype: the kernels run their dots at the input
    # type with float32 sums
    if "wkv" in blk:
        q = x @ blk["wq"].to(compute_dtype)
        wkv = blk["wkv"].to(compute_dtype)
        kv = (x @ wkv.reshape(wkv.shape[0], -1)).view(B, T, 2, -1)
        hd = q.shape[-1] // heads
        q = q.view(B, T, heads, hd)
        k = kv[:, :, 0].reshape(B, T, -1, hd)
        v = kv[:, :, 1].reshape(B, T, -1, hd)
    else:
        w = blk["qkv"].to(compute_dtype)
        qkv = (x @ w.reshape(w.shape[0], -1)).view(B, T, 3, -1)
        hd = qkv.shape[-1] // heads
        q, k, v = (qkv[:, :, i].reshape(B, T, heads, hd) for i in range(3))
    a = attn_fn(q, k, v).reshape(B, T, -1)
    return _block_tail(h, blk, a, compute_dtype)


def _block_tail(h, blk, a, compute_dtype):
    """Output projection + residual, then MLP + residual; the residual
    stream turns float32 here."""
    att = (a.to(compute_dtype) @ blk["proj"].to(compute_dtype)).float()
    h = h + att
    x = _ln(h, blk["ln2"]).to(compute_dtype)
    z = x @ blk["mlp_in"].to(compute_dtype)
    x = F.gelu(z, approximate="tanh")   # jax.nn.gelu's default
    m = (x @ blk["mlp_out"].to(compute_dtype)).float()
    return h + m


def _check_remat(remat):
    if remat is True or remat is False:
        return
    if remat in ("attn", "dots", "hybrid", "hybrid_qkv"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP.md queue 1: the "
            "selective remat modes); remat=True recomputes whole blocks")
    raise ValueError(f"unknown remat mode {remat!r} (expected True/False, "
                     "'attn', 'dots', 'hybrid' or 'hybrid_qkv')")


def _check_dropout(dropout):
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout rate {dropout} outside [0, 1)")
    if dropout:
        raise NotImplementedError(
            "dropout > 0 is not ported yet (ROADMAP.md queue 1: dropout "
            "needs an RNG contract of its own; jax.random masks cannot be "
            "replayed in torch)")


def _forward(params, tokens, pos, heads, attn_fn, compute_dtype, remat=False,
             head=True, dropout=0.0):
    """Logits ``[B, T, vocab]`` float32, or with ``head=False`` the final
    normed hidden state (the chunked-CE path applies the tied head
    itself). ``remat=True`` wraps each block in ``torch.utils.checkpoint``
    so the backward recomputes it."""
    _check_remat(remat)
    _check_dropout(dropout)
    if "pos_emb" in params:
        max_len = params["pos_emb"].shape[0]
        if pos.shape[0] > max_len:
            raise ValueError(f"sequence length {pos.shape[0]} exceeds the "
                             f"model's max_len {max_len}")
        h = params["tok_emb"][tokens] + params["pos_emb"][pos]
    else:
        h = params["tok_emb"][tokens]
        attn_fn = _rope_wrap(attn_fn, pos)
    for blk in params["blocks"]:
        if remat:
            h = checkpoint(_block, h, blk, heads, attn_fn, compute_dtype,
                           use_reentrant=False)
        else:
            h = _block(h, blk, heads, attn_fn, compute_dtype)
    h = _ln(h, params["ln_f"])
    if not head:
        return h
    return (h.to(compute_dtype)
            @ params["tok_emb"].T.to(compute_dtype)).float()


def decay_mask(params):
    """Params-shaped 0/1 tree for AdamW's decoupled weight decay: 1 on
    matrices (ndim >= 2), 0 on LayerNorm gains and biases."""
    return tree_map(lambda x: torch.full_like(x, float(x.dim() >= 2)),
                    params)


def rope_rotate(x, pos, theta: float = 10000.0):
    """Rotary position embedding on ``x`` ``[B, T, H, hd]`` at GLOBAL
    positions ``pos`` ``[T]``: half-split pairs rotated by
    ``pos · theta^(-2i/hd)``, angles in float32, the product in x's type."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_wrap(attn_fn, pos):
    """Attention with RoPE applied to Q and K (never V)."""
    return lambda q, k, v: attn_fn(rope_rotate(q, pos), rope_rotate(k, pos),
                                   v)


def _attn_fn(attn_impl: str):
    """Causal attention by name: ``reference`` (plain scores) or ``flash``
    (K2–K4 on the card, their plain versions on the CPU)."""
    if attn_impl == "flash":
        from minips_tpu_torch.ops.flash_attention import flash_attention

        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    if attn_impl != "reference":
        raise ValueError(f"unknown attn_impl {attn_impl!r} "
                         "(expected 'reference' or 'flash')")
    return lambda q, k, v: reference_attention(q, k, v, causal=True)


def apply(params, tokens, *, heads=4, compute_dtype=torch.bfloat16,
          remat=False, attn_impl="reference", dropout=0.0):
    """Logits ``[B, T, vocab]``; plain causal attention in one program."""
    T = tokens.shape[1]
    return _forward(params, tokens, torch.arange(T, device=tokens.device),
                    heads, _attn_fn(attn_impl), compute_dtype, remat=remat,
                    dropout=dropout)


def nll(logits, targets):
    """Mean next-token negative log-likelihood."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets[..., None])[..., 0])


def _chunk_nll_sum(hc, tok_emb, tc, compute_dtype):
    logits = (hc.to(compute_dtype) @ tok_emb.T.to(compute_dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tc[..., None]).sum()


def nll_chunked(h, tok_emb, targets, chunk, compute_dtype=torch.bfloat16):
    """Tied head + cross-entropy over sequence chunks of ``chunk``: each
    chunk's logits exist only inside its ``torch.utils.checkpoint`` (the
    backward recomputes them), the chunk sums add in float32, and the total
    divides by B·T — the full ``[B, T, vocab]`` logits never exist."""
    B, T, _ = h.shape
    if T % chunk:
        raise ValueError(f"seq len {T} must divide by head chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, h[:, c0:c0 + chunk], tok_emb,
            targets[:, c0:c0 + chunk], compute_dtype, use_reentrant=False)
    return total / (B * T)


def loss(params, batch, *, heads=4, compute_dtype=torch.bfloat16,
         attn_impl="reference", remat=False, head_chunk=0, dropout=0.0):
    """Next-token cross-entropy; ``batch = {"tokens": [B, T+1]}`` integer
    ids. ``head_chunk > 0`` takes the tied head and the CE in sequence
    chunks (:func:`nll_chunked`)."""
    toks = batch["tokens"].long()
    if head_chunk:
        T = toks.shape[1] - 1
        h = _forward(params, toks[:, :-1],
                     torch.arange(T, device=toks.device), heads,
                     _attn_fn(attn_impl), compute_dtype, remat=remat,
                     head=False, dropout=dropout)
        return nll_chunked(h, params["tok_emb"], toks[:, 1:], head_chunk,
                           compute_dtype)
    logits = apply(params, toks[:, :-1], heads=heads,
                   compute_dtype=compute_dtype, attn_impl=attn_impl,
                   remat=remat, dropout=dropout)
    return nll(logits, toks[:, 1:])


def grad_fn(params, batch, *, heads=4, attn_impl="reference", remat=False,
            head_chunk=0, dropout=0.0):
    """``(loss, grads)`` of :func:`loss` at its bf16 compute type, as the
    JAX package's ``grad_fn``. Under ``DenseTable.make_step(compute_dtype=
    bf16)`` the leaves it differentiates are the bf16 copies, as in JAX."""
    return value_and_grad(lambda p: loss(
        p, batch, heads=heads, attn_impl=attn_impl, remat=remat,
        head_chunk=head_chunk, dropout=dropout), params)
