"""KV-cached autoregressive decoding for the LM — the port of
``minips_tpu/models/decode.py``: prefill the prompt in one forward, then
single-token steps over a KV cache of fixed size.

- The cache is per block ``{"k", "v"}`` of shape ``[B, max_T, Hk, hd]``,
  ``Hk`` the model's KV head count: a grouped-query model's cache is
  smaller by the group factor.
- ``_cached_block`` serves both phases: prefill runs it on the whole
  prompt, a decode step on one token. Each call writes its K/V rows into
  the cache at ``pos_off`` and attends over the whole cache under the mask
  ``k_pos <= q_pos``, and the rest of the block is the training block's
  own ``_block_tail``.
- Positions are global, learned ``pos_emb`` rows or RoPE, as in training:
  greedy decoding equals the argmax of ``transformer.apply`` on the
  growing sequence.

The JAX package computes this attention with einsums (no Pallas kernel),
so the port uses torch ops; a Python loop replaces its ``lax.scan``, and
the step positions are host integers. MoE blocks are refused, as there.
"""

from __future__ import annotations

from typing import Optional

import torch

from minips_tpu_torch.models.transformer import _block_tail, _ln, rope_rotate

_NEG_INF = -1e30
# the block weights that enter a matmul, cast once per generate call
_MATRICES = ("qkv", "wq", "wkv", "proj", "mlp_in", "mlp_out")


def _head_dims(params, heads):
    dim = params["tok_emb"].shape[1]
    hd = dim // heads
    blk0 = params["blocks"][0]
    if "moe" in blk0:
        raise ValueError("decode does not support MoE blocks")
    hk = blk0["wkv"].shape[2] // hd if "wkv" in blk0 else heads
    return hd, hk


def init_cache(params, batch: int, max_len: int, *, heads: int = 4,
               dtype=torch.bfloat16) -> list:
    """Zeroed per-block KV cache ``[B, max_len, Hk, hd]`` on the params'
    device. ``dtype`` is the cache's storage type; the softmax runs in
    float32 whatever it is."""
    hd, hk = _head_dims(params, heads)
    if "pos_emb" in params and max_len > params["pos_emb"].shape[0]:
        raise ValueError(
            f"max_len {max_len} exceeds the learned positional table "
            f"({params['pos_emb'].shape[0]} rows); use a rope model for "
            "unbounded decode")
    dev = params["tok_emb"].device
    return [{"k": torch.zeros((batch, max_len, hk, hd), dtype=dtype,
                              device=dev),
             "v": torch.zeros((batch, max_len, hk, hd), dtype=dtype,
                              device=dev)}
            for _ in params["blocks"]]


def _cached_block(h, blk, cache, pos_off: int, heads, rope, compute_dtype):
    """One block over ``T_cur`` new positions from ``pos_off``: writes
    their K/V rows into ``cache`` (in place) and attends over the whole
    cache, masked to ``k_pos <= q_pos``. Returns ``(h, cache)``."""
    B, T_cur, D = h.shape
    x = _ln(h, blk["ln1"]).to(compute_dtype)
    if "wkv" in blk:
        q = x @ blk["wq"].to(compute_dtype)
        wkv = blk["wkv"].to(compute_dtype)
        kv = (x @ wkv.reshape(wkv.shape[0], -1)).view(B, T_cur, 2, -1)
        k_new, v_new = kv[:, :, 0], kv[:, :, 1]
    else:
        w = blk["qkv"].to(compute_dtype)
        qkv = (x @ w.reshape(w.shape[0], -1)).view(B, T_cur, 3, -1)
        q, k_new, v_new = (qkv[:, :, i] for i in range(3))
    hd = D // heads
    hk = k_new.shape[-1] // hd
    g = heads // hk
    q = q.reshape(B, T_cur, heads, hd)
    k_new = k_new.reshape(B, T_cur, hk, hd)
    v_new = v_new.reshape(B, T_cur, hk, hd)
    pos = pos_off + torch.arange(T_cur, device=h.device)
    if rope:
        q = rope_rotate(q, pos)
        k_new = rope_rotate(k_new, pos)  # rotated rows enter the cache
    ck, cv = cache["k"], cache["v"]
    ck[:, pos_off:pos_off + T_cur] = k_new.to(ck.dtype)
    cv[:, pos_off:pos_off + T_cur] = v_new.to(cv.dtype)

    # grouped attention over the whole cache, masked to the live prefix:
    # q [B, T_cur, Hk, g, hd] x cache [B, max_T, Hk, hd]; the scores are
    # compute-type products summed in float32 (preferred_element_type=f32),
    # laid out [B, Hk, g, T_cur, max_T] so that the softmax runs along rows
    qg = q.reshape(B, T_cur, hk, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     ck.to(compute_dtype).float()) * (hd ** -0.5)
    keep = (torch.arange(ck.shape[1], device=h.device)[None, :]
            <= pos[:, None])                                 # [T_cur, max_T]
    p = torch.softmax(torch.where(keep, s, _NEG_INF), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(compute_dtype),
                     cv.to(compute_dtype))
    h, _ = _block_tail(h, blk, o.reshape(B, T_cur, D), compute_dtype)
    return h, cache


def _logits_cached(params, head_w, tokens, caches, pos_off: int, heads,
                   compute_dtype):
    rope = "pos_emb" not in params
    pos = pos_off + torch.arange(tokens.shape[1], device=tokens.device)
    h = params["tok_emb"][tokens]
    if not rope:
        h = h + params["pos_emb"][pos]
    for blk, cache in zip(params["blocks"], caches):
        h, _ = _cached_block(h, blk, cache, pos_off, heads, rope,
                             compute_dtype)
    h = _ln(h, params["ln_f"])
    return (h.to(compute_dtype) @ head_w).float()


def forward_cached(params, tokens, caches, pos_off: int, *, heads: int = 4,
                   compute_dtype=torch.bfloat16):
    """Logits for ``tokens [B, T_cur]`` at global positions ``pos_off ..
    pos_off + T_cur - 1``, attending to every earlier position through
    ``caches``, which it updates in place. Returns ``(logits [B, T_cur,
    vocab] float32, caches)``."""
    if "pos_emb" in params and \
            caches[0]["k"].shape[1] > params["pos_emb"].shape[0]:
        raise ValueError(
            f"cache capacity {caches[0]['k'].shape[1]} exceeds the "
            f"learned positional table ({params['pos_emb'].shape[0]} "
            "rows); use a rope model for unbounded decode")
    if not 0 <= pos_off <= caches[0]["k"].shape[1] - tokens.shape[1]:
        raise ValueError(f"positions {pos_off}..{pos_off + tokens.shape[1]}"
                         f" do not fit the cache of "
                         f"{caches[0]['k'].shape[1]}")
    return (_logits_cached(params, params["tok_emb"].T.to(compute_dtype),
                           tokens, caches, pos_off, heads, compute_dtype),
            caches)


@torch.no_grad()
def generate(params, prompt, steps: int, *, heads: int = 4,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
    """Prefill ``prompt [B, T_p]`` in one forward, then ``steps``
    single-token steps. ``temperature=0`` is greedy (the argmax of
    ``transformer.apply`` on the growing sequence); otherwise each token is
    drawn from ``softmax(logits / temperature)`` with ``generator`` (a
    ``torch.Generator`` on the prompt's device). The block matrices are
    cast to ``compute_dtype`` once for the call. Returns ``[B, steps]``
    tokens in the prompt's type."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a "
                         "torch.Generator")
    B, T_p = prompt.shape
    caches = init_cache(params, B, T_p + steps, heads=heads,
                        dtype=cache_dtype)
    params = {**params, "blocks": [
        {k: (v.to(compute_dtype) if k in _MATRICES else v)
         for k, v in blk.items()} for blk in params["blocks"]]}
    head_w = params["tok_emb"].T.to(compute_dtype)

    def pick(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt.dtype)

    last = _logits_cached(params, head_w, prompt, caches, 0, heads,
                          compute_dtype)[:, -1]
    toks = []
    for i in range(steps):
        toks.append(pick(last))
        if i + 1 < steps:  # the last token's logits are never read
            last = _logits_cached(params, head_w, toks[-1][:, None], caches,
                                  T_p + i, heads, compute_dtype)[:, -1]
    return torch.stack(toks, dim=1) if toks else prompt[:, :0]
