"""Plain reference of ``lfm2-8b-a1b``: the first training steps of
LFM2-8B-A1B on one card's share of its experts.

Written from the configuration (HF's ``lfm2_moe`` equations), in float32
with TF32 off:

- ``h = tok_emb[x]``; each layer of ``layer_types``: ``h += mixer(
  RMSNorm(h))``, then ``h += ffn(RMSNorm(h))``, RMSNorm ``x · rsqrt(mean(
  x²) + eps) · g``;
- the conv mixer: ``[B | C | x] = a in_proj``, ``u = B ⊙ x``, ``c[t] =
  Σ_j w[:, j] ⊙ u[t - L + 1 + j]`` as explicit shifts (zero before t =
  0), ``(C ⊙ c) out_proj``;
- the attention mixer: ``q = a wq``, ``[k | v] = a wkv`` (GQA),
  RMSNorm over the head dim on q and k, half-split RoPE at
  ``rope_theta``, causal softmax at hd^-1/2 in blocks of queries, ``o
  out_proj``;
- the FFN: ``w2(silu(a w1) ⊙ a w3)`` in the leading ``num_dense_layers``;
  after them the MoE: sigmoid scores over all ``published_num_experts``,
  the top ``num_experts_per_tok`` of score + expert bias (a constant
  zero), weights the chosen scores over their sum + 1e-6 times
  ``routed_scaling_factor``, and the held experts' SwiGLUs (``num_experts``
  from ``expert_offset``) as a plain loop over those experts with index
  masks: each held expert's tokens through it, weighted, added to theirs;
- ``norm_f``, the head tied to ``tok_emb``, the mean next-token
  cross-entropy over all B·T tokens;
- Adam with bias correction, eps outside the root, no decay or clipping.

The gradient is summed one sequence at a time; each layer, each block of
queries and each chunk of the head is checkpointed, so that at T 8192 a
sequence's float32 activations fit beside the state. The initial weights
are drawn again from ``torch.Generator(device).manual_seed(seed)`` in the
program's order and scales (the configuration's ``assumed``). Under
``precision="control"`` the bfloat16 matmul inputs are float8, the
float32 router's are bfloat16, and the master weights and both moments
are stored in bfloat16 (``common.py``).

``readings`` returns each step's loss, each leaf's first-gradient norm and
each leaf's change after the steps, the leaves named by their path in the
parameter tree (``tok_emb``, ``norm_f``, ``blocks.3.w13``, ...). Imports
nothing of the program.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import spec

common = spec.load_module(
    os.path.join(spec.HERE, "reference", "common.py"),
    "benchmark_reference_common")
BLOCK_Q = 1024   # queries a block of the attention
HEAD_ROWS = 1024  # positions a chunk of the head


def init(config: dict, seed: int, device) -> dict:
    """The initial weights by leaf path, drawn in the program's order."""
    D, V = config["hidden_size"], config["vocab_size"]
    H, Hk = config["num_attention_heads"], config["num_key_value_heads"]
    hd, L = D // H, config["conv_L_cache"]
    Fd, Fe = config["intermediate_size"], config["moe_intermediate_size"]
    E, held = config["published_num_experts"], config["num_experts"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {"tok_emb": normal(V, D, scale=D ** -0.5)}
    for i, kind in enumerate(config["layer_types"]):
        b = f"blocks.{i}."
        if kind == "conv":
            p[b + "in_proj"] = normal(D, 3 * D, scale=D ** -0.5)
            p[b + "conv"] = normal(D, L, scale=L ** -0.5)
            p[b + "out_proj"] = normal(D, D, scale=D ** -0.5)
        else:
            p[b + "wq"] = normal(D, H * hd, scale=D ** -0.5)
            p[b + "wkv"] = normal(D, 2, Hk * hd, scale=D ** -0.5)
            p[b + "out_proj"] = normal(H * hd, D, scale=(H * hd) ** -0.5)
            p[b + "q_norm"] = torch.ones(hd, device=device)
            p[b + "k_norm"] = torch.ones(hd, device=device)
        if i < config["num_dense_layers"]:
            p[b + "w13"] = normal(D, 2 * Fd, scale=D ** -0.5)
            p[b + "w2"] = normal(Fd, D, scale=Fd ** -0.5)
        else:
            p[b + "router"] = normal(D, E, scale=D ** -0.5)
            p[b + "w13"] = normal(held, D, 2 * Fe, scale=D ** -0.5)
            p[b + "w2"] = normal(held, Fe, D, scale=Fe ** -0.5)
        p[b + "norm1"] = torch.ones(D, device=device)
        p[b + "norm2"] = torch.ones(D, device=device)
    p["norm_f"] = torch.ones(D, device=device)
    return p


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def _rope(x, theta):
    """Half-split rotary embedding of ``x [T, H, hd]`` at positions 0..T-1."""
    T, half = x.shape[0], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, device=x.device,
                                   dtype=torch.float32) / half)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * freq[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _conv(a, p, b, mm):
    T, D = a.shape
    bcx = mm(a, p[b + "in_proj"])
    B_, C, x = bcx[:, :D], bcx[:, D:2 * D], bcx[:, 2 * D:]
    u = B_ * x
    w = p[b + "conv"]
    L = w.shape[1]
    c = torch.zeros_like(u)
    for j in range(L):  # c[t] += w[:, j] u[t - (L - 1 - j)]
        s = L - 1 - j
        c = c + torch.cat([torch.zeros_like(u[:s]), u[:T - s]]) * w[:, j]
    return mm(C * c, p[b + "out_proj"])


def _attn_block(q, k, v, q0, mm):
    """Causal attention of the queries ``q [Hk, g, Tq, hd]`` at positions
    q0.. against ``k``, ``v [Hk, 1, T, hd]``."""
    Tq, T = q.shape[2], k.shape[2]
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    mask = (torch.arange(T, device=q.device)[None, :]
            <= q0 + torch.arange(Tq, device=q.device)[:, None])
    att = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return mm(att, v)


def _attn(a, p, b, config, mm):
    T, D = a.shape
    H, Hk = config["num_attention_heads"], config["num_key_value_heads"]
    hd, eps = D // H, config["norm_eps"]
    q = _rms(mm(a, p[b + "wq"]).view(T, H, hd), p[b + "q_norm"], eps)
    kv = mm(a, p[b + "wkv"].reshape(D, -1)).view(T, 2, Hk, hd)
    k = _rms(kv[:, 0], p[b + "k_norm"], eps)
    v = kv[:, 1]
    q = _rope(q, config["rope_theta"])
    k = _rope(k, config["rope_theta"])
    # [Hk, group, T, hd]: q head h reads kv head h // group
    q = q.permute(1, 0, 2).reshape(Hk, H // Hk, T, hd)
    k = k.permute(1, 0, 2)[:, None]
    v = v.permute(1, 0, 2)[:, None]
    o = torch.cat([checkpoint(_attn_block, q[:, :, q0:q0 + BLOCK_Q], k, v,
                              q0, mm, use_reentrant=False)
                   for q0 in range(0, T, BLOCK_Q)], dim=2)
    return mm(o.reshape(H, T, hd).permute(1, 0, 2).reshape(T, H * hd),
              p[b + "out_proj"])


def _swiglu(x, w13, w2, mm):
    f = w2.shape[0]
    z = mm(x, w13)
    return mm(torch.nn.functional.silu(z[:, :f]) * z[:, f:], w2)


def moe(a, router, w13, w2, config, mm, router_mm, offset=None,
        bias=None):
    """The held experts' part of the MoE layer on ``a [T, D]``: the
    ``w13.shape[0]`` experts from ``offset`` (the configuration's
    ``expert_offset`` by default) of the router's, a plain loop with index
    masks; ``bias`` the expert bias (the configuration's constant zero by
    default)."""
    offset = config["expert_offset"] if offset is None else offset
    s = torch.sigmoid(router_mm(a, router))
    if bias is None:
        bias = torch.zeros(s.shape[-1], device=a.device)
    chosen = torch.topk(s + bias, config["num_experts_per_tok"],
                        dim=-1).indices
    w = torch.gather(s, 1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-6) * config["routed_scaling_factor"]
    out = torch.zeros_like(a)
    for e in range(w13.shape[0]):
        hit = chosen == offset + e                       # [T, k]
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            we = (w * hit).sum(-1)[rows, None]
            out = out.index_add(0, rows,
                                we * _swiglu(a[rows], w13[e], w2[e], mm))
    return out


def _layer(h, p, i, config, precision):
    mm = lambda x, w: common.matmul(x, w, precision)  # noqa: E731
    router_mm = ((lambda x, w: common.to_bf16(x) @ common.to_bf16(w))
                 if precision == "control" else torch.matmul)
    b, eps = f"blocks.{i}.", config["norm_eps"]
    a = _rms(h, p[b + "norm1"], eps)
    if config["layer_types"][i] == "conv":
        h = h + _conv(a, p, b, mm)
    else:
        h = h + _attn(a, p, b, config, mm)
    a = _rms(h, p[b + "norm2"], eps)
    if i < config["num_dense_layers"]:
        return h + _swiglu(a, p[b + "w13"], p[b + "w2"], mm)
    return h + moe(a, p[b + "router"], p[b + "w13"], p[b + "w2"], config,
                   mm, router_mm)


def _head_nll(h, emb, tgt, precision):
    logits = common.matmul(h, emb.T, precision)
    return F.cross_entropy(logits, tgt, reduction="sum")


def sequence_hidden(p: dict, x: torch.Tensor, config: dict,
                    precision: str = "f32") -> torch.Tensor:
    """The final normed hidden state ``[T, D]`` of one sequence ``x [T]``."""
    h = p["tok_emb"][x]
    for i in range(len(config["layer_types"])):
        h = checkpoint(_layer, h, p, i, config, precision,
                       use_reentrant=False)
    return _rms(h, p["norm_f"], config["norm_eps"])


def sequence_nll(p: dict, tokens: torch.Tensor, config: dict,
                 precision: str) -> torch.Tensor:
    """The summed next-token cross-entropy of one sequence ``[T + 1]``."""
    tgt = tokens[1:]
    h = sequence_hidden(p, tokens[:-1], config, precision)
    return sum(checkpoint(_head_nll, h[c:c + HEAD_ROWS], p["tok_emb"],
                          tgt[c:c + HEAD_ROWS], precision,
                          use_reentrant=False)
               for c in range(0, h.shape[0], HEAD_ROWS))


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def readings(config: dict, batches: list[dict], seed: int, device,
             precision: str = "f32") -> dict:
    """The readings of the first ``len(batches)`` steps (see the module
    docstring). ``batches``: the steps' ``{"tokens": [B, T + 1]}``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = config["optimizer"]
    st = lambda x: common.store(x, precision)  # noqa: E731
    p = {k: st(x) for k, x in init(config, seed, device).items()}
    start = {k: x.clone() for k, x in p.items()}
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, first = [], {}
    for t, batch in enumerate(batches, start=1):
        tokens = batch["tokens"]
        n = tokens.shape[0] * (tokens.shape[1] - 1)
        for x in p.values():
            x.requires_grad_()
        total = 0.0
        for row in tokens:  # one sequence's activations at a time
            part = sequence_nll(p, row, config, precision) / n
            part.backward()
            total += float(part.detach())
        losses.append([total])
        with torch.no_grad():
            for k in list(p):
                x = p[k]
                g = x.grad
                m[k] = st((1 - opt["b1"]) * g + opt["b1"] * m[k])
                v[k] = st((1 - opt["b2"]) * g * g + opt["b2"] * v[k])
                mh = m[k] / (1 - opt["b1"] ** t)
                vh = v[k] / (1 - opt["b2"] ** t)
                p[k] = st(x.detach() - opt["lr"] * mh
                          / (torch.sqrt(vh) + opt["eps"]))
                if t == 1:  # the control's as the program's: from m
                    first[k] = _norm(g if precision != "control" else
                                     common.grad_from_adam_m(m[k], opt["b1"]))
                del x, g  # the old leaf and its gradient go now
    return {"loss": losses, "grad": first,
            "delta": {k: _norm(p[k] - start[k]) for k in p}}
