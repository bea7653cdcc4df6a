"""Plain reference of ``gpt2-xl``: the first training steps of GPT-2 XL.

Written from the configuration, in float32 with TF32 off:

- ``h = wte[x] + wpe[pos]``;
- each of ``n_layer`` pre-LN blocks: ``a = LN1(h)``, ``[q|k|v] = a W_attn``
  (``n_head`` heads of ``n_embd / n_head``), causal softmax attention
  scaled by ``hd^-1/2``, ``h += o W_proj``; then ``h += gelu_tanh(LN2(h)
  W_fc) W_mlp`` (``gelu_new``); no biases on the linear layers (the
  configuration's departure), LayerNorm with ``layer_norm_epsilon``;
- ``LN_f``, the head tied to ``wte``, and the mean next-token
  cross-entropy over all B·T tokens;
- Adam with bias correction, eps outside the root, no decay or clipping.

The gradient is summed one sequence at a time, so that the activations of
one sequence are alive at once. The initial weights are drawn again from
``torch.Generator(device).manual_seed(seed)`` in the configuration's order
and scales (``wte``, ``wpe``, then each block's ``proj``, ``mlp_in``,
``mlp_out`` and ``qkv``; LayerNorm gains 1 and biases 0). Under
``precision="control"`` the matmul and attention inputs are float8 and the
master weights and both moments are stored in bfloat16 (``common.py``).

``readings`` returns each step's loss, each leaf's first-gradient norm and
each leaf's change after the steps, the leaves named by their path in the
parameter tree (``tok_emb``, ``pos_emb``, ``ln_f.g``, ``blocks.3.qkv``, ...).
Imports nothing of the program.
"""

from __future__ import annotations

import math
import os

import torch

from benchmark import spec

common = spec.load_module(
    os.path.join(spec.HERE, "reference", "common.py"),
    "benchmark_reference_common")


def init(config: dict, seed: int, device) -> dict:
    """The initial weights by leaf path, drawn in the configuration's
    order."""
    d, v, L = config["n_embd"], config["vocab_size"], config["n_layer"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    s = d ** -0.5
    p = {"tok_emb": normal(v, d, scale=s),
         "pos_emb": normal(config["n_positions"], d, scale=s),
         "ln_f.g": torch.ones(d, device=device),
         "ln_f.b": torch.zeros(d, device=device)}
    for i in range(L):
        b = f"blocks.{i}."
        p[b + "proj"] = normal(d, d, scale=s)
        p[b + "mlp_in"] = normal(d, 4 * d, scale=s)
        p[b + "mlp_out"] = normal(4 * d, d, scale=(4 * d) ** -0.5)
        p[b + "qkv"] = normal(d, 3, d, scale=s)
        for ln in ("ln1", "ln2"):
            p[b + ln + ".g"] = torch.ones(d, device=device)
            p[b + ln + ".b"] = torch.zeros(d, device=device)
    return p


def _ln(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def sequence_nll(p: dict, tokens: torch.Tensor, config: dict,
                 precision: str) -> torch.Tensor:
    """The summed next-token cross-entropy of one sequence ``[T + 1]``."""
    mm = lambda a, b: common.matmul(a, b, precision)  # noqa: E731
    d, H = config["n_embd"], config["n_head"]
    eps = config["layer_norm_epsilon"]
    hd = d // H
    x, tgt = tokens[:-1], tokens[1:]
    T = x.shape[0]
    h = p["tok_emb"][x] + p["pos_emb"][:T]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(config["n_layer"]):
        b = f"blocks.{i}."
        a = _ln(h, p[b + "ln1.g"], p[b + "ln1.b"], eps)
        qkv = mm(a, p[b + "qkv"].reshape(d, 3 * d)).view(T, 3, H, hd)
        q, k, v = (qkv[:, j].transpose(0, 1) for j in range(3))
        s = mm(q, k.transpose(1, 2)) * hd ** -0.5
        att = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
        o = mm(att, v).transpose(0, 1).reshape(T, d)
        h = h + mm(o, p[b + "proj"])
        a = _ln(h, p[b + "ln2.g"], p[b + "ln2.b"], eps)
        z = torch.nn.functional.gelu(mm(a, p[b + "mlp_in"]),
                                     approximate="tanh")
        h = h + mm(z, p[b + "mlp_out"])
    h = _ln(h, p["ln_f.g"], p["ln_f.b"], eps)
    logits = mm(h, p["tok_emb"].T)
    return torch.nn.functional.cross_entropy(logits, tgt, reduction="sum")


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
