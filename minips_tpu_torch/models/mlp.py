"""3-layer MLP — the port of ``minips_tpu/models/mlp.py``.

A plain dict of weights (``w{i}`` ``[fan_in, fan_out]``, ``b{i}``) so the
whole tower lives in one DenseTable. ``apply`` computes in bfloat16 by
default with a float32 result, the bias add in bfloat16 too, as the JAX
package does. The matmuls stay ``torch.matmul``: plain products that the
JAX package leaves to XLA, outside any kernel of its own.
"""

from __future__ import annotations

import math

import torch

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.utils.tree import value_and_grad


def init(generator: torch.Generator, sizes=(784, 256, 128, 10), *,
         device: DeviceLike = None):
    """He-initialized weights, zero biases; drawn from ``generator`` on
    the CPU, then moved."""
    device = resolve_device(device)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / fan_in)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(fan_out, dtype=torch.float32,
                                      device=device)
    return params


def apply(params, x, *, compute_dtype=torch.bfloat16):
    h = x.to(compute_dtype)
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers):
        w = params[f"w{i}"].to(compute_dtype)
        h = h @ w + params[f"b{i}"].to(compute_dtype)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h.to(torch.float32)


def loss(params, batch, *, compute_dtype=torch.bfloat16):
    logits = apply(params, batch["x"], compute_dtype=compute_dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(nll)


def grad_fn(params, batch):
    """(loss, grads) of :func:`loss` at its bf16 compute type."""
    return value_and_grad(lambda p: loss(p, batch), params)


def accuracy(params, batch):
    logits = apply(params, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())
