"""Logistic regression — the port of ``minips_tpu/models/lr.py``.

Plain functions over dicts of tensors: a dense form (``X [B, D]`` against
a dense weight table) and a sparse form (gathered per-feature weights
``[B, F, 1]`` with values and a pad mask).
"""

from __future__ import annotations

import torch

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.utils.tree import value_and_grad


def init(dim: int, bias: bool = True, *, device: DeviceLike = None):
    device = resolve_device(device)
    p = {"w": torch.zeros(dim, dtype=torch.float32, device=device)}
    if bias:
        p["b"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def logits_dense(params, X):
    out = X @ params["w"]
    if "b" in params:
        out = out + params["b"]
    return out


def bce_with_logits(logits, y):
    """Numerically stable binary cross entropy, y in {0, 1}:
    ``mean(logaddexp(0, x) - y * x)``. ``logaddexp`` and not
    ``F.softplus``, whose linear cut-over at 20 changes the values."""
    return torch.mean(torch.logaddexp(torch.zeros_like(logits), logits)
                      - y * logits)


def loss_dense(params, batch):
    return bce_with_logits(logits_dense(params, batch["x"]), batch["y"])


def grad_fn_dense(params, batch):
    """(loss, grads) for ``DenseTable.make_step`` and the threaded apps."""
    return value_and_grad(lambda p: loss_dense(p, batch), params)


def logits_sparse(w_rows, vals, mask, bias=0.0):
    """w_rows [B, F, 1] gathered weights; vals [B, F] feature values;
    mask [B, F] 1 for real features, 0 for padding."""
    return torch.sum(w_rows[..., 0] * vals * mask, dim=-1) + bias


def loss_sparse(w_rows, batch, bias=0.0):
    return bce_with_logits(
        logits_sparse(w_rows, batch["val"], batch["mask"], bias), batch["y"])
