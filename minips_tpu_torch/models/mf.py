"""Matrix factorization — the port of ``minips_tpu/models/mf.py``.

Rating r_ui ≈ mu + <[p_u, b_u], [q_i, 1]>: user and item factors live in
two SparseTables keyed by user and item id, the bias riding in the last
factor column, so one row gather per side fetches everything a rating
needs.
"""

from __future__ import annotations

import torch

from minips_tpu_torch.utils.tree import value_and_grad


def predict(u_rows, i_rows, mu: float = 0.0):
    """u_rows, i_rows: [B, k+1] -> [B] predictions ``mu + sum(u * i)``."""
    return mu + torch.sum(u_rows * i_rows, dim=-1)


def loss(u_rows, i_rows, ratings, mu: float = 0.0, reg: float = 0.0):
    """Squared error plus L2 on the touched rows (a per-key PS cannot
    regularize the whole table, so the penalty rides on the pulled rows)."""
    err = predict(u_rows, i_rows, mu) - ratings
    out = torch.mean(err * err)
    if reg > 0.0:
        out = out + reg * (torch.mean(torch.sum(u_rows * u_rows, -1))
                           + torch.mean(torch.sum(i_rows * i_rows, -1)))
    return out


def grad_fn(u_rows, i_rows, batch, mu: float = 0.0, reg: float = 0.02):
    """``(loss, grad_u, grad_i)`` by autograd, the gathered rows the
    leaves."""
    value, (gu, gi) = value_and_grad(
        lambda rows: loss(rows[0], rows[1], batch["rating"], mu, reg),
        [u_rows, i_rows])
    return value, gu, gi
