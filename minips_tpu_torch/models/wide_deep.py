"""Wide&Deep and DeepFM pieces — the port of
``minips_tpu/models/wide_deep.py``.

Criteo rows: 13 dense numeric fields + 26 categorical fields. The wide
part is per-feature scalar weights from a hashed SparseTable (dim 1), the
embeddings are ``[B, 26, k]`` rows of another, and the deep part is an MLP
over ``[dense_13 ; flattened embeddings]``.
"""

from __future__ import annotations

import torch

from minips_tpu_torch.models import lr as _lr
from minips_tpu_torch.models import mlp as _mlp
from minips_tpu_torch.parallel.mesh import DeviceLike


def init_deep(generator: torch.Generator, num_fields: int = 26,
              emb_dim: int = 8, num_dense: int = 13, hidden=(256, 128), *,
              device: DeviceLike = None):
    """The deep MLP (+ output head) as one dict for a DenseTable. Input =
    dense features + flattened embeddings."""
    in_dim = num_dense + num_fields * emb_dim
    return _mlp.init(generator, (in_dim,) + tuple(hidden) + (1,),
                     device=device)


def fm_term(emb_rows):
    """Second-order FM interaction from field embeddings [B, F, k]:
    0.5 * sum_k ((sum_f v)^2 - sum_f v^2)."""
    s = torch.sum(emb_rows, dim=1)
    s2 = torch.sum(emb_rows * emb_rows, dim=1)
    return 0.5 * torch.sum(s * s - s2, dim=-1)


def logits(wide_rows, emb_rows, deep_params, batch, *, use_fm: bool):
    """wide_rows [B, F_tot, 1]; emb_rows [B, 26, k]; batch["dense"] [B, 13].
    use_fm=False is Wide&Deep, True is DeepFM."""
    B = emb_rows.shape[0]
    wide = torch.sum(wide_rows[..., 0], dim=-1)
    deep_in = torch.cat([batch["dense"], emb_rows.reshape(B, -1)], dim=-1)
    deep = _mlp.apply(deep_params, deep_in)[:, 0]
    out = wide + deep
    if use_fm:
        out = out + fm_term(emb_rows)
    return out


def loss(wide_rows, emb_rows, deep_params, batch, *, use_fm: bool = False):
    return _lr.bce_with_logits(
        logits(wide_rows, emb_rows, deep_params, batch, use_fm=use_fm),
        batch["y"])
