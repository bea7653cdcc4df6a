"""Word2Vec skip-gram with negative sampling — the port of
``minips_tpu/models/word2vec.py``.

Input ("center") and output ("context") embeddings live in two
SparseTables keyed by vocab id. An example is (center, positive context,
K negatives); the SGNS loss is ``-log σ(u·v⁺) - Σ log σ(-u·v⁻)``. The
negatives are drawn on the host from unigram^0.75 by
:class:`UnigramSampler`, a copy of the JAX package's, which draws the
same ids from the same seed; the device sees fixed-shape [B], [B] and
[B, K] id arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from minips_tpu_torch.utils.tree import value_and_grad


def _softplus(x):
    """``logaddexp(0, x)``, as the JAX package writes it (``F.softplus``
    switches to the identity above 20 and changes the values)."""
    return torch.logaddexp(torch.zeros_like(x), x)


def sgns_loss(center_rows, pos_rows, neg_rows):
    """center [B, k], pos [B, k], neg [B, K, k] -> scalar SGNS loss."""
    pos_score = torch.sum(center_rows * pos_rows, dim=-1)              # [B]
    neg_score = torch.einsum("bk,bnk->bn", center_rows, neg_rows)      # [B, K]
    return torch.mean(_softplus(-pos_score)
                      + torch.sum(_softplus(neg_score), dim=-1))


def grad_fn(center_rows, pos_rows, neg_rows):
    """``(loss, grad_center, grad_pos, grad_neg)`` by autograd, the rows
    the leaves."""
    value, (gc, gp, gn) = value_and_grad(
        lambda rows: sgns_loss(*rows), [center_rows, pos_rows, neg_rows])
    return value, gc, gp, gn


def subsample_frequent(ids: np.ndarray, counts: np.ndarray,
                       t: float = 1e-5, seed: int = 0) -> np.ndarray:
    """Classic w2v frequent-word subsampling: occurrences of word w are
    KEPT with probability ``min(1, sqrt(t / f(w)))``, ``f`` being w's
    relative frequency. ``t`` is 1e-5 for real corpora (1e-3..1e-4 for
    small ones); returns the filtered ``ids``. The same draws as the JAX
    package's from the same seed."""
    if t <= 0:
        return ids
    counts = np.asarray(counts, np.float64)
    freq = counts / counts.sum()
    keep_p = np.minimum(1.0, np.sqrt(t / np.maximum(freq, 1e-300)))
    rng = np.random.default_rng(seed)
    kept = ids[rng.random(ids.shape[0]) < keep_p[ids]]
    if kept.size == 0:
        raise ValueError(
            f"subsample t={t} dropped the whole stream; raise t")
    return kept


class UnigramSampler:
    """Host-side negative sampler over unigram counts^0.75, via a Walker
    alias table: O(vocab) setup, O(1) per draw. The same table and draws
    as the JAX package's from the same seed. Not for sharing between
    threads: each worker builds its own."""

    def __init__(self, counts: np.ndarray, power: float = 0.75, seed: int = 0):
        p = np.asarray(counts, np.float64) ** power
        self._p = p / p.sum()
        self._rng = np.random.default_rng(seed)
        n = len(self._p)
        scaled = self._p * n
        self._prob = np.ones(n)
        self._alias = np.arange(n)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            self._prob[s] = scaled[s]
            self._alias[s] = l
            scaled[l] -= 1.0 - scaled[s]
            (small if scaled[l] < 1.0 else large).append(l)
        # leftovers are 1.0 within float error; keep prob=1 (self-alias)

    def sample(self, shape) -> np.ndarray:
        idx = self._rng.integers(0, len(self._p), size=shape)
        accept = self._rng.random(np.shape(idx)) < self._prob[idx]
        return np.where(accept, idx, self._alias[idx])
