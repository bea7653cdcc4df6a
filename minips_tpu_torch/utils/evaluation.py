"""Evaluation metrics for the CTR workloads — the port of
``minips_tpu/utils/evaluation.py``: streaming ROC-AUC with the histograms
built on the device.

- ``StreamingAUC`` bucketizes each score batch where the scores lie (on
  the card for the apps' predictions): sigmoid, scale, truncate, clip,
  then one ``index_add_`` per class into float32 batch histograms, which
  fold into float64 host accumulators. State is O(buckets) however many
  samples stream through (one batch's bucket counts stay far below
  float32's 2^24 integer ceiling; the float64 totals stay exact far
  beyond 2^53 samples).
- AUC is computed from the histograms by the rank-sum formula with the
  within-bucket tie correction (pairs in the same bucket count 0.5).
- ``auc_exact`` is the O(n log n) host oracle; ``padded_chunks`` and
  ``evaluate_auc`` stream a dict of arrays through a predictor in chunks
  of one shape. These three are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(x, device) -> torch.Tensor:
    return (x if torch.is_tensor(x)
            else torch.as_tensor(np.asarray(x))).to(device)


def _batch_hists(scores: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, num_buckets: int):
    """Bucketize sigmoid(scores) into [0, 1); per-class batch histograms
    (float32, on the scores' device)."""
    p = torch.sigmoid(scores.to(torch.float32)).reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    weights = weights.reshape(-1).to(torch.float32)
    idx = torch.clamp((p * num_buckets).to(torch.int32), 0, num_buckets - 1)
    zeros = torch.zeros(num_buckets, dtype=torch.float32, device=p.device)
    return (zeros.index_add(0, idx, weights * labels),
            zeros.index_add(0, idx, weights * (1.0 - labels)))


def _auc_from_hists(pos_hist, neg_hist) -> float:
    """Rank-sum AUC over score-ascending buckets with tie correction."""
    cum_neg_below = np.cumsum(neg_hist) - neg_hist
    pairs_won = np.sum(pos_hist * (cum_neg_below + 0.5 * neg_hist))
    total = np.sum(pos_hist) * np.sum(neg_hist)
    return float(pairs_won / total) if total > 0 else 0.5


class StreamingAUC:
    """Accumulate ROC-AUC over score batches with O(buckets) state.

    Scores are LOGITS (mapped through sigmoid internally, which is
    monotonic and therefore AUC-preserving); labels are {0, 1}. Optional
    per-sample weights support padded eval batches (weight 0 = ignore).
    The histograms are built on the device of ``logits`` when it is a
    tensor, else on the CPU.
    """

    def __init__(self, num_buckets: int = 1 << 14):
        if num_buckets < 2:
            raise ValueError(f"need >= 2 buckets, got {num_buckets}")
        self.num_buckets = num_buckets
        self.reset()

    def reset(self) -> None:
        self._pos = np.zeros((self.num_buckets,), np.float64)
        self._neg = np.zeros((self.num_buckets,), np.float64)

    def update(self, logits, labels, weights=None) -> None:
        device = logits.device if torch.is_tensor(logits) else "cpu"
        logits = _as_tensor(logits, device)
        weights = (torch.ones(logits.numel(), device=device)
                   if weights is None else _as_tensor(weights, device))
        pos, neg = _batch_hists(logits, _as_tensor(labels, device), weights,
                                self.num_buckets)
        self._pos += pos.cpu().numpy().astype(np.float64)
        self._neg += neg.cpu().numpy().astype(np.float64)

    @property
    def count(self) -> float:
        return float(self._pos.sum() + self._neg.sum())

    def result(self) -> float:
        return _auc_from_hists(self._pos, self._neg)


def auc_exact(scores, labels) -> float:
    """O(n log n) exact ROC-AUC (rank-sum with midranks for ties) — the
    host oracle for tests and small holdouts."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    s, y = scores[order], labels[order]
    # midranks: average rank within each tied group
    ranks = np.empty_like(s)
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[i:j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[y == 1].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def padded_chunks(data: dict, batch_size: int):
    """Yield ``(chunk, n_valid)`` over dict-of-arrays rows: every chunk is
    repeat-padded to exactly ``batch_size`` rows (padded rows duplicate the
    last valid row and must be masked/sliced out by the consumer via
    ``n_valid``). Shared by ``evaluate_auc`` and the apps' chunked holdout
    scorers."""
    n = int(len(next(iter(data.values()))))
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = batch_size - (hi - lo)

        def cut(v):
            chunk = np.asarray(v)[lo:hi]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
            return chunk

        yield {k: cut(v) for k, v in data.items()}, hi - lo


def evaluate_auc(predict_logits, data: dict, batch_size: int = 8192,
                 label_key: str = "y", num_buckets: int = 1 << 14) -> float:
    """Stream ``data`` through ``predict_logits(batch)->logits`` in fixed
    chunks (a ragged tail is padded and masked by weight so every chunk has
    one shape) and return the streaming AUC."""
    auc = StreamingAUC(num_buckets)
    for batch, n_valid in padded_chunks(data, batch_size):
        w = np.ones((batch_size,), np.float32)
        w[n_valid:] = 0.0
        auc.update(predict_logits(batch), batch[label_key], w)
    return auc.result()
