"""The port's batch iterator, device prefetch and streaming AUC against the
JAX package on the same seeded data.

- ``BatchIterator``: bit-identical batches, ``iter_from`` included (the same
  numpy permutations from the same seed).
- ``prefetch_to_device`` on the CPU: the iterator's batches as tensors, in
  order; a producer error re-raises in the consumer.
- ``auc_exact`` and ``padded_chunks``: equal (the same numpy code).
- ``StreamingAUC``/``evaluate_auc``: within 1e-6 of the JAX package's. The
  histograms hold integer weights summed in float32, so they agree exactly
  unless XLA's and PyTorch's sigmoid round one score to different sides of
  a bucket edge, which moves the AUC by at most one pair in n_pos x n_neg.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minips_tpu.data import loader as jloader
from minips_tpu.utils import evaluation as jeval
from minips_tpu_torch.data import loader as tloader
from minips_tpu_torch.utils import evaluation as teval


def _data(n=103):
    rng = np.random.default_rng(4)
    return {"x": rng.normal(size=(n, 3)).astype(np.float32),
            "cat": rng.integers(0, 1 << 40, (n, 5)),
            "y": (rng.random(n) > 0.5).astype(np.float32)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("start", [0, 3, 11, 25])
def test_batch_iterator_bit_identical(drop_last, start):
    data = _data()
    j = jloader.BatchIterator(data, 10, seed=5, drop_last=drop_last)
    t = tloader.BatchIterator(data, 10, seed=5, drop_last=drop_last)
    for jb, tb, _ in zip(j.iter_from(start), t.iter_from(start), range(30)):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    with pytest.raises(ValueError, match="batch_size"):
        tloader.BatchIterator(data, 200)
    with pytest.raises(ValueError, match="share length"):
        tloader.BatchIterator({"a": np.zeros(3), "b": np.zeros(4)}, 1)


def test_prefetch_to_device_on_cpu():
    data = _data()
    it = tloader.BatchIterator(data, 8, seed=2)
    want = [b for b, _ in zip(tloader.BatchIterator(data, 8, seed=2),
                              range(6))]
    got = tloader.prefetch_to_device((b for b, _ in zip(it, range(6))),
                                     "cpu", depth=2)
    n = 0
    for g, w in zip(got, want):
        for k in w:
            assert torch.is_tensor(g[k])
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        n += 1
    assert n == 6

    def broken():
        yield {"x": np.zeros(2)}
        raise KeyError("producer failed")

    out = tloader.prefetch_to_device(broken(), "cpu")
    assert next(out)["x"].shape == (2,)
    with pytest.raises(KeyError, match="producer failed"):
        next(out)


def test_auc_exact_and_chunks_equal():
    rng = np.random.default_rng(1)
    scores = np.round(rng.normal(size=997), 1)   # ties
    labels = (rng.random(997) > 0.4).astype(np.float32)
    assert teval.auc_exact(scores, labels) == jeval.auc_exact(scores, labels)
    assert teval.auc_exact(scores, np.ones(997)) == 0.5
    data = {"s": scores, "y": labels}
    for (tc, tn), (jc, jn) in zip(teval.padded_chunks(data, 128),
                                  jeval.padded_chunks(data, 128)):
        assert tn == jn
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])


@pytest.mark.parametrize("buckets", [2, 64, 1 << 14])
def test_streaming_auc_matches_jax(buckets):
    rng = np.random.default_rng(buckets)
    n = 5000
    labels = (rng.random(n) > 0.7).astype(np.float32)
    logits = (rng.normal(size=n) + 1.5 * labels).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    j, t = jeval.StreamingAUC(buckets), teval.StreamingAUC(buckets)
    for lo in range(0, n, 1024):
        sl = slice(lo, lo + 1024)
        j.update(logits[sl], labels[sl], w[sl])
        t.update(torch.from_numpy(logits[sl]), labels[sl], w[sl])
    assert t.count == j.count
    assert abs(t.result() - j.result()) <= 1e-6
    t.reset()
    assert t.count == 0.0
    with pytest.raises(ValueError, match="buckets"):
        teval.StreamingAUC(1)


def test_evaluate_auc_matches_jax():
    rng = np.random.default_rng(3)
    n = 10000
    data = {"x": rng.normal(size=(n, 4)).astype(np.float32),
            "y": (rng.random(n) > 0.5).astype(np.float32)}
    w = np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    data["y"] = ((data["x"] @ w + rng.normal(size=n)) > 0).astype(np.float32)
    got = teval.evaluate_auc(lambda b: torch.from_numpy(b["x"] @ w), data,
                             batch_size=4096)
    want = jeval.evaluate_auc(lambda b: b["x"] @ w, data, batch_size=4096)
    assert abs(got - want) <= 1e-6
    exact = teval.auc_exact(data["x"] @ w, data["y"])
    assert abs(got - exact) < 1e-3
