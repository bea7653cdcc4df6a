"""The port's row-wise sparse updates against the JAX package's.

Every function, both strategies, on batches with duplicate slots, at f32.
Tolerance 1e-6 absolute: the ops are the same in the same order, but XLA
and PyTorch may round a fused multiply-add or a sqrt/divide chain
differently in the last bit of values of order 1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ops import sparse_update as jsu
from minips_tpu_torch.ops import sparse_update as tsu

ATOL = 1e-6
S, D, B = 64, 4, 48


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    slots = rng.integers(0, S // 4, B).astype(np.int32)  # many duplicates
    slots[:3] = (0, S - 1, S - 1)
    return {
        "emb": rng.normal(size=(S, D)).astype(np.float32),
        "accum": np.full((S, D), 0.1, np.float32),
        "slots": slots,
        "grads": rng.normal(size=(B, D)).astype(np.float32),
        "grads2": rng.normal(size=(B, D)).astype(np.float32),
    }


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=ATOL)


def test_dedup_segment_sum(data):
    want = jsu.dedup_segment_sum(jnp.asarray(data["slots"]),
                                 jnp.asarray(data["grads"]))
    got = tsu.dedup_segment_sum(_t(data["slots"]), _t(data["grads"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the static-shape tail: rep 0 and zero sums past the unique count
    k = int(np.unique(data["slots"]).size)
    assert not got[2][k:].any() and (got[0][k:] == 0).all()
    assert (got[1][k:] == 0).all()


def test_row_sgd(data):
    want = jsu.row_sgd(jnp.asarray(data["emb"]), jnp.asarray(data["slots"]),
                       jnp.asarray(data["grads"]), 0.1)
    got = tsu.row_sgd(_t(data["emb"]), _t(data["slots"]), _t(data["grads"]),
                      0.1)
    _close(got.numpy(), want)


@pytest.mark.parametrize("prefer_dense", [True, False])
def test_row_adagrad_two_pushes(data, prefer_dense):
    je, ja = jnp.asarray(data["emb"]), jnp.asarray(data["accum"])
    te, ta = _t(data["emb"]), _t(data["accum"])
    for g in (data["grads"], data["grads2"]):
        je, ja = jsu.row_adagrad(je, ja, jnp.asarray(data["slots"]),
                                 jnp.asarray(g), 0.05,
                                 prefer_dense=prefer_dense)
        te, ta = tsu.row_adagrad(te, ta, _t(data["slots"]), _t(g), 0.05,
                                 prefer_dense=prefer_dense)
    _close(te.numpy(), je)
    _close(ta.numpy(), ja)


@pytest.mark.parametrize("prefer_dense", [True, False])
def test_row_adam_per_row_steps(data, prefer_dense):
    zeros = np.zeros((S, D), np.float32)
    steps = np.zeros(S, np.int32)
    js = [jnp.asarray(x) for x in (data["emb"], zeros, zeros, steps)]
    ts = [_t(x) for x in (data["emb"], zeros, zeros, steps)]
    # the second push touches a different row set, so per-row step
    # counters diverge
    pushes = [(data["slots"], data["grads"]),
              ((data["slots"] + 7) % S, data["grads2"])]
    for slots, g in pushes:
        js = jsu.row_adam(*js, jnp.asarray(slots.astype(np.int32)),
                          jnp.asarray(g), 0.01, prefer_dense=prefer_dense)
        ts = tsu.row_adam(*ts, _t(slots.astype(np.int32)), _t(g), 0.01,
                          prefer_dense=prefer_dense)
    for got, want in zip(ts[:3], js[:3]):
        _close(got.numpy(), want)
    np.testing.assert_array_equal(ts[3].numpy(), np.asarray(js[3]))
    assert ts[3].dtype == torch.int32


@pytest.mark.parametrize("fn", ["adagrad", "adam"])
def test_strategy_threshold_is_jaxs(fn):
    # the same table size picks the same strategy in both packages
    assert tsu.DENSE_ACCUM_MAX_ELEMS == jsu.DENSE_ACCUM_MAX_ELEMS
    emb = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        if fn == "adagrad":
            tsu.row_adagrad(emb, emb.clone(), torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, 2), 0.1, eps=0.0)
        else:
            tsu.row_adam(emb, emb.clone(), emb.clone(),
                         torch.zeros(4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, 2), 0.1, eps=0.0)
