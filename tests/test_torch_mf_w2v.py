"""The port's MF and word2vec models and apps against the JAX package's.

Models: the same float32 rows through both packages' loss and autograd;
the losses and gradients agree to 1e-6 (absolute and relative: the same
arithmetic, summed in orders that may differ). The word2vec sampler and
subsampler are numpy copies and draw bit-identically from the same seed.

Apps (``mf_example``, ``word2vec_example``) at small size, spmd and
threaded with 1 worker, from the JAX tables' weights carried across with
``interop.load_sparse``: the first loss agrees to 1e-6. Both apps train by
plain SGD with the row gradients scaled by the batch size, so a rounding
difference in one step moves the next step's rows by lr x B times it, and
the duplicate keys of a batch (popular items, unigram^0.75 negatives) are
summed in different orders by the two packages' scatter-adds; over the
runs' 10 steps every loss stays within LOSS_TOL = 1e-5 and the holdout
RMSE within 1e-5.

With more than one worker the threaded paths depart from the JAX package
on purpose: each worker's push is scaled by B / NW (the JAX package's B),
as every other threaded app of both packages scales by 1 / NW; at the
JAX package's scale its threaded word2vec diverges at its own defaults.
"""

from __future__ import annotations

import argparse
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.apps import mf_example as jmfx
from minips_tpu.apps import word2vec_example as jw2vx
from minips_tpu.models import mf as jmf
from minips_tpu.models import word2vec as jw2v
from minips_tpu.utils.metrics import MetricsLogger as JMetrics
from minips_tpu_torch import interop
from minips_tpu_torch.apps import mf_example as tmfx
from minips_tpu_torch.apps import word2vec_example as tw2vx
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.models import mf as tmf
from minips_tpu_torch.models import word2vec as tw2v
from minips_tpu_torch.utils.metrics import MetricsLogger

F32 = {"rtol": 1e-6, "atol": 1e-6}
LOSS_TOL = 1e-5
RMSE_TOL = 1e-5
ITERS = 10


def _close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("mu, reg", [(0.0, 0.0), (3.0, 0.02)])
def test_mf_loss_and_grads_match_jax(mu, reg):
    rng = np.random.default_rng(3)
    B, k = 64, 9
    u = rng.normal(scale=0.3, size=(B, k)).astype(np.float32)
    i = rng.normal(scale=0.3, size=(B, k)).astype(np.float32)
    r = rng.uniform(0.5, 5.0, size=B).astype(np.float32)
    _close(tmf.predict(torch.from_numpy(u), torch.from_numpy(i), mu),
           jmf.predict(jnp.asarray(u), jnp.asarray(i), mu))
    _close(tmf.loss(torch.from_numpy(u), torch.from_numpy(i),
                    torch.from_numpy(r), mu, reg),
           jmf.loss(jnp.asarray(u), jnp.asarray(i), jnp.asarray(r), mu, reg))
    got = tmf.grad_fn(torch.from_numpy(u), torch.from_numpy(i),
                      {"rating": torch.from_numpy(r)}, mu=mu, reg=reg)
    want = jmf.grad_fn(jnp.asarray(u), jnp.asarray(i),
                       {"rating": jnp.asarray(r)}, mu=mu, reg=reg)
    for g, w in zip(got, want):
        _close(g, w)


def test_sgns_loss_and_grads_match_jax():
    rng = np.random.default_rng(4)
    B, K, k = 48, 5, 64
    rows = [rng.normal(scale=s, size=shape).astype(np.float32)
            for s, shape in ((0.5, (B, k)), (0.5, (B, k)), (0.5, (B, K, k)))]
    # a score past 20, where softplus would switch to the identity
    rows[1][0] = rows[0][0] * 8.0
    _close(tw2v.sgns_loss(*map(torch.from_numpy, rows)),
           jw2v.sgns_loss(*map(jnp.asarray, rows)))
    got = tw2v.grad_fn(*map(torch.from_numpy, rows))
    want = jw2v.grad_fn(*map(jnp.asarray, rows))
    assert got[2].shape == (B, k) and got[3].shape == (B, K, k)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seed", [0, 7])
def test_unigram_sampler_draws_bit_identically(seed):
    counts = np.random.default_rng(1).integers(1, 5000, size=1000)
    got, want = (m.UnigramSampler(counts, seed=seed) for m in (tw2v, jw2v))
    np.testing.assert_array_equal(got._prob, want._prob)
    np.testing.assert_array_equal(got._alias, want._alias)
    for shape in ((256, 5), (3,), (64, 5)):
        a, b = got.sample(shape), want.sample(shape)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t", [0.0, 1e-3, 1e-4])
def test_subsample_frequent_is_bit_identical(t):
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 20000, size=500)
    ids = rng.integers(0, 500, size=20000).astype(np.int32)
    got = tw2v.subsample_frequent(ids, counts, t=t, seed=5)
    want = jw2v.subsample_frequent(ids, counts, t=t, seed=5)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="dropped the whole stream"):
        tw2v.subsample_frequent(ids, counts, t=1e-30, seed=5)


# -------------------------------------------------------------------- apps
def _cfgs(app_default, mode, **train):
    from minips_tpu.core import config as jcfg

    out = []
    for m in (jcfg, tcfg):
        c = m.Config(**{
            "table": m.TableConfig(**vars(copy.deepcopy(
                app_default.table))),
            "train": m.TrainConfig(**dict(vars(copy.deepcopy(
                app_default.train)), num_iters=ITERS, log_every=0,
                num_workers=1, **train))})
        out.append(c)
    return out


def _check(got, want):
    assert len(got["losses"]) == len(want["losses"]) == ITERS
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert got["samples_per_sec"] > 0


@pytest.mark.parametrize("mode", ["spmd", "threaded"])
def test_mf_app_matches_jax_from_the_same_weights(monkeypatch, mode):
    jc, tc = _cfgs(jmfx.DEFAULT, mode, batch_size=512)
    orig = tmfx.make_tables

    def make_tables(cfg, users, items, device, group=None):
        u, i = orig(cfg, users, items, device, group)
        ju, ji = jmfx._make_tables(jc, jmfx.make_mesh(), users, items)
        interop.load_sparse(u, ju.state_dict())
        interop.load_sparse(i, ji.state_dict())
        return u, i

    monkeypatch.setattr(tmfx, "make_tables", make_tables)
    args = dict(exec_mode=mode, data_file=None, eval_frac=0.1)
    want = jmfx.run(jc, argparse.Namespace(**args),
                    JMetrics(None, verbose=False))
    got = tmfx.run(tc, argparse.Namespace(device="cpu", **args),
                   MetricsLogger(None, verbose=False))
    _check(got, want)
    assert abs(got["rmse"] - want["rmse"]) <= RMSE_TOL
    # identity tables: every user and item owns a row
    assert [t.num_slots for t in got["tables"]] == [1024, 2048]
    assert all(t.identity and t.dim == 9 for t in got["tables"])


@pytest.mark.parametrize("mode", ["spmd", "threaded"])
def test_word2vec_app_matches_jax_from_the_same_weights(monkeypatch, mode):
    jc, tc = _cfgs(jw2vx.DEFAULT, mode, batch_size=256)
    orig = tw2vx.make_tables
    from minips_tpu.tables.sparse import SparseTable as JSparse

    def make_tables(cfg, device, group=None):
        i, o = orig(cfg, device, group)
        ji = JSparse(jc.table.num_slots, jc.table.dim, jw2vx.make_mesh(),
                     name="in", updater=jc.table.updater, lr=jc.table.lr,
                     init_scale=0.01, seed=1)
        interop.load_sparse(i, ji.state_dict())
        assert not o.emb.any()  # the out table starts at zero in both
        return i, o

    monkeypatch.setattr(tw2vx, "make_tables", make_tables)
    args = dict(exec_mode=mode, data_file=None, subsample=0.0)
    want = jw2vx.run(jc, argparse.Namespace(**args),
                     JMetrics(None, verbose=False))
    got = tw2vx.run(tc, argparse.Namespace(device="cpu", **args),
                    MetricsLogger(None, verbose=False))
    _check(got, want)


def test_word2vec_streams_are_per_worker():
    """Each worker's batches come from its own generator and sampler: a
    stream's draws do not depend on another stream's consumption, and the
    out keys keep the [B, 1 + NEG] shape."""
    _, tc = _cfgs(tw2vx.DEFAULT, "threaded", batch_size=64)
    args = argparse.Namespace(data_file=None, subsample=1e-3)
    c, x, n = tw2vx.pairs(tc, args)
    a0 = tw2vx.batch_gen(tc, c, x, n, 0)
    b0 = tw2vx.batch_gen(tc, c, x, n, 0)
    a1 = tw2vx.batch_gen(tc, c, x, n, 1)
    first = [next(a0) for _ in range(3)]
    next(a1)
    for want in first:
        got = next(b0)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    keys = tw2vx.out_keys(torch.as_tensor(first[0]["pos"]),
                          torch.as_tensor(first[0]["neg"]))
    assert keys.shape == (64, 1 + tw2vx.NEG) and keys.dtype == torch.int32
    assert torch.equal(keys[:, 0], torch.as_tensor(first[0]["pos"]))


def test_word2vec_threaded_four_workers_scale_their_pushes():
    """4 workers under ASP at the app's defaults (sgd, lr 0.05, B 1024):
    each pushes its batch's gradients times B / NW. The JAX package pushes
    B times them from every worker, an NW-times learning rate on rows all
    four pulled at about the same state, and its loss leaves every bound
    within 60 steps; the port's stays finite and falls."""
    jc, tc = _cfgs(jw2vx.DEFAULT, "threaded")
    for c in (jc, tc):
        c.train.num_workers, c.train.num_iters = 4, 60
    args = dict(exec_mode="threaded", data_file=None, subsample=0.0)
    want = jw2vx.run(jc, argparse.Namespace(**args),
                     JMetrics(None, verbose=False))["losses"]
    got = tw2vx.run(tc, argparse.Namespace(device="cpu", **args),
                    MetricsLogger(None, verbose=False))["losses"]
    assert not all(np.isfinite(want)) or max(want) > 100
    assert np.isfinite(got).all() and max(got) < 4.2
    assert np.mean(got[-10:]) < np.mean(got[:10]) - 0.3
