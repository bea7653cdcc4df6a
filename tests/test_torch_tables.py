"""The port's tables, hash, updaters and interop against the JAX package.

Tolerances: the hash and every integer are exact. Float state is held to
1e-6 absolute at f32 (the same ops in the same order; XLA and PyTorch may
round a sqrt/divide chain differently in the last bit). Updaters are held
to 1e-6 relative plus 1e-7 absolute over a stream of 4 gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from minips_tpu.models import wide_deep as jwd
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables import dense as jdense
from minips_tpu.tables import sparse as jsparse
from minips_tpu.tables import updaters as jupd
from minips_tpu_torch import interop
from minips_tpu_torch.tables import dense as tdense
from minips_tpu_torch.tables import sparse as tsparse
from minips_tpu_torch.tables import updaters as tupd
from minips_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-6


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------------ hash
@pytest.fixture
def keys():
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.integers(0, 1 << 31, 500),
        rng.integers(1 << 31, 1 << 32, 500),
        rng.integers(1 << 32, 1 << 62, 500),
        rng.integers(-(1 << 62), 0, 500),
        [0, 1, -1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, -(1 << 63)],
    ]).astype(np.int64)


@pytest.mark.parametrize("salt", [0, 1, 2, 0xDEADBEEF])
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("num_slots", [1 << 10, 1 << 18])
def test_hash_bit_identical(keys, salt, identity, num_slots):
    want = jsparse.hash_to_slots_np(keys, num_slots, salt, identity)
    np.testing.assert_array_equal(
        tsparse.hash_to_slots_np(keys, num_slots, salt, identity), want)
    got = tsparse.hash_to_slots(torch.from_numpy(keys), num_slots, salt,
                                identity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    # the device hash: keys reach JAX as int32 (x64 off), their low 32 bits
    dev = jsparse.hash_to_slots(jnp.asarray(keys.astype(np.int32)),
                                num_slots, salt, identity)
    np.testing.assert_array_equal(np.asarray(dev).astype(np.int64), want)


def test_collision_stats_and_next_pow2(keys):
    for s in (1 << 6, 1 << 12):
        assert tsparse.collision_stats(keys, s, salt=1) == \
            jsparse.collision_stats(keys, s, salt=1)
    for n in (0, 1, 3, 1000, 1 << 20):
        assert tsparse.next_pow2(n, 4) == jsparse.next_pow2(n, 4)


# ------------------------------------------------------------ SparseTable
@pytest.mark.parametrize("updater", ["sgd", "adagrad", "adam"])
def test_sparse_table_pull_push(mesh1, updater):
    rng = np.random.default_rng(5)
    S, D = 256, 8
    jt = jsparse.SparseTable(S, D, mesh1, updater=updater, lr=0.05, salt=3)
    if updater == "adam":
        # on a one-device mesh the JAX table's m and v alias one buffer,
        # which its donating push refuses; give v a buffer of its own
        jt.v = jnp.zeros_like(jt.m)
    tt = tsparse.SparseTable(S, D, updater=updater, lr=0.05, salt=3,
                             device="cpu")
    interop.load_sparse(tt, jt.state_dict())
    k = rng.integers(0, 1 << 40, (16, 5))
    k[0, :3] = k[1, :3]  # duplicate keys in one push
    np.testing.assert_array_equal(tt.pull(torch.from_numpy(k)).numpy(),
                                  np.asarray(jt.pull(jnp.asarray(
                                      k.astype(np.int32)))))
    for _ in range(2):
        g = rng.normal(size=(16, 5, D)).astype(np.float32)
        jt.push(jnp.asarray(k.astype(np.int32)), jnp.asarray(g))
        tt.push(torch.from_numpy(k), torch.from_numpy(g))
    want, got = jt.state_dict(), interop.sparse_to_numpy(tt)
    assert sorted(want) == sorted(got)
    for name in want:
        _close(got[name], want[name])


def test_sparse_table_layout_and_state_checks():
    t = tsparse.SparseTable(16, 2, updater="adagrad", salt=1, device="cpu")
    state = t.state_dict()
    other = tsparse.SparseTable(16, 2, updater="adagrad", salt=2,
                                device="cpu")
    with pytest.raises(ValueError, match="layout"):
        other.load_state_dict(state)
    with pytest.raises(ValueError, match="accum"):
        t.load_state_dict({"emb": state["emb"], "layout": state["layout"]})
    with pytest.raises(ValueError, match="power of 2"):
        tsparse.SparseTable(12, 2, device="cpu")
    # a state dict is a copy: later pushes do not change it
    before = state["emb"].copy()
    t.push(torch.tensor([1, 2]), torch.ones(2, 2))
    np.testing.assert_array_equal(state["emb"], before)


# ------------------------------------------------------------- DenseTable
def _mlp_template():
    return jwd.init_deep(jax.random.PRNGKey(1), 3, 4, 5, hidden=(6, 7))


def test_dense_ravel_order():
    tmpl = _mlp_template()
    want, _ = ravel_pytree(tmpl)
    ttmpl = {k: torch.tensor(np.asarray(v)) for k, v in tmpl.items()}
    t = tdense.DenseTable(ttmpl, device="cpu")
    np.testing.assert_array_equal(t.params.numpy(), np.asarray(want))
    assert list(t.pull()) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    for k, v in t.pull().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(tmpl[k]))


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "adam"])
def test_dense_push_and_push_keys(mesh1, updater):
    rng = np.random.default_rng(9)
    tmpl = _mlp_template()
    jt = jdense.DenseTable(tmpl, mesh1, updater=updater, lr=0.01)
    tt = tdense.DenseTable(
        {k: torch.tensor(np.asarray(v)) for k, v in tmpl.items()},
        updater=updater, lr=0.01, device="cpu")
    interop.load_dense(tt, np.asarray(jt.params),
                       [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)])
    for _ in range(2):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             for k, v in tmpl.items()}
        jt.push({k: jnp.asarray(v) for k, v in g.items()})
        tt.push({k: torch.from_numpy(v) for k, v in g.items()})
    keys = np.asarray([0, 3, 3, 10], np.int64)
    vals = rng.normal(size=4).astype(np.float32)
    jt.push_keys(keys, jnp.asarray(vals))
    tt.push_keys(keys, vals)
    _close(tt.pull_keys(keys).numpy(), jt.pull_keys(keys))
    params, leaves = interop.dense_to_numpy(tt)
    _close(params, jt.params)
    for got, want in zip(leaves, jax.tree.leaves(jt.opt_state)):
        _close(got, want)


def test_dense_clip_norm_on_push(mesh1):
    tmpl = {"w": jnp.ones(6, jnp.float32)}
    kw = {"clip_norm": 0.5}
    jt = jdense.DenseTable(tmpl, mesh1, updater="sgd", lr=0.1,
                           updater_kwargs=kw)
    tt = tdense.DenseTable({"w": torch.ones(6)}, updater="sgd", lr=0.1,
                           updater_kwargs=kw, device="cpu")
    g = np.arange(6, dtype=np.float32)
    jt.push({"w": jnp.asarray(g)})
    tt.push({"w": torch.from_numpy(g)})
    _close(tt.params.numpy(), jt.params)


def _lm_template():
    """The LM's parameter tree at a small size: dicts holding a list of
    block dicts."""
    from minips_tpu.models import transformer as jtfm

    return jtfm.init(jax.random.PRNGKey(2), vocab=16, dim=8, heads=2,
                     depth=3, max_len=4)


def test_ravel_walks_lists_as_ravel_pytree_does():
    tmpl = _lm_template()
    want, junravel = ravel_pytree(tmpl)
    ttmpl = interop.tree_from_numpy(jax.tree.map(np.asarray, tmpl), "cpu")
    flat, unravel = tdense.ravel(ttmpl)
    assert flat.shape == want.shape
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))  # bitwise
    back = unravel(flat)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 3
    for a, b in zip(jax.tree.leaves(junravel(want)), tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # unravel gives views: a write through the tree lands in the vector
    back["blocks"][1]["proj"][0, 0] = 7.0
    assert 7.0 in flat.numpy()


def test_dense_push_adam_on_the_lm_tree(mesh1):
    rng = np.random.default_rng(11)
    tmpl = _lm_template()
    jt = jdense.DenseTable(tmpl, mesh1, updater="adam", lr=0.01)
    tt = tdense.DenseTable(
        interop.tree_from_numpy(jax.tree.map(np.asarray, tmpl), "cpu"),
        updater="adam", lr=0.01, device="cpu")
    np.testing.assert_array_equal(tt.params.numpy(), np.asarray(jt.params))
    for _ in range(2):
        g = jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(
            np.float32), tmpl)
        jt.push(jax.tree.map(jnp.asarray, g))
        tt.push(interop.tree_from_numpy(g, "cpu"))
    params, leaves = interop.dense_to_numpy(tt)
    _close(params, jt.params)
    for got, want in zip(leaves, jax.tree.leaves(jt.opt_state)):
        _close(got, want)
    for a, b in zip(jax.tree.leaves(jt.pull()), tree_leaves(tt.pull())):
        _close(b.numpy(), a)
    # the LM table's flat params and Adam state cross both ways unchanged
    leaves = [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)]
    interop.load_dense(tt, np.asarray(jt.params), leaves)
    params, back = interop.dense_to_numpy(tt)
    np.testing.assert_array_equal(params, np.asarray(jt.params))
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- updaters
def _schedule(count):
    return 0.1 / (1.0 + count)


UPDATER_CASES = [
    ("sgd", 0.1, {}),
    ("sgd", 0.1, {"momentum": 0.9}),
    ("adagrad", 0.05, {}),
    ("adam", 1e-3, {}),
    ("adam", 1e-3, {"b1": 0.8, "b2": 0.99, "clip_norm": 1.0}),
    ("adamw", 1e-3, {"weight_decay": 0.1}),
    ("adamw", 1e-3, {"weight_decay": 0.1, "decay_mask": "mask"}),
    ("adagrad", _schedule, {}),
    ("sgd", _schedule, {"momentum": 0.5}),
]


@pytest.mark.parametrize("name,lr,kw", UPDATER_CASES)
def test_updater_matches_optax(name, lr, kw):
    rng = np.random.default_rng(13)
    n = 33
    p0 = rng.normal(size=n).astype(np.float32)
    mask = (rng.random(n) > 0.5).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("decay_mask") == "mask":
        jkw["decay_mask"], tkw["decay_mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    jtx = jupd.make_updater(name, lr, **jkw)
    ttx = tupd.make_updater(name, lr, **tkw)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, ts = jtx.init(jp), ttx.init(tp)
    assert len(ts) == len(jax.tree.leaves(js)) == ttx.num_leaves
    for _ in range(4):
        g = rng.normal(size=n).astype(np.float32) * 3
        ju, js = jtx.update(jnp.asarray(g), js, jp)
        tu, ts = ttx.update(torch.from_numpy(g), ts, tp)
        _close(tu.numpy(), ju, atol=1e-7, rtol=1e-6)
        jp = optax.apply_updates(jp, ju)
        tp = tp + tu
    _close(tp.numpy(), jp, atol=1e-7, rtol=1e-6)
    for got, want in zip(ts, jax.tree.leaves(js)):
        assert got.numpy().dtype == np.asarray(want).dtype
        _close(got.numpy(), want, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("name,leaves", [("adam_bf16", 3), ("adam8", 5)])
def test_lowp_updaters_are_ported(name, leaves):
    # held against the JAX package in test_torch_lowp_adam.py
    tx = tupd.make_updater(name, 1e-3)
    assert tx.num_leaves == len(tx.init(torch.zeros(512))) == leaves
    with pytest.raises(ValueError):
        tupd.make_updater("lion", 1e-3)


# ----------------------------------------------------------------- interop
@pytest.mark.parametrize("updater,shapes", [
    ("adagrad", [(14,)]),               # [sum_of_squares]
    ("adam", [(), (14,), (14,)]),        # [count, mu, nu]
])
def test_interop_round_trip_and_leaf_order(mesh1, updater, shapes):
    tmpl = {"w": jnp.arange(13, dtype=jnp.float32), "b": jnp.float32(2.0)}
    jt = jdense.DenseTable(tmpl, mesh1, updater=updater, lr=0.01)
    jt.push({"w": jnp.ones(13), "b": jnp.float32(1.0)})  # non-trivial state
    leaves = [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)]
    assert [x.shape for x in leaves] == shapes
    tt = tdense.DenseTable({"w": torch.zeros(13), "b": torch.zeros(())},
                           updater=updater, lr=0.01, device="cpu")
    assert [tuple(x.shape) for x in tt.opt_state] == shapes
    interop.load_dense(tt, np.asarray(jt.params), leaves)
    params, back = interop.dense_to_numpy(tt)
    np.testing.assert_array_equal(params, np.asarray(jt.params))
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="leaf count"):
        interop.load_dense(tt, params, back[:-1])
    # the sparse direction round-trips every key of the JAX state dict
    js = jsparse.SparseTable(32, 2, mesh1, updater="adam", salt=4)
    ts = tsparse.SparseTable(32, 2, updater="adam", salt=4, device="cpu")
    interop.load_sparse(ts, js.state_dict())
    for k, v in js.state_dict().items():
        got = interop.sparse_to_numpy(ts)[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)


# ----------------------------------------------- numpy copies of JAX modules
@pytest.mark.parametrize("num_keys,shards,align", [(14, 1, 1), (90305, 1, 1),
                                                   (1000, 8, 16)])
def test_range_partitioner_is_a_copy(num_keys, shards, align):
    from minips_tpu.parallel.partition import RangePartitioner as J
    from minips_tpu_torch.parallel.partition import RangePartitioner as T

    j, t = J(num_keys, shards, align), T(num_keys, shards, align)
    assert (t.padded, t.shard_size) == (j.padded, j.shard_size)
    keys = np.arange(0, j.padded, 7)
    np.testing.assert_array_equal(t.shard_of(keys), j.shard_of(keys))
    np.testing.assert_array_equal(t.local_offset(keys), j.local_offset(keys))
    for a, b in zip(t.split(keys), j.split(keys)):
        np.testing.assert_array_equal(a, b)


def test_criteo_like_gives_the_same_arrays():
    from minips_tpu.data import synthetic as jsyn
    from minips_tpu_torch.data import synthetic as tsyn

    for seed in (0, 1):
        want, got = jsyn.criteo_like(512, seed=seed), \
            tsyn.criteo_like(512, seed=seed)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
