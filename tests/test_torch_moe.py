"""The port's one-device MoE (``parallel/moe.py``, ``init_moe_lm``,
``apply_moe_dense``) against the JAX package's.

The layer on seeded numpy tokens (N = 48, D = 16, 4 experts of hidden 8)
with the JAX package's weights, at float32 compute, top-1 and top-2, with
a capacity that binds (drops routes) and one that holds every route:
outputs, the aux loss and the gradients of ``sum(y * r) + aux`` (r fixed
random) to 1e-5, the same sums in other orders. The dispatch pattern,
which routes are kept and in which slot, is compared exactly (the
first-choice shares, means of one-hots, to 1e-6: the mean sums in
another order). The MoE LM
(2 blocks, dim 32, 4 heads, 4 experts) holds logits and aux to 1e-5 at
float32 and its tree carries across through ``interop``, as any params
tree does, in the JAX package's ravel order.

The expert-parallel layer (``moe_apply_local``) and LM (``apply_ep``,
``ep_lm_specs``) run on 2 and 4 gloo ranks on the CPU, spawned once for
this module (``run_ranks``; the rank bodies are
``torch_parallel_ranks.py``), against the JAX package's under
``shard_map`` on ``make_mesh(n)``, at float32: tokens sharded by rows,
the router replicated, the experts cut on their expert dim, the capacity
per expert per source rank. Top-1 and top-2, a capacity that holds every
route and one that binds (the drops then follow each source rank's own
queues, on both sides): the layer's outputs to 1e-4, its aux loss to
1e-5, the gradients of ``sum(y * r) + aux`` (router summed over the
ranks, each rank's experts and token rows its own) to 2e-4; the LM's
data-mean loss + 0.01 aux to 1e-5, its logits to 1e-4 and every leaf's
gradient to 2e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel import moe as jmoe
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch import interop
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.parallel import moe as tmoe
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.tables.dense import DenseTable, ravel
from minips_tpu_torch.utils.tree import tree_leaves, value_and_grad

N, D, E, H = 48, 16, 4, 8
TOL = 1e-5


def _layer(seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), E, D, H)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    r = rng.normal(size=(N, D)).astype(np.float32)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp),
                                       "cpu"), x, r


# capacity per expert: 4 binds (the even share at k=1 is 12), 2 * k * N
# holds every route
@pytest.mark.parametrize("k_top,capacity", [(1, 4), (1, 96), (2, 6),
                                            (2, 192)])
def test_moe_apply_dense_matches_jax(k_top, capacity):
    jp, tp, x, r = _layer()
    kw = dict(capacity=capacity, k_top=k_top)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply_dense(p, xx, compute_dtype=jnp.float32,
                                      **kw)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(tp)]
    tparams = dict(zip(sorted(tp), leaves))
    ty, taux = tmoe.moe_apply_dense(tparams, tx,
                                    compute_dtype=torch.float32, **kw)
    grads = torch.autograd.grad(
        (ty * torch.from_numpy(r)).sum() + taux, leaves + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=TOL)
    for got, want in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    jd, jc, jf, jm = jmoe._dispatch_combine(jnp.asarray(x), jp["router"], E,
                                            capacity, k_top)
    td, tc, tf, tm = tmoe._dispatch_combine(torch.from_numpy(x),
                                            tp["router"], E, capacity,
                                            k_top)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=TOL)
    # a capacity that binds drops routes; one of 2 k N slots holds all
    kept = int(td.sum())
    assert kept < k_top * N if capacity < N // E * k_top else \
        kept == k_top * N


def _lms(kv_heads=None, rope=False):
    jp = jtfm.init_moe_lm(jax.random.PRNGKey(0), vocab=64, dim=32, heads=4,
                          depth=2, max_len=16, num_experts=4,
                          expert_hidden=16, kv_heads=kv_heads, rope=rope)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("k_top,capacity,kv_heads,rope", [
    (1, 8, None, False), (2, 64, 2, True), (2, 6, None, False)])
def test_moe_lm_logits_and_aux_match_jax(k_top, capacity, kv_heads, rope):
    jp, tp = _lms(kv_heads, rope)
    toks = np.random.default_rng(1).integers(0, 64, size=(2, 16))
    kw = dict(heads=4, capacity=capacity, k_top=k_top)
    jl, jaux = jtfm.apply_moe_dense(jp, jnp.asarray(toks),
                                    compute_dtype=jnp.float32, **kw)
    tl, taux = ttfm.apply_moe_dense(tp, torch.from_numpy(toks),
                                    compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)
    # and the gradient of the LM's loss with the load-balancing term
    tgt = torch.from_numpy(toks[:, 1:])

    def tloss(p):
        logits, aux = ttfm.apply_moe_dense(p, torch.from_numpy(toks[:, :-1]),
                                           compute_dtype=torch.float32, **kw)
        return ttfm.nll(logits, tgt) + 0.01 * aux

    def jloss(p):
        logits, aux = jtfm.apply_moe_dense(p, jnp.asarray(toks[:, :-1]),
                                           compute_dtype=jnp.float32, **kw)
        return jtfm.nll(logits, jnp.asarray(toks[:, 1:])) + 0.01 * aux

    tval, tg = value_and_grad(tloss, tp)
    jval, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(tval), float(jval), rtol=TOL)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_moe_lm_tree_and_interop():
    jp, tp = _lms(2)
    mine = ttfm.init_moe_lm(torch.Generator().manual_seed(0), vocab=64,
                            dim=32, heads=4, depth=2, max_len=16,
                            num_experts=4, expert_hidden=16, kv_heads=2,
                            device="cpu")
    assert [x.shape for x in jax.tree.leaves(jp)] == \
        [tuple(x.shape) for x in tree_leaves(mine)]
    assert sorted(mine["blocks"][0]) == ["ln1", "ln2", "moe", "proj", "wkv",
                                         "wq"]
    assert sorted(mine["blocks"][0]["moe"]) == ["router", "w_in", "w_out"]
    flat, unravel = ravel(tp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    table = DenseTable(tp, updater="adam", device="cpu")
    back = table.pull()
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(tp)))


# ------------------------------------------------------- expert parallel
WORLD_SIZES = (2, 4)
EP_N = 32  # tokens of the layer, sharded by rows
EP_OUT_TOL, EP_AUX_TOL, EP_GRAD_TOL = 1e-4, 1e-5, 2e-4
EP_LM = dict(vocab=61, dim=32, heads=4, depth=2, max_len=16,
             num_experts=4, expert_hidden=16)
EP_B, EP_T = 4, 16
# name: (k_top, capacity per expert per source rank)
EP_LAYER = {"top1": (1, 16), "top1-binds": (1, 3), "top2": (2, 32),
            "top2-binds": (2, 5)}
# name: (k_top, capacity, kv heads)
EP_LMS = {"lm-top1": (1, 64, None), "lm-top2-gqa": (2, 128, 2),
          "lm-top1-binds": (1, 6, None)}


def _ep_layer(name):
    k_top, cap = EP_LAYER[name]
    seed = sorted(EP_LAYER).index(name)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), E, D, H)
    rng = np.random.default_rng(seed)
    return dict(k_top=k_top, capacity=cap,
                params=jax.tree.map(np.asarray, jp),
                x=rng.normal(size=(EP_N, D)).astype(np.float32),
                r=rng.normal(size=(EP_N, D)).astype(np.float32))


def _ep_lm(name, n):
    k_top, cap, kv = EP_LMS[name]
    seed = sorted(EP_LMS).index(name)
    jp = jtfm.init_moe_lm(jax.random.PRNGKey(seed), kv_heads=kv, **EP_LM)
    toks = np.random.default_rng(seed).integers(0, EP_LM["vocab"],
                                                (EP_B, EP_T + 1))
    return dict(layout="ep", mesh=(n, 1), heads=EP_LM["heads"],
                capacity=cap, k_top=k_top, tokens=toks,
                params=jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def ep_runs():
    specs, out = {}, {}
    for n in WORLD_SIZES:
        cases = [(name, "moe_layer", _ep_layer(name)) for name in EP_LAYER]
        cases += [(name, "model_parallel", _ep_lm(name, n))
                  for name in EP_LMS]
        specs[n] = {name: spec for name, _, spec in cases}
        out[n] = run_ranks(ranks.run_cases, n, cases, device="cpu")
    return specs, out


def _split(x, n, r):
    return np.split(np.asarray(x), n, axis=0)[r]


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(EP_LAYER))
def test_moe_apply_local_matches_jax(ep_runs, n, name):
    specs, got = ep_runs
    spec = specs[n][name]
    f = shard_map(lambda p, x: jmoe.moe_apply_local(
        p, x, axis_name="data", capacity=spec["capacity"],
        compute_dtype=jnp.float32, k_top=spec["k_top"]),
        mesh=make_mesh(n), in_specs=(jmoe.ep_specs("data"), P("data")),
        out_specs=(P("data"), P()))
    r = jnp.asarray(spec["r"])

    def loss(p, x):
        y, aux = f(p, x)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, spec["params"]), jnp.asarray(spec["x"]))
    for rank in range(n):
        mine = got[n][rank][name]
        np.testing.assert_allclose(mine["y"], _split(y, n, rank), rtol=0,
                                   atol=EP_OUT_TOL)
        np.testing.assert_allclose(mine["aux"], float(aux), rtol=EP_AUX_TOL)
        router, w_in, w_out, x = mine["grads"]
        for g, want in ((router, np.asarray(gp["router"])),
                        (w_in, _split(gp["w_in"], n, rank)),
                        (w_out, _split(gp["w_out"], n, rank)),
                        (x, _split(gx, n, rank))):
            np.testing.assert_allclose(g, want, rtol=0, atol=EP_GRAD_TOL)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(EP_LMS))
def test_ep_lm_loss_logits_and_every_gradient_match_jax(ep_runs, n, name):
    specs, got = ep_runs
    spec = specs[n][name]
    jspecs = jtfm.ep_lm_specs(spec["params"])
    kw = dict(heads=spec["heads"], capacity=spec["capacity"],
              k_top=spec["k_top"], compute_dtype=jnp.float32)

    def loss(p, toks):
        def shard_fn(p_, t_):
            logits, aux = jtfm.apply_ep(p_, t_[:, :-1], **kw)
            return (jax.lax.pmean(jtfm.nll(logits, t_[:, 1:]), "data")
                    + 0.01 * aux, logits)
        return shard_map(shard_fn, mesh=make_mesh(n),
                         in_specs=(jspecs, P("data")),
                         out_specs=(P(), P("data")))(p, toks)

    (val, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, spec["params"]),
        jnp.asarray(spec["tokens"]))
    dims = tree_leaves(ttfm.ep_lm_specs(spec["params"]))
    grads = jax.tree.leaves(grads)
    b = EP_B // n
    for rank in range(n):
        mine = got[n][rank][name]
        np.testing.assert_allclose(mine["loss"], float(val), rtol=1e-5)
        np.testing.assert_allclose(
            mine["logits"], np.asarray(logits)[rank * b:(rank + 1) * b],
            rtol=0, atol=1e-4)
        assert len(mine["grads"]) == len(grads)
        for g, w, dim in zip(mine["grads"], grads, dims):
            w = np.asarray(w) if dim is None else _split(w, n, rank)
            np.testing.assert_allclose(g, w, rtol=0, atol=EP_GRAD_TOL)


def test_moe_apply_local_refuses_an_expert_count_mismatch():
    """On one device the router's 4 experts must all be local."""
    jp, tp, x, _ = _layer()
    local = dict(tp, w_in=tp["w_in"][:2], w_out=tp["w_out"][:2])
    with pytest.raises(ValueError, match="router knows 4 experts"):
        tmoe.moe_apply_local(local, torch.from_numpy(x), group=None,
                             capacity=8)
    y, aux = tmoe.moe_apply_local(tp, torch.from_numpy(x), group=None,
                                  capacity=8, compute_dtype=torch.float32)
    yd, auxd = tmoe.moe_apply_dense(tp, torch.from_numpy(x), capacity=8,
                                    compute_dtype=torch.float32)
    assert torch.equal(y, yd) and torch.equal(aux, auxd)
