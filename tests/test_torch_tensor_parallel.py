"""The port's Megatron tensor parallelism (``apply_tp``, ``tp_specs``,
``parallel/partition.py:shard_params``) against the JAX package's under
``shard_map`` on ``make_mesh(n_data, model_size=)``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``run_ranks``; the rank bodies are ``torch_parallel_ranks.py``).
Rank ``d·model_size + m`` takes the model shard m of every leaf and the
batch rows of data shard d, computes the data-mean next-token loss at
float32 and its gradient of every leaf, replicated (embeddings, LNs) and
sharded (q/k/v or GQA's wq/wkv, proj, mlp_in, mlp_out) alike, each summed
over the data group as shard_map's transpose sums a replicated input's
cotangent. The shard of JAX's gradient on device (d, m) is the rank's to
2e-4, the loss to 1e-5 and the logits to the one-device ``apply``'s to
1e-4, at tp 2 x dp 1, and at tp 2 x dp 2 (the counterpart of
``test_tp_composes_with_dp``), MHA and GQA with RoPE. Heads, or GQA kv
heads, that do not divide by the model axis are refused with
``ValueError``, as in JAX.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.utils.tree import tree_leaves

WORLD_SIZES = (2, 4)
B, T = 4, 16
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
LM = dict(vocab=61, dim=32, depth=2, max_len=T)
# name: (world size, (n_data, model), heads, kv heads, rope)
CASES = {"tp2": (2, (1, 2), 4, None, False),
         "tp2-gqa-rope": (2, (1, 2), 4, 2, True),
         "tp2xdp2": (4, (2, 2), 4, None, False),
         "tp2xdp2-gqa-rope": (4, (2, 2), 4, 2, True)}
# refused on the (1, 4) mesh: 2 heads, and GQA's 2 kv heads
REFUSED = {"heads": (2, None), "kv_heads": (4, 2)}


def _spec(name, mesh, heads, kv, rope, seed):
    params = jtfm.init(jax.random.PRNGKey(seed), heads=heads, kv_heads=kv,
                       rope=rope, **LM)
    toks = np.random.default_rng(seed).integers(0, LM["vocab"], (B, T + 1))
    return dict(layout="tp", mesh=mesh, heads=heads, tokens=toks,
                params=jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs():
    specs, cases = {}, {n: [] for n in WORLD_SIZES}
    for i, (name, (n, mesh, heads, kv, rope)) in enumerate(CASES.items()):
        specs[name] = _spec(name, mesh, heads, kv, rope, i)
        cases[n].append((name, "model_parallel", specs[name]))
    for name, (heads, kv) in REFUSED.items():
        specs[name] = dict(_spec(name, (1, 4), heads, kv, False, 9),
                           raises=True)
        cases[4].append((name, "model_parallel", specs[name]))
    return specs, {n: run_ranks(ranks.run_cases, n, cases[n], device="cpu")
                   for n in WORLD_SIZES}


def _jax_loss(spec):
    n_data, model = spec["mesh"]
    mesh = make_mesh(n_data, model_size=model)
    specs = jtfm.tp_specs(spec["params"])
    heads = spec["heads"]

    def loss(p, toks):
        def shard_fn(p_, t_):
            logits = jtfm.apply_tp(p_, t_[:, :-1], heads=heads,
                                   compute_dtype=jnp.float32)
            return jax.lax.pmean(jtfm.nll(logits, t_[:, 1:]), "data")
        return shard_map(shard_fn, mesh=mesh, in_specs=(specs, P("data")),
                         out_specs=P())(p, toks)

    return (jax.jit(jax.value_and_grad(loss)),
            jax.tree.map(jnp.asarray, spec["params"]))


def _shard(x, dim, idx, n):
    return x if dim is None else np.split(np.asarray(x), n, axis=dim)[idx]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_loss_logits_and_every_gradient_match_jax(runs, name):
    specs, got = runs
    spec = specs[name]
    n, (n_data, model) = CASES[name][0], spec["mesh"]
    f, params = _jax_loss(spec)
    loss, grads = f(params, jnp.asarray(spec["tokens"]))
    logits = np.asarray(jax.jit(functools.partial(
        jtfm.apply, heads=spec["heads"], compute_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, spec["params"]),
        jnp.asarray(spec["tokens"][:, :-1])))
    dims = tree_leaves(ttfm.tp_specs(spec["params"]))
    grads = jax.tree.leaves(grads)
    assert len(dims) == len(grads)
    for r in range(n):
        d, m = divmod(r, model)
        mine = got[n][r][name]
        np.testing.assert_allclose(mine["loss"], float(loss), rtol=LOSS_TOL)
        b = B // n_data
        np.testing.assert_allclose(mine["logits"], logits[d * b:(d + 1) * b],
                                   rtol=0, atol=LOGITS_TOL)
        for g, w, dim in zip(mine["grads"], grads, dims):
            np.testing.assert_allclose(g, _shard(w, dim, m, model), rtol=0,
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_indivisible_heads_are_refused_like_jax(runs, name):
    specs, got = runs
    spec = specs[name]
    f, params = _jax_loss(spec)
    with pytest.raises(ValueError, match="divisible by tensor-parallel"):
        f(params, jnp.asarray(spec["tokens"]))
    for r in range(4):
        assert "divisible by tensor-parallel size 4" in got[4][r][name]


def test_tp_specs_match_jax():
    """The port's spec tree names the same sharded dim as the JAX
    ``PartitionSpec`` of every leaf (fused and GQA layouts)."""
    for kv in (None, 2):
        params = jax.tree.map(np.asarray, jtfm.init(
            jax.random.PRNGKey(0), heads=4, kv_heads=kv, **LM))
        want = [next((i for i, a in enumerate(s) if a is not None), None)
                for s in jax.tree.leaves(
                    jtfm.tp_specs(params),
                    is_leaf=lambda x: isinstance(x, P))]
        assert tree_leaves(ttfm.tp_specs(params)) == want


@pytest.mark.parametrize("layout,shape", [("tp", (2, 2)), ("tp", (1, 4)),
                                          ("pp", (2, 2)), ("ep", (4, 1))])
def test_interop_shards_equal_the_jax_device_shards(layout, shape):
    """``interop.shard_from_numpy`` gives rank ``d·model_size + m`` the
    shard that ``device_put`` with the JAX spec tree's ``NamedSharding``
    places on device (d, m) of ``make_mesh(n_data, model_size=)``,
    exactly, for every leaf."""
    from jax.sharding import NamedSharding

    from minips_tpu.parallel.pipeline import stack_layers
    from minips_tpu_torch import interop

    n_data, model = shape
    mesh = make_mesh(n_data, model_size=model)
    if layout == "ep":
        params = jtfm.init_moe_lm(jax.random.PRNGKey(1), num_experts=4,
                                  expert_hidden=8, **dict(LM, heads=4))
        jspecs, specs = jtfm.ep_lm_specs(params), None
    else:
        params = jtfm.init(jax.random.PRNGKey(1), heads=4,
                           depth=4 if layout == "pp" else 2,
                           **{k: v for k, v in LM.items() if k != "depth"})
        if layout == "pp":
            params = {**params, "blocks": stack_layers(params["blocks"])}
        jspecs = (jtfm.pp_specs if layout == "pp" else jtfm.tp_specs)(
            params, "model")
    params = jax.tree.map(np.asarray, params)
    specs = {"tp": ttfm.tp_specs, "pp": ttfm.pp_specs,
             "ep": ttfm.ep_lm_specs}[layout](params)
    placed = jax.tree.leaves(jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        jspecs, is_leaf=lambda x: isinstance(x, P)))
    devices = list(np.asarray(mesh.devices).reshape(-1))  # rank order
    for rank in range(n_data * model):
        d, m = divmod(rank, model)
        mine = tree_leaves(interop.shard_from_numpy(
            params, specs, d if layout == "ep" else m,
            n_data if layout == "ep" else model, "cpu"))
        assert len(mine) == len(placed)
        for got, arr in zip(mine, placed):
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
