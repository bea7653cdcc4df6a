"""The port's GPipe (``parallel/pipeline.py``) and the pipeline-parallel
LM (``apply_pp``, ``pp_specs``) against the JAX package's under
``shard_map``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``run_ranks``; the rank bodies are ``torch_parallel_ranks.py``).

- ``gpipe`` on a toy stage (``tanh(x @ w_i)``, one weight per stage) over
  n stages, 2 and 5 microbatches: the replicated output and the
  gradients of ``sum(out * c)`` in the stage weights and the input, to
  1e-6 (the same float32 operations).
- ``apply_pp`` at float32, the JAX ``init``'s 4 blocks stacked by
  ``stack_layers`` and cut on their depth axis: 2 stages x dp 1, 2 stages
  x dp 2 and 4 stages, with a learned positional table and with RoPE
  (wrapped inside the stage): the data-mean loss to 1e-5, the logits to
  the one-device ``apply``'s to 1e-4, every leaf's gradient (this rank's
  stage of the stacked blocks; embeddings and LNs summed over the data
  group) to 2e-4 (``tests/test_pipeline.py``'s tolerances).
- ``stack_layers`` / ``unstack_layers`` against JAX's, exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.parallel.pipeline import gpipe, stack_layers
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch import interop
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.parallel import pipeline as tpipe
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.utils.tree import tree_leaves

WORLD_SIZES = (2, 4)
B, T, MICRO = 4, 16, 2
TOY_TOL = 1e-6
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
LM = dict(vocab=61, dim=32, heads=4, depth=4, max_len=T)
TOY_M = (2, 5)
# name: (world size, (n_data, model), rope)
PP = {"pp2": (2, (1, 2), False), "pp2-rope": (2, (1, 2), True),
      "pp2xdp2": (4, (2, 2), False), "pp4": (4, (1, 4), False),
      "pp4-rope": (4, (1, 4), True)}


def _toy(n, M):
    rng = np.random.default_rng(10 * n + M)
    return dict(w=(rng.normal(size=(n, 5, 5)) * 0.5).astype(np.float32),
                x=rng.normal(size=(M, 3, 5)).astype(np.float32),
                c=rng.normal(size=(M, 3, 5)).astype(np.float32))


def _pp(name, seed):
    _, mesh, rope = PP[name]
    params = jtfm.init(jax.random.PRNGKey(seed), rope=rope, **LM)
    params = {**params, "blocks": stack_layers(params["blocks"])}
    toks = np.random.default_rng(seed).integers(0, LM["vocab"], (B, T + 1))
    return dict(layout="pp", mesh=mesh, heads=LM["heads"], micro=MICRO,
                tokens=toks, params=jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs():
    specs, cases = {}, {n: [] for n in WORLD_SIZES}
    for n in WORLD_SIZES:
        for M in TOY_M:
            specs[f"toy{n}-{M}"] = _toy(n, M)
            cases[n].append((f"toy{n}-{M}", "gpipe", specs[f"toy{n}-{M}"]))
    for i, name in enumerate(PP):
        specs[name] = _pp(name, i)
        cases[PP[name][0]].append((name, "model_parallel", specs[name]))
    return specs, {n: run_ranks(ranks.run_cases, n, cases[n], device="cpu")
                   for n in WORLD_SIZES}


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("M", TOY_M)
def test_gpipe_and_its_gradients_match_jax(runs, n, M):
    specs, got = runs
    spec = specs[f"toy{n}-{M}"]
    f = shard_map(lambda w_, x_: gpipe(lambda h: jnp.tanh(h @ w_[0]), x_,
                                       axis_name="model"),
                  mesh=make_mesh(1, model_size=n),
                  in_specs=(P("model"), P()), out_specs=P())
    c = jnp.asarray(spec["c"])

    def loss(w, x):
        out = f(w, x)
        return jnp.sum(out * c), out

    (_, out), (dw, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(spec["w"]),
                                             jnp.asarray(spec["x"]))
    for r in range(n):
        mine = got[n][r][f"toy{n}-{M}"]
        np.testing.assert_allclose(mine["out"], np.asarray(out), rtol=0,
                                   atol=TOY_TOL)
        np.testing.assert_allclose(mine["dw"], np.asarray(dw)[r], rtol=0,
                                   atol=TOY_TOL)
        np.testing.assert_allclose(mine["dx"], np.asarray(dx), rtol=0,
                                   atol=TOY_TOL)


@pytest.mark.parametrize("name", sorted(PP))
def test_pp_loss_logits_and_every_gradient_match_jax(runs, name):
    specs, got = runs
    spec = specs[name]
    n, (n_data, model), _ = PP[name]
    jspecs = jtfm.pp_specs(spec["params"])

    def loss(p, toks):
        def shard_fn(p_, t_):
            logits = jtfm.apply_pp(p_, t_[:, :-1], heads=LM["heads"],
                                   num_microbatches=MICRO,
                                   compute_dtype=jnp.float32)
            return jax.lax.pmean(jtfm.nll(logits, t_[:, 1:]), "data")
        return shard_map(shard_fn, mesh=make_mesh(n_data, model_size=model),
                         in_specs=(jspecs, P("data")), out_specs=P())(p, toks)

    params = jax.tree.map(jnp.asarray, spec["params"])
    val, grads = jax.jit(jax.value_and_grad(loss))(
        params, jnp.asarray(spec["tokens"]))
    flat = {**params, "blocks": [jax.tree.map(lambda x: x[i],
                                              params["blocks"])
                                 for i in range(LM["depth"])]}
    logits = np.asarray(jax.jit(functools.partial(
        jtfm.apply, heads=LM["heads"], compute_dtype=jnp.float32))(
        flat, jnp.asarray(spec["tokens"][:, :-1])))
    dims = tree_leaves(ttfm.pp_specs(spec["params"]))
    grads = jax.tree.leaves(grads)
    for r in range(n):
        d, m = divmod(r, model)
        mine = got[n][r][name]
        np.testing.assert_allclose(mine["loss"], float(val), rtol=LOSS_TOL)
        b = B // n_data
        np.testing.assert_allclose(mine["logits"], logits[d * b:(d + 1) * b],
                                   rtol=0, atol=LOGITS_TOL)
        assert len(mine["grads"]) == len(grads)
        for g, w, dim in zip(mine["grads"], grads, dims):
            w = np.asarray(w) if dim is None else \
                np.split(np.asarray(w), model, axis=dim)[m]
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL)


def test_stack_and_unstack_layers_match_jax():
    params = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(3),
                                                kv_heads=2, **LM))
    want = jax.tree.map(np.asarray, stack_layers(params["blocks"]))
    blocks = interop.tree_from_numpy(params["blocks"], "cpu")
    got = tpipe.stack_layers(blocks)
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = tpipe.unstack_layers(got)
    assert len(back) == LM["depth"]
    for a, b in zip(tree_leaves(back), tree_leaves(blocks)):
        assert torch.equal(a, b)
