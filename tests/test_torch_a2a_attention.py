"""The port's all-to-all sequence parallelism
(``parallel/a2a_attention.py``) against the JAX package's under
``shard_map``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``run_ranks``; the rank bodies are ``torch_parallel_ranks.py``).
On the same seeded q/k/v, with the plain oracle inside (``a2a``) and the
flash primitive (``a2a_flash``: the kernels' plain versions here, the
blockwise scan on the JAX side), causal or not, at MHA, GQA with kv heads
dividing n (the narrow exchange) and MQA (kv heads expanded before the
exchange): the output to 1e-5 and the gradients of ``sum(out * r)`` in q,
k and v to 2e-4 (``tests/test_a2a_attention.py``'s tolerances); the
layout through the LM is in ``test_torch_ring_attention.py``. Heads that
do not divide by n are refused with ``ValueError``, as in JAX.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from minips_tpu.ops.flash_attention import flash_attention
from minips_tpu.parallel.a2a_attention import a2a_attention_local
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch.parallel.mesh import run_ranks

WORLD_SIZES = (2, 4)
B, T, H, D = 2, 16, 4, 8
OUT_TOL, GRAD_TOL = 1e-5, 2e-4
CASES = {f"{impl}-{'causal' if causal else 'full'}-kv{hk}":
         (impl, causal, hk)
         for impl in ("a2a", "a2a_flash") for causal in (True, False)
         for hk in (H, 2, 1)}


def _spec(name, heads=H):
    impl, causal, hk = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(B, T, heads, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, hk, D)).astype(np.float32)
            for _ in range(2))
    r = rng.normal(size=(B, T, heads, D)).astype(np.float32)
    return dict(impl=impl, causal=causal, q=q, k=k, v=v, r=r)


@pytest.fixture(scope="module")
def runs():
    cases = [(name, "attention", _spec(name)) for name in CASES]
    # 3 heads split over neither 2 nor 4 ranks
    cases.append(("refused", "attention",
                  dict(_spec("a2a-causal-kv1", heads=3), raises=True)))
    specs = {name: spec for name, _, spec in cases}
    return specs, {n: run_ranks(ranks.run_cases, n, cases, device="cpu")
                   for n in WORLD_SIZES}


def _jax(spec, n):
    inner = flash_attention if spec["impl"] == "a2a_flash" else None
    seq = P(None, "data")
    f = shard_map(functools.partial(a2a_attention_local, axis_name="data",
                                    causal=spec["causal"], inner=inner),
                  mesh=make_mesh(n), in_specs=(seq, seq, seq), out_specs=seq)
    r = jnp.asarray(spec["r"])

    def loss(q, k, v):
        out = f(q, k, v)
        return jnp.sum(out * r), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(spec[x]) for x in ("q", "k", "v")))
    return [np.asarray(x) for x in (out,) + grads]


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_a2a_attention_matches_jax(runs, n, name):
    specs, got = runs
    want = _jax(specs[name], n)
    for key, w, tol in zip(("out", "dq", "dk", "dv"), want,
                           (OUT_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        mine = np.concatenate([got[n][r][name][key] for r in range(n)],
                              axis=1)
        np.testing.assert_allclose(mine, w, rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_heads_not_divisible_are_refused(runs, n):
    specs, got = runs
    spec = specs["refused"]
    seq = P(None, "data")
    f = shard_map(functools.partial(a2a_attention_local, axis_name="data",
                                    causal=True),
                  mesh=make_mesh(n), in_specs=(seq, seq, seq), out_specs=seq)
    with pytest.raises(ValueError, match="divisible"):
        f(*(jnp.asarray(spec[x]) for x in ("q", "k", "v")))
    for r in range(n):
        assert "heads (3) divisible by the group size" in got[n][r]["refused"]
