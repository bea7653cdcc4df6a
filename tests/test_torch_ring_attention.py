"""The port's ring attention (``parallel/ring_attention.py``), ring flash
attention (``ops/flash_attention.py``: ``ring_step``,
``ring_flash_attention_local``) and the sequence-parallel LM
(``apply_sp``, ``loss_sp`` with each ``attn_impl``) against the JAX
package's under ``shard_map``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``run_ranks``; the rank bodies are ``torch_parallel_ranks.py``),
with the same seeded numpy inputs and the JAX ``init``'s weights. On the
CPU the JAX ring flash runs its blockwise scan and the port its kernels'
plain versions; both merge the steps by logsumexp in float32, and the
port's gradients reach the plain K3/K4 with the merge's lse cotangent.

Tolerances are the JAX tests' own: the ring's output and the gradients
of ``sum(out * r)`` in q, k and v at float32 to 2e-5, at bfloat16 to
5e-2 (``tests/test_ring_attention.py``); the LM's logits to 1e-4, its
pmean loss to 1e-5 and the gradient of every leaf to 2e-4. On one
process, the n steps of an n-way ring (``ring_step`` on every source
shard, as ``chip_smoke.py`` drives them on one card) give full attention
to 2e-5 and its gradients to 2e-4.
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
from minips_tpu.ops import flash_attention as jfa
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.parallel.ring_attention import ring_attention_local
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch.ops import flash_attention as tfa
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.parallel.ring_attention import make_ring_attention

WORLD_SIZES = (2, 4)
B, T, H, D = 2, 32, 4, 8
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
LM = dict(vocab=64, dim=32, heads=4, depth=2, max_len=T)

# (impl, causal, kv heads, dtype, scale)
ATTN = {
    "ring-causal": ("ring", True, H, "float32", None),
    "ring-full": ("ring", False, H, "float32", None),
    "ring-gqa2": ("ring", True, 2, "float32", None),
    "ring-mqa-full": ("ring", False, 1, "float32", None),
    "ring-scale": ("ring", False, H, "float32", 0.5),
    "ring-bf16": ("ring", True, H, "bfloat16", None),
    "ring_flash-causal": ("ring_flash", True, H, "float32", None),
    "ring_flash-full": ("ring_flash", False, H, "float32", None),
    "ring_flash-gqa2": ("ring_flash", True, 2, "float32", None),
    "ring_flash-mqa": ("ring_flash", True, 1, "float32", None),
    "ring_flash-scale": ("ring_flash", True, H, "float32", 0.5),
    "ring_flash-bf16": ("ring_flash", True, H, "bfloat16", None),
    "ring_flash-gqa2-bf16": ("ring_flash", True, 2, "bfloat16", None),
}
# (attn_impl, kv heads, rope)
SP = {"reference": ("reference", None, False),
      "flash": ("flash", None, False),
      "a2a": ("a2a", None, False),
      "a2a_flash": ("a2a_flash", None, False),
      "flash-gqa-rope": ("flash", 2, True),
      "a2a_flash-gqa-rope": ("a2a_flash", 2, True)}


def _qkv(name):
    impl, causal, hk, dtype, scale = ATTN[name]
    rng = np.random.default_rng(sorted(ATTN).index(name))
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, hk, D)).astype(np.float32)
            for _ in range(2))
    r = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return dict(impl=impl, causal=causal, dtype=dtype, scale=scale, q=q, k=k,
                v=v, r=r)


def _lm(name):
    impl, kv, rope = SP[name]
    params = jtfm.init(jax.random.PRNGKey(sorted(SP).index(name)),
                       kv_heads=kv, rope=rope, **LM)
    toks = np.random.default_rng(7).integers(0, LM["vocab"], (B, T + 1))
    return dict(impl=impl, heads=LM["heads"], tokens=toks,
                params=jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs():
    cases = ([(n, "attention", _qkv(n)) for n in ATTN]
             + [(f"sp-{n}", "sp", _lm(n)) for n in SP])
    specs = {name: spec for name, _, spec in cases}
    return specs, {n: run_ranks(ranks.run_cases, n, cases, device="cpu")
                   for n in WORLD_SIZES}


def _gather(got, name, key, n):
    return np.concatenate([got[r][name][key] for r in range(n)], axis=1)


def _jax_attention(spec, n):
    dtype = jnp.dtype(spec["dtype"])
    q, k, v = (jnp.asarray(spec[x], dtype) for x in ("q", "k", "v"))
    kw = dict(axis_name="data", causal=spec["causal"], scale=spec["scale"])
    local = (functools.partial(ring_attention_local, **kw)
             if spec["impl"] == "ring"
             else functools.partial(jfa.ring_flash_attention_local, **kw))
    seq = P(None, "data")
    f = shard_map(local, mesh=make_mesh(n), in_specs=(seq, seq, seq),
                  out_specs=seq)
    r = jnp.asarray(spec["r"])

    def loss(q_, k_, v_):
        out = f(q_, k_, v_)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x, np.float32) for x in (out,) + grads]


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_attention_matches_jax(runs, n, name):
    specs, got = runs
    spec = specs[name]
    tol = TOL[spec["dtype"]]
    want = _jax_attention(spec, n)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gather(got[n], name, key, n), w,
                                   rtol=tol, atol=tol, err_msg=key)


# one trace per params structure, shared by the cases and world sizes
_apply = jax.jit(functools.partial(jtfm.apply, heads=LM["heads"],
                                   compute_dtype=jnp.float32))


def _jax_sp(spec, n):
    params = jax.tree.map(jnp.asarray, spec["params"])
    toks = jnp.asarray(spec["tokens"])
    T_local = T // n
    seq = P(None, "data")
    kw = dict(heads=spec["heads"], compute_dtype=jnp.float32,
              attn_impl=spec["impl"])

    def shard_loss(p, inp, tgt):
        shift = jax.lax.axis_index("data") * T_local
        return jtfm.loss_sp(p, inp, tgt, shift, **kw)

    def loss(p):
        return shard_map(shard_loss, mesh=make_mesh(n),
                         in_specs=(P(), seq, seq), out_specs=P())(
            p, toks[:, :-1], toks[:, 1:])

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    logits = _apply(params, toks[:, :-1])
    return float(val), jax.tree.leaves(grads), np.asarray(logits)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(SP))
def test_sp_lm_matches_jax(runs, n, name):
    """``loss_sp`` (pmean) and ``apply_sp`` at float32, each attention
    impl: the loss against JAX's ``loss_sp`` under ``shard_map``, every
    leaf's gradient (the ranks' shares summed) against JAX's, and the
    gathered logits against the one-device ``apply``."""
    specs, got = runs
    spec = specs[f"sp-{name}"]
    loss, grads, logits = _jax_sp(spec, n)
    for r in range(n):
        mine = got[n][r][f"sp-{name}"]
        np.testing.assert_allclose(mine["loss"], loss, rtol=LOSS_TOL)
        assert len(mine["grads"]) == len(grads)
        for g, w in zip(mine["grads"], grads):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=GRAD_TOL)
    np.testing.assert_allclose(_gather(got[n], f"sp-{name}", "logits", n),
                               logits, rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("n,hk", [(4, H), (4, 2), (2, 1)])
def test_ring_steps_on_one_process_give_full_attention(n, hk):
    """The n steps of an n-way ring driven through ``ring_step`` in one
    process, each rank's Q shard against every source shard at the ring's
    global offsets (the whole-shard skips included), merge to full causal
    attention, and their gradients to its gradients."""
    rng = np.random.default_rng(n + hk)
    q = torch.tensor(rng.normal(size=(B, T, H, D)), dtype=torch.float32,
                     requires_grad=True)
    k, v = (torch.tensor(rng.normal(size=(B, T, hk, D)), dtype=torch.float32,
                         requires_grad=True) for _ in range(2))
    r = torch.tensor(rng.normal(size=(B, T, H, D)), dtype=torch.float32)
    want = tfa.flash_attention(q, k, v, causal=True)
    want_grads = torch.autograd.grad((want * r).sum(), (q, k, v))
    t = T // n
    outs = []
    for rank in range(n):
        acc = lse = None
        for step in range(n):
            src = (rank - step) % n
            acc, lse = tfa.ring_step(
                q[:, rank * t:(rank + 1) * t], k[:, src * t:(src + 1) * t],
                v[:, src * t:(src + 1) * t], rank * t, src * t, acc, lse,
                causal=True)
        outs.append(acc)
    out = torch.cat(outs, dim=1)
    grads = torch.autograd.grad((out * r).sum(), (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(),
                               want.detach().numpy(), rtol=0, atol=2e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL)


def test_make_ring_attention_on_one_device_is_full_attention():
    """A ring of one (``group=None``) is one pass over the whole sequence;
    ``shard`` is the identity there."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(size=(B, 16, 2, D)),
                            dtype=torch.float32) for _ in range(3))
    attn = make_ring_attention(None, causal=True)
    assert attn.shard(q) is not None and attn.shard(q).shape == q.shape
    want = tfa.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(attn(q, k, v).numpy(), want.numpy(), rtol=0,
                               atol=2e-5)
    got = tfa.ring_flash_attention_local(q, k, v, group=None, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_ring_step_from_the_empty_state_is_the_first_step_exactly():
    """Starting the ring with the first step's own output (``acc = lse =
    None``) is the merge with the empty state (acc 0, lse -1e30), bit for
    bit in the output and in the gradients of q, k, v through both."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(B, 8, H, D)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    ra, rl = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
              for s in ((B, 8, H, D), (B, 8, H)))
    outs = []
    for start in ((None, None), (torch.zeros((B, 8, H, D)),
                                 torch.full((B, 8, H), tfa.NEG_INF))):
        acc, lse = tfa.ring_step(q, k, v, 8, 0, *start, causal=True)
        grads = torch.autograd.grad((acc * ra).sum() + (lse * rl).sum(),
                                    (q, k, v))
        outs.append([acc, lse, *grads])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
