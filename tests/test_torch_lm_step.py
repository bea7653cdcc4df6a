"""The port's fused dense step (``DenseTable.make_step``) on the decoder LM
against the JAX package's ``make_step`` on a one-device mesh.

2 blocks, dim 64, 4 heads, vocab 64, B = 4, T = 32, Adam at lr 1e-3, the
JAX package's weights carried across, two rotating batches, 3 steps.
Tolerances:

- float32 compute: losses to 1e-5 relative; params and Adam moments to
  1e-5 absolute.
- bf16 compute (``compute_dtype=bf16``, the slice's configuration): losses
  to 5e-3 absolute; params to 6e-3 = 2 x lr x steps. Adam moves a weight
  by about lr per step whatever its gradient's size, so a gradient near
  zero whose sign the two frameworks' bf16 rounding flips moves that
  weight by up to 2 lr per step; Adam's first moment to 3% of its largest
  value (it is the gradient's running mean, held like the gradients in
  ``test_torch_transformer.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables.dense import DenseTable as JDenseTable
from minips_tpu_torch import interop
from minips_tpu_torch.apps.lm import build_lm
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.tables.dense import DenseTable

VOCAB, DIM, HEADS, DEPTH, T, B, STEPS, LR = 64, 64, 4, 2, 32, 4, 3, 1e-3


def _grad_fns(cd, **kw):
    """(JAX, port) grad_fn: the packages' own at bf16 compute, or both
    models' matmuls in float32."""
    if cd is not None:
        return (functools.partial(jtfm.grad_fn, **kw),
                functools.partial(ttfm.grad_fn, **kw))
    return (lambda p, b: jax.value_and_grad(lambda p_: jtfm.loss(
                p_, b, compute_dtype=jnp.float32, **kw))(p),
            lambda p, b: ttfm.value_and_grad(lambda p_: ttfm.loss(
                p_, b, compute_dtype=torch.float32, **kw), p))


def _run(compute_dtype, accum=1, grad_reduce="mean", updater_kwargs=None,
         attn="flash"):
    jp = jtfm.init(jax.random.PRNGKey(0), vocab=VOCAB, dim=DIM, heads=HEADS,
                   depth=DEPTH, max_len=T)
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, VOCAB, (B, T + 1)) for _ in range(2)]
    kw = dict(heads=HEADS, attn_impl=attn, head_chunk=16)
    jt = JDenseTable(jp, make_mesh(1), name="lm", updater="adam", lr=LR,
                     grad_reduce=grad_reduce, updater_kwargs=updater_kwargs)
    jgrad, tgrad = _grad_fns(compute_dtype, **kw)
    jstep = jt.make_step(jgrad, accum=accum,
                         compute_dtype=(jnp.bfloat16 if compute_dtype
                                        else None))
    tt = DenseTable(interop.tree_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu"),
                    name="lm", updater="adam", lr=LR,
                    grad_reduce=grad_reduce,
                    updater_kwargs=updater_kwargs, device="cpu")
    interop.load_dense(tt, np.asarray(jt.params),
                       [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)])
    tstep = tt.make_step(tgrad, accum=accum, compute_dtype=compute_dtype)
    jl, tl = [], []
    for i in range(STEPS):
        jl.append(float(jt.step_inplace(jstep,
                                        {"tokens": jnp.asarray(toks[i % 2])})))
        tl.append(float(tt.step_inplace(
            tstep, {"tokens": torch.from_numpy(toks[i % 2])})))
    return jt, tt, jl, tl


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("accum,grad_reduce,kwargs", [
    (1, "mean", None),
    (2, "mean", None),
    (2, "sum", {"clip_norm": 0.5}),
])
def test_three_float32_steps_match_jax(accum, grad_reduce, kwargs):
    jt, tt, jl, tl = _run(None, accum, grad_reduce, kwargs)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    params, leaves = interop.dense_to_numpy(tt)
    _close(params, jt.params, 1e-5)
    for got, want in zip(leaves, jax.tree.leaves(jt.opt_state)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("attn", ["flash", "reference"])
def test_three_bf16_steps_match_jax(attn):
    jt, tt, jl, tl = _run(torch.bfloat16, attn=attn)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)
    params, (count, mu, nu) = interop.dense_to_numpy(tt)
    jcount, jmu, _ = jax.tree.leaves(jt.opt_state)
    assert int(count) == int(jcount) == STEPS
    _close(params, jt.params, 2 * LR * STEPS)
    _close(mu, jmu, 0.03 * float(np.abs(np.asarray(jmu)).max()))


def test_make_step_refuses_what_is_not_ported():
    t = DenseTable({"w": torch.zeros(4)}, updater="adam", device="cpu")

    def gfn(p, b):
        return torch.zeros(()), p

    # the quantized collectives are ported: only an unknown wire format is
    # refused, as the JAX package refuses it
    with pytest.raises(ValueError, match="comm must be one of"):
        t.make_step(gfn, comm="int4")
    with pytest.raises(ValueError, match="accum"):
        t.make_step(gfn, accum=0)
    step = t.make_step(gfn, accum=2)
    with pytest.raises(ValueError, match="divide by accum"):
        t.step_inplace(step, {"x": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="grad_reduce"):
        DenseTable({"w": torch.zeros(4)}, grad_reduce="max", device="cpu")


def test_build_lm_small_trains_on_cpu():
    lm = build_lm(4, 32, dim=64, depth=2, vocab=64, head_chunk=16,
                  device="cpu")
    assert lm.heads == 1 and lm.table.name == "lm"
    assert [tuple(b["tokens"].shape) for b in lm.batches] == [(4, 33)] * 2
    # the same draws as bench_lm's: default_rng(seed).integers twice
    rng = np.random.default_rng(0)
    for b in lm.batches:
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      rng.integers(0, 64, (4, 33)))
    losses = [float(lm.table.step_inplace(lm.step, lm.batches[i % 2]))
              for i in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # a model of the configuration's shape: ravel order as the JAX table's
    tree = lm.table.pull()
    assert sorted(tree) == ["blocks", "ln_f", "pos_emb", "tok_emb"]
    assert sorted(tree["blocks"][0]) == ["ln1", "ln2", "mlp_in", "mlp_out",
                                         "proj", "qkv"]
