"""The port's decoder LM (``models/transformer.py``) against the JAX package's.

2 blocks, dim 64, 4 heads, vocab 64, T = 32, the JAX package's weights
carried across. Tolerances:

- float32 compute: loss to 1e-5 relative, every gradient leaf to 1e-5
  absolute (gradients are at most ~0.2; the two sum in other orders);
- bf16 compute: loss to 5e-3 absolute and gradients to 3% of the largest
  gradient. XLA and PyTorch round the bf16 matmul outputs, the LayerNorm
  statistics and GELU at different places (8 bits of mantissa, 2^-8
  relative per rounding), and the differences pass through two blocks and
  the softmax; measured: 7e-4 on the loss, 0.8% on the gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import transformer as jtfm
from minips_tpu_torch import interop
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.utils.tree import tree_leaves, tree_rebuild

VOCAB, DIM, HEADS, DEPTH, T, B = 64, 64, 4, 2, 32, 2


def _models(kv_heads=None, rope=False):
    jp = jtfm.init(jax.random.PRNGKey(0), vocab=VOCAB, dim=DIM, heads=HEADS,
                   depth=DEPTH, max_len=T, kv_heads=kv_heads, rope=rope)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, T + 1))


# (head_chunk, remat, kv_heads, rope, compute dtype, attn_impl)
CASES = [
    (0, False, None, False, "float32", "reference"),
    (16, False, None, False, "float32", "flash"),
    (0, True, None, False, "float32", "reference"),
    (16, True, 2, False, "float32", "flash"),
    (0, False, 2, True, "float32", "reference"),
    (16, False, None, True, "float32", "flash"),
    (0, False, None, False, "bfloat16", "reference"),
    (16, False, None, False, "bfloat16", "flash"),
    (16, True, None, False, "bfloat16", "flash"),
    (0, False, 2, True, "bfloat16", "flash"),
    (16, False, 1, True, "bfloat16", "reference"),
    (0, True, 2, False, "bfloat16", "reference"),
]


@pytest.mark.parametrize("head_chunk,remat,kv_heads,rope,dtype,attn", CASES)
def test_loss_and_grads_match_jax(head_chunk, remat, kv_heads, rope, dtype,
                                  attn):
    jp, tp = _models(kv_heads, rope)
    toks = _tokens()
    kw = dict(heads=HEADS, attn_impl=attn, remat=remat,
              head_chunk=head_chunk)
    jl, jg = jax.value_and_grad(lambda p: jtfm.loss(
        p, {"tokens": jnp.asarray(toks)}, compute_dtype=getattr(jnp, dtype),
        **kw))(jp)
    tl, tg = ttfm.value_and_grad(lambda p: ttfm.loss(
        p, {"tokens": torch.from_numpy(toks)},
        compute_dtype=getattr(torch, dtype), **kw), tp)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [x.shape for x in jleaves] == [tuple(x.shape) for x in tleaves]
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        atol = 1e-5
    else:
        np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=5e-3)
        atol = 0.03 * max(float(np.abs(np.asarray(x)).max())
                          for x in jleaves)
    for want, got in zip(jleaves, tleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_params_as_make_step_hands_them(dtype):
    """Under ``make_step(compute_dtype=bf16)`` the model sees bf16 params:
    the residual stream starts in bf16 and turns float32 in the first
    block, and the gradients come back in the params' type."""
    jp, tp = _models()
    toks = _tokens(1)
    jpc = jax.tree.map(lambda x: x.astype(dtype), jp)
    tpc = tree_rebuild(tp, iter([x.to(getattr(torch, dtype))
                                 for x in tree_leaves(tp)]))
    jl, jg = jtfm.grad_fn(jpc, {"tokens": jnp.asarray(toks)}, heads=HEADS,
                          head_chunk=16)
    tl, tg = ttfm.grad_fn(tpc, {"tokens": torch.from_numpy(toks)},
                          heads=HEADS, head_chunk=16)
    assert all(x.dtype == getattr(torch, dtype) for x in tree_leaves(tg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=5e-3)
    jleaves = jax.tree.leaves(jg)
    atol = 0.03 * max(float(np.abs(np.asarray(x, np.float32)).max())
                      for x in jleaves)
    for want, got in zip(jleaves, tree_leaves(tg)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("attn", ["reference", "flash"])
def test_apply_logits_and_nll_match_jax(attn):
    jp, tp = _models()
    toks = _tokens(2)
    jlog = jtfm.apply(jp, jnp.asarray(toks[:, :-1]), heads=HEADS,
                      compute_dtype=jnp.float32, attn_impl=attn)
    tlog = ttfm.apply(tp, torch.from_numpy(toks[:, :-1]), heads=HEADS,
                      compute_dtype=torch.float32, attn_impl=attn)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(ttfm.nll(tlog, torch.from_numpy(toks[:, 1:]))),
        float(jtfm.nll(jlog, jnp.asarray(toks[:, 1:]))), rtol=1e-6)


def test_rope_decay_mask_and_init_tree():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(5, 13)
    np.testing.assert_allclose(
        ttfm.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jtfm.rope_rotate(jnp.asarray(x), jnp.asarray(pos))),
        rtol=0, atol=1e-5)
    for kv, rope in ((None, False), (2, True)):
        jp, tp = _models(kv, rope)
        mine = ttfm.init(torch.Generator().manual_seed(0), vocab=VOCAB,
                         dim=DIM, heads=HEADS, depth=DEPTH, max_len=T,
                         kv_heads=kv, rope=rope, device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(
            jax.tree.map(lambda _: 0, jax.tree.map(np.asarray, jp)))
        assert [x.shape for x in jax.tree.leaves(jp)] == \
            [tuple(x.shape) for x in tree_leaves(mine)]
        want = jtfm.decay_mask(jp)
        for a, b in zip(jax.tree.leaves(want),
                        tree_leaves(ttfm.decay_mask(tp))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_unported_options_raise():
    _, tp = _models()
    batch = {"tokens": torch.from_numpy(_tokens())}
    for mode in ("attn", "dots", "hybrid", "hybrid_qkv"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttfm.loss(tp, batch, heads=HEADS, remat=mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.loss(tp, batch, heads=HEADS, dropout=0.1)
    with pytest.raises(ValueError, match="unknown remat"):
        ttfm.loss(tp, batch, heads=HEADS, remat="all")
    with pytest.raises(ValueError, match="max_len"):
        ttfm.loss(tp, {"tokens": torch.zeros(1, T + 2, dtype=torch.long)},
                  heads=HEADS)
    with pytest.raises(ValueError, match="head chunk"):
        ttfm.loss(tp, batch, heads=HEADS, head_chunk=5)
    with pytest.raises(ValueError, match="attn_impl"):
        ttfm.loss(tp, batch, heads=HEADS, attn_impl="ring")
