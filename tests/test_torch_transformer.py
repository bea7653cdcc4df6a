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

The remat modes hold at the same tolerances, and each mode's launches of
K2, K3 and K4 (the port's wrapper calls on the CPU) equal the JAX
package's ``pallas_call`` equations of each kernel in its grad jaxpr
(traced with the kernels in interpret mode, never run). Dropout: with the
port's key folds and mask source patched to call ``jax.random``, the two
packages draw the same masks and agree at float32 to 1e-5 on logits and
gradients; the port's own masks replay exactly under every remat mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import transformer as jtfm
from minips_tpu.ops import flash_attention as jfa
from minips_tpu_torch import interop
from minips_tpu_torch.ops import flash_attention as tfa
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
    """What the port still refuses, as the JAX package refuses it; the
    remat modes and dropout, refused before they were ported, are held by
    the parity tests below."""
    _, tp = _models()
    batch = {"tokens": torch.from_numpy(_tokens())}
    with pytest.raises(ValueError, match="unknown remat"):
        ttfm.loss(tp, batch, heads=HEADS, remat="all")
    with pytest.raises(ValueError, match="max_len"):
        ttfm.loss(tp, {"tokens": torch.zeros(1, T + 2, dtype=torch.long)},
                  heads=HEADS)
    with pytest.raises(ValueError, match="head chunk"):
        ttfm.loss(tp, batch, heads=HEADS, head_chunk=5)
    with pytest.raises(ValueError, match="attn_impl"):
        ttfm.loss(tp, batch, heads=HEADS, attn_impl="ring")


# ------------------------------------------------------------------- remat
MODES = [True, "attn", "dots", "hybrid", "hybrid_qkv"]
LAYOUTS = {"mha": (None, False), "gqa2": (2, False), "rope": (None, True)}
_JAX_KERNELS = {"_flash_kernel": "flash_forward",
                "_flash_bwd_dq_kernel": "flash_bwd_dq",
                "_flash_bwd_dkv_kernel": "flash_bwd_dkv"}


def _jax_and_port_loss_grads(jp, tp, toks, dtype, **kw):
    jl, jg = jax.value_and_grad(lambda p: jtfm.loss(
        p, {"tokens": jnp.asarray(toks)}, compute_dtype=getattr(jnp, dtype),
        **kw))(jp)
    tl, tg = ttfm.value_and_grad(lambda p: ttfm.loss(
        p, {"tokens": torch.from_numpy(toks)},
        compute_dtype=getattr(torch, dtype), **kw), tp)
    return jl, jax.tree.leaves(jg), tl, tree_leaves(tg)


def _assert_match(jl, jleaves, tl, tleaves, dtype):
    """The tolerances of test_loss_and_grads_match_jax."""
    assert [x.shape for x in jleaves] == [tuple(x.shape) for x in tleaves]
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        atol = 1e-5
    else:
        np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=5e-3)
        atol = 0.03 * max(float(np.abs(np.asarray(x, np.float32)).max())
                          for x in jleaves)
    for want, got in zip(jleaves, tleaves):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("attn", ["reference", "flash"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_match_jax(mode, layout, attn):
    kv, rope = LAYOUTS[layout]
    jp, tp = _models(kv, rope)
    out = _jax_and_port_loss_grads(jp, tp, _tokens(4), "float32",
                                   heads=HEADS, attn_impl=attn, remat=mode,
                                   head_chunk=16)
    _assert_match(*out, "float32")


@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_match_jax_bf16(mode):
    jp, tp = _models(2, True)
    out = _jax_and_port_loss_grads(jp, tp, _tokens(5), "bfloat16",
                                   heads=HEADS, attn_impl="flash",
                                   remat=mode, head_chunk=16)
    _assert_match(*out, "bfloat16")


def _count_pallas(jaxpr, acc):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            name = _JAX_KERNELS[eqn.params["jaxpr"].debug_info.func_name]
            acc[name] = acc.get(name, 0) + 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    _count_pallas(sub.jaxpr, acc)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    _count_pallas(sub, acc)
    return acc


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", [False] + MODES)
def test_flash_launches_per_mode_match_jax(mode, layout, monkeypatch):
    """K2-K4 per block per step: the JAX package's pallas_call equations in
    its grad jaxpr (the kernels traced in interpret mode) against the
    port's calls of each kernel's wrapper, and both against
    ``FLASH_LAUNCHES_PER_BLOCK``."""
    kv, rope = LAYOUTS[layout]
    jp, tp = _models(kv, rope)
    toks = _tokens(6)
    kw = dict(heads=HEADS, attn_impl="flash", remat=mode, head_chunk=16)
    monkeypatch.setattr(jfa, "flash_attention",
                        functools.partial(jfa.flash_attention,
                                          interpret=True))
    jaxpr = jax.make_jaxpr(jax.value_and_grad(lambda p: jtfm.loss(
        p, {"tokens": jnp.asarray(toks)}, **kw)))(jp)
    jax_counts = _count_pallas(jaxpr.jaxpr, {})
    calls = {}
    check = tfa._check

    def counting_check(name, *args):
        calls[name] = calls.get(name, 0) + 1
        return check(name, *args)

    monkeypatch.setattr(tfa, "_check", counting_check)
    ttfm.grad_fn(tp, {"tokens": torch.from_numpy(toks)}, **kw)
    want = {k: DEPTH * n
            for k, n in ttfm.FLASH_LAUNCHES_PER_BLOCK[mode].items()}
    assert jax_counts == want
    assert calls == want


@pytest.mark.parametrize("mode,layout,attn,saved", [
    ("attn", "mha", "flash", ["attn_out"]),
    ("hybrid", "mha", "flash", ["attn_out", "mlp_hidden"]),
    ("hybrid_qkv", "mha", "flash", ["qkv", "attn_out", "mlp_hidden"]),
    ("hybrid_qkv", "gqa2", "flash", ["qkv", "qkv", "attn_out",
                                     "mlp_hidden"]),
    ("dots", "mha", "reference", ["mm"] * 6),
    ("dots", "gqa2", "reference", ["mm"] * 7),
])
def test_remat_policy_saves_the_named_tensors(mode, layout, attn, saved,
                                               monkeypatch):
    """Each block's checkpoint keeps exactly the tensors that the JAX
    policy names; under "dots" every matmul output (q/k/v, the attention's
    scores and P·V, the output projection and the two MLP matmuls, as
    ``checkpoint_dots`` saves every ``dot_general``). Everything else is
    recomputed."""
    kv, rope = LAYOUTS[layout]
    _, tp = _models(kv, rope)
    kept = []
    make = ttfm.create_selective_checkpoint_contexts

    def recording(policy):
        def wrapped(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if (decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                kept.append("mm" if mode == "dots" else ttfm._naming.name)
            return decision
        return make(wrapped)

    monkeypatch.setattr(ttfm, "create_selective_checkpoint_contexts",
                        recording)
    ttfm.grad_fn(tp, {"tokens": torch.from_numpy(_tokens(7))}, heads=HEADS,
                 attn_impl=attn, remat=mode, head_chunk=16)
    assert kept == saved * DEPTH


class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _count_dots(jaxpr):
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "dot_general"
        if eqn.primitive.name == "pallas_call":
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    n += _count_dots(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    n += _count_dots(sub)
    return n


@pytest.mark.parametrize("layout", ["mha", "gqa2"])
def test_remat_recomputes_the_matmuls_jax_recomputes(layout, monkeypatch):
    """The projection matmuls each mode runs again in the backward: the
    port's ``mm`` calls in the backward beyond remat off's against the JAX
    package's ``dot_general`` equations in its grad jaxpr beyond remat
    off's (attention in the kernels, traced in interpret mode). A saved
    tensor's producer runs once: hybrid_qkv recomputes the output
    projection alone."""
    kv, rope = LAYOUTS[layout]
    jp, tp = _models(kv, rope)
    toks = _tokens(14)
    monkeypatch.setattr(jfa, "flash_attention",
                        functools.partial(jfa.flash_attention,
                                          interpret=True))
    jax_dots, port_mms = {}, {}
    for mode in [False] + MODES:
        kw = dict(heads=HEADS, attn_impl="flash", remat=mode)
        jax_dots[mode] = _count_dots(jax.make_jaxpr(jax.value_and_grad(
            lambda p: jtfm.loss(p, {"tokens": jnp.asarray(toks)},
                                compute_dtype=jnp.float32, **kw)))(jp).jaxpr)
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tp)]
        value = ttfm.loss(tree_rebuild(tp, iter(leaves)),
                          {"tokens": torch.from_numpy(toks)},
                          compute_dtype=torch.float32, **kw)
        with _CountMatmuls() as count:
            torch.autograd.grad(value, leaves)
        port_mms[mode] = count.n
    again = {m: port_mms[m] - port_mms[False] for m in port_mms}
    assert again == {m: jax_dots[m] - jax_dots[False] for m in jax_dots}
    # per block: q/k/v (two matmuls under GQA), the output projection and
    # the MLP's first matmul, unless saved; never the last MLP matmul
    per_block = {"mha": {True: 3, "attn": 3, "dots": 0, "hybrid": 2,
                         "hybrid_qkv": 1},
                 "gqa2": {True: 4, "attn": 4, "dots": 0, "hybrid": 3,
                          "hybrid_qkv": 1}}[layout]
    assert again == {False: 0, **{m: DEPTH * n for m, n in per_block.items()}}


# ----------------------------------------------------------------- dropout
RATE = 0.2


def _jax_masks(monkeypatch):
    """The port's key folds and mask source, patched to call jax.random on
    the same fold chain: both packages then draw the same masks."""
    def fold(key, data):
        out = jax.random.fold_in(jnp.asarray(np.array(key, np.uint32)), data)
        return tuple(int(x) for x in np.asarray(out))

    def mask(key, shape, rate, device):
        keep = jax.random.bernoulli(jnp.asarray(np.array(key, np.uint32)),
                                    1.0 - rate, tuple(shape))
        return torch.from_numpy(np.array(keep)).to(device)

    monkeypatch.setattr(ttfm, "fold_in", fold)
    monkeypatch.setattr(ttfm, "keep_mask", mask)


@pytest.mark.parametrize("mode,layout,head_chunk", [
    (False, "mha", 0), (False, "gqa2", 16), ("dots", "mha", 16),
    (True, "rope", 0), ("hybrid", "gqa2", 0)])
def test_dropout_with_the_jax_masks_matches_jax(mode, layout, head_chunk,
                                                 monkeypatch):
    _jax_masks(monkeypatch)
    kv, rope = LAYOUTS[layout]
    jp, tp = _models(kv, rope)
    toks = _tokens(8)
    key = np.asarray(jax.random.PRNGKey(11))
    jl, jg = jax.value_and_grad(lambda p: jtfm.loss(
        p, {"tokens": jnp.asarray(toks), "rng": jnp.asarray(key)},
        heads=HEADS, compute_dtype=jnp.float32, attn_impl="flash",
        remat=mode, head_chunk=head_chunk, dropout=RATE))(jp)
    tl, tg = ttfm.value_and_grad(lambda p: ttfm.loss(
        p, {"tokens": torch.from_numpy(toks),
            "rng": torch.from_numpy(key.astype(np.int64))}, heads=HEADS,
        compute_dtype=torch.float32, attn_impl="flash", remat=mode,
        head_chunk=head_chunk, dropout=RATE), tp)
    _assert_match(jl, jax.tree.leaves(jg), tl, tree_leaves(tg), "float32")
    jlog = jtfm.apply(jp, jnp.asarray(toks[:, :-1]), heads=HEADS,
                      compute_dtype=jnp.float32, dropout=RATE,
                      rng=jnp.asarray(key))
    tlog = ttfm.apply(tp, torch.from_numpy(toks[:, :-1]), heads=HEADS,
                      compute_dtype=torch.float32, dropout=RATE,
                      rng=tuple(int(x) for x in key))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-5)


def _port_loss_grads(tp, toks, rng, dropout=RATE, remat=False,
                     attn="flash"):
    batch = {"tokens": torch.from_numpy(toks)}
    if rng is not None:
        batch["rng"] = rng
    return ttfm.value_and_grad(lambda p: ttfm.loss(
        p, batch, heads=HEADS, compute_dtype=torch.float32,
        attn_impl=attn, remat=remat, head_chunk=16, dropout=dropout), tp)


def _same(a, b):
    (la, ga), (lb, gb) = a, b
    return float(la) == float(lb) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(ga), tree_leaves(gb)))


def test_dropout_off_is_the_identity():
    _, tp = _models()
    toks = _tokens(9)
    key = torch.tensor([0, 5])
    plain = _port_loss_grads(tp, toks, None, dropout=0.0)
    # rate 0 ignores a key; apply without a key is the eval forward
    assert _same(plain, _port_loss_grads(tp, toks, key, dropout=0.0))
    x = torch.from_numpy(toks[:, :-1])
    kw = dict(heads=HEADS, compute_dtype=torch.float32)
    assert torch.equal(ttfm.apply(tp, x, dropout=RATE, **kw),
                       ttfm.apply(tp, x, **kw))
    assert not _same(plain, _port_loss_grads(tp, toks, key))


def test_dropout_masks_are_a_function_of_the_key():
    _, tp = _models(2, True)
    toks = _tokens(10)
    a = _port_loss_grads(tp, toks, torch.tensor([0, 5]))
    assert _same(a, _port_loss_grads(tp, toks, torch.tensor([0, 5])))
    assert _same(a, _port_loss_grads(tp, toks, np.array([[0, 5], [0, 6]])))
    assert not _same(a, _port_loss_grads(tp, toks, torch.tensor([0, 6])))
    key = ttfm.prng_key(3)
    assert key == (0, 3) and ttfm.fold_in(key, 1) == ttfm.fold_in(key, 1)
    assert len({ttfm.fold_in(key, i) for i in range(64)}) == 64
    keep = ttfm.keep_mask(key, (256, 256), RATE, torch.device("cpu"))
    assert keep.dtype == torch.bool and torch.equal(
        keep, ttfm.keep_mask(key, (256, 256), RATE, torch.device("cpu")))
    assert abs(float(keep.float().mean()) - (1 - RATE)) < 0.01


@pytest.mark.parametrize("attn", ["reference", "flash"])
@pytest.mark.parametrize("mode", MODES)
def test_dropout_masks_replay_under_remat(mode, attn):
    """A recompute draws the same masks: every mode's loss and gradients
    equal those without remat, to float rounding."""
    _, tp = _models(2, False)
    toks = _tokens(12)
    key = torch.tensor([1, 2])
    (l0, g0) = _port_loss_grads(tp, toks, key, attn=attn)
    (l1, g1) = _port_loss_grads(tp, toks, key, remat=mode, attn=attn)
    assert float(l1) == float(l0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-7)


def test_dropout_refusals():
    _, tp = _models()
    toks = _tokens(13)
    with pytest.raises(ValueError, match="needs a per-step key"):
        _port_loss_grads(tp, toks, None)
    with pytest.raises(ValueError, match=r"\[W, 2\]"):
        _port_loss_grads(tp, toks, torch.zeros(2, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="shape"):
        _port_loss_grads(tp, toks, torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="host"):
        _port_loss_grads(tp, toks, torch.zeros(2, dtype=torch.long,
                                               device="meta"))
    with pytest.raises(ValueError, match="outside"):
        _port_loss_grads(tp, toks, torch.tensor([0, 1]), dropout=1.0)
    # an eval call (rate 0) that reuses a training batch does not read
    # its key, as in the JAX package
    _port_loss_grads(tp, toks, torch.zeros(2, 3, dtype=torch.long),
                     dropout=0.0)
