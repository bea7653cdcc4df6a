"""Decoder-only transformer LM — the port of ``minips_tpu/models/transformer.py``
(the single-program path and the one-device MoE LM) — and LFM2.

**LFM2** (``lfm2_init``, ``lfm2_hidden``, ``lfm2_apply``, ``lfm2_loss``,
``lfm2_grad_fn``; HF's ``lfm2_moe`` equations, built from the published
configuration by ``apps/lm.py``'s ``build_lm``): layers of two kinds in
the configuration's ``layer_types``, each ``h += mixer(RMSNorm(h))`` then
``h += ffn(RMSNorm(h))`` on a float32 residual stream. The mixer is the
gated short conv (``_lfm2_conv``: ``[B | C | x] = in_proj(a)``, a
depthwise causal conv of width ``conv_L_cache`` over ``B ⊙ x`` as shifted
multiply-adds, ``out_proj(C ⊙ conv)``; the span ``conv``) or GQA
attention with RMSNorm over the head dim on q and k and RoPE at
``rope_theta`` (``_lfm2_attn``, through :func:`_attn_fn` and
:func:`rope_rotate`). The FFN is a SwiGLU in the leading
``num_dense_layers`` and ``parallel/moe.py``'s dropless MoE after them;
the head is tied to the embedding (``nll_chunked``). Every remat mode
checkpoints each layer of either kind with the same policies as the GPT
blocks (``_producing("qkv")``, ``"attn_out"``, ``"mlp_hidden"`` on the
dense SwiGLU's gate and up product).

Plain-tree params like the other models, so the whole LM lives in one
``DenseTable``: pre-LN blocks, learned positional embeddings (or RoPE), a
GELU MLP, a weight-tied head. Matmuls run in ``compute_dtype`` (bf16 by
default) with float32 params; the residual stream turns float32 after the
first block's attention projection, exactly where the JAX package casts.
Attention is ``reference`` (plain O(T^2) scores) or ``flash`` (K2–K4 on the
card, their plain versions on the CPU).

**Remat.** ``remat=True`` recomputes whole blocks in the backward
(``torch.utils.checkpoint``). The selective modes save what the JAX
package's ``_remat_policy`` saves and recompute the rest:
``"attn"`` the attention output, ``"hybrid"`` it and the pre-GELU MLP
hidden, ``"hybrid_qkv"`` those and the q/k/v projection, ``"dots"`` every
matmul output. They run as ``torch.utils.checkpoint`` with a selective
policy (``create_selective_checkpoint_contexts``), which sees dispatcher
ops: q/k/v and the MLP hidden are the outputs of matmuls issued inside
``_producing(name)``, which the policy saves (so a recompute skips those
matmuls, as XLA drops a saved value's producer), and the attention output
passes through :func:`checkpoint_name`, an ``aten.alias`` issued while its
name is set; under ``"dots"`` the policy saves the outputs of every
``mm``/``bmm``. The flash kernels launch through ``ctypes`` inside an
autograd function, which the policy cannot see, so every mode recomputes
the attention forward (K2) in the backward, as every JAX mode does (no
policy there saves the logsumexp): K2 runs twice per block per step under
any remat, K3 and K4 once (:data:`FLASH_LAUNCHES_PER_BLOCK`).

**Dropout** (GPT-style: the embedding and each block's two residual
branches) keeps the JAX package's key structure with an RNG of its own,
since torch cannot replay ``jax.random``. A key is a pair of 32-bit words
on the host. ``batch["rng"]`` carries one per step, as a CPU tensor or
array of shape ``[2]``, or ``[W, 2]`` (one per worker; a rank reads its
first row); ``lm_example`` makes them from ``prng_key(seed + 71)`` folded
with the step and then the worker. :func:`fold_in` derives the embedding's
key with ``2**20``, block ``i``'s with ``i``, and within a block the
attention branch's with 0 and the MLP's with 1. :func:`keep_mask` turns a
key into a mask: uniforms from a fresh ``torch.Generator`` on the tensor's
device seeded from the key, kept below ``1 - rate``. A mask is a pure
function of (step key, block, site), so a remat recompute draws the same
one; the key never leaves the host, so no step reads the card back for it.
The refusals are the JAX package's: dropout with no key, a 2-D key stack
that is not ``[W, 2]``; and a key on the card is refused too.

**Parallel layouts** over ``torch.distributed`` groups (one process per
device; each function is called by every rank of its group together):

- ``apply_sp`` / ``loss_sp`` / ``sp_train_wiring``: sequence parallel, the
  tokens sharded on T, attention a ring (``reference`` or ``flash``: K2
  on every ring step, K3/K4 in its backward) or an all-to-all re-shard to
  head groups (``a2a``, ``a2a_flash``);
- ``apply_tp``: Megatron tensor parallel, the block weights cut per
  ``tp_specs``, ``copy_to_group`` on the activation entering each
  column-parallel matmul and ``reduce_from_group`` after each
  row-parallel one (two all-reduces per block forward, two backward);
- ``apply_pp``: GPipe over stacked blocks cut per ``pp_specs``;
- ``apply_ep``: the MoE LM with its experts cut per ``ep_lm_specs``.

A spec tree has the params' structure and, at each leaf, the dim that
leaf is sharded on over its group, or None;
``parallel/partition.py:shard_params`` cuts a rank's shard. Gradients are
taken on each rank (see ``parallel/mesh.py`` on the collectives'
backward): a leaf replicated over the data group, which shards the batch,
holds this rank's share of its gradient, which the caller sums over that
group.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from minips_tpu_torch.parallel.mesh import (DeviceLike, Group,
                                            copy_to_group, pmean,
                                            reduce_from_group,
                                            resolve_device, world)
from minips_tpu_torch.parallel.ring_attention import reference_attention
from minips_tpu_torch.utils.profiling import Annotation
from minips_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                        value_and_grad)

# K2, K3 and K4 launches per block per training step under each remat
# mode: the pallas_call equations of each kernel in the JAX package's grad
# jaxpr (forward plus recompute), which tests/test_torch_transformer.py
# counts on both sides
FLASH_LAUNCHES_PER_BLOCK = {
    mode: {"flash_forward": 1 if mode is False else 2, "flash_bwd_dq": 1,
           "flash_bwd_dkv": 1}
    for mode in (False, True, "attn", "dots", "hybrid", "hybrid_qkv")}
# the tensors each selective mode saves, by their checkpoint names
_SAVED_NAMES = {"attn": ("attn_out",), "hybrid": ("attn_out", "mlp_hidden"),
                "hybrid_qkv": ("attn_out", "mlp_hidden", "qkv")}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
_naming = threading.local()
_M32 = 0xFFFFFFFF
EMBED_SITE = 2 ** 20  # the embedding dropout's fold, as in the JAX package


def init(gen: torch.Generator, *, vocab: int = 256, dim: int = 64,
         heads: int = 4, depth: int = 2, max_len: int = 1024,
         mlp_mult: int = 4, kv_heads: Optional[int] = None,
         rope: bool = False, device: DeviceLike = None):
    """The JAX package's ``init`` tree and scales, drawn from ``gen`` (a
    ``torch.Generator`` on ``device``): ``kv_heads < heads`` builds the
    grouped-query layout (``wq`` and a fused ``wkv`` [dim, 2, kv width]),
    otherwise one fused ``qkv`` [dim, 3, dim]; ``rope=True`` has no
    ``pos_emb``. torch draws other numbers than ``jax.random``: parity
    tests carry the JAX package's weights across instead."""
    device = resolve_device(device)
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")
    gqa = kv_heads is not None and kv_heads != heads
    if gqa and (kv_heads < 1 or heads % kv_heads):
        raise ValueError(f"kv_heads {kv_heads} must be >= 1 and divide "
                         f"heads {heads}")
    hd = dim // heads
    if rope and hd % 2:
        raise ValueError(f"rope needs an even head dim (dim/heads = {hd})")

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def ln():
        return {"g": torch.ones(dim, device=device),
                "b": torch.zeros(dim, device=device)}

    scale = dim ** -0.5
    params = {"tok_emb": normal(vocab, dim, scale=scale), "ln_f": ln(),
              "blocks": []}
    if not rope:
        params["pos_emb"] = normal(max_len, dim, scale=scale)
    for _ in range(depth):
        blk = {"ln1": ln(), "ln2": ln(),
               "proj": normal(dim, dim, scale=scale),
               "mlp_in": normal(dim, mlp_mult * dim, scale=scale),
               "mlp_out": normal(mlp_mult * dim, dim,
                                 scale=(mlp_mult * dim) ** -0.5)}
        if gqa:
            blk["wq"] = normal(dim, dim, scale=scale)
            blk["wkv"] = normal(dim, 2, kv_heads * hd, scale=scale)
        else:
            blk["qkv"] = normal(dim, 3, dim, scale=scale)
        params["blocks"].append(blk)
    return params


def _ln(x, p):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)  # jnp.var: population
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


# ------------------------------------------------------------------ dropout
def _mix32(x: int) -> int:
    """A bijective 32-bit integer hash (xor-shift, multiply; twice)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def prng_key(seed: int) -> tuple:
    """A raw key from a seed, the two words ``jax.random.PRNGKey`` holds:
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    return ((seed >> 32) & _M32, seed & _M32)


def fold_in(key, data: int) -> tuple:
    """A new key from ``key`` and an integer, on the host (the role of
    ``jax.random.fold_in``; other numbers)."""
    k0, k1 = key
    a = _mix32(k0 ^ _mix32(data & _M32))
    b = _mix32(k1 ^ _mix32((data ^ 0x9E3779B9) & _M32) ^ a)
    return (_mix32(a ^ b), b)


def keep_mask(key, shape, rate: float, device) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask of ``shape`` on ``device``, a pure
    function of its arguments: uniforms drawn by a fresh generator on the
    device seeded from the key, kept where below ``1 - rate`` (the rule of
    ``jax.random.bernoulli``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((key[0] << 32) | key[1])
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def _dropout(x, rate, key):
    """Inverted dropout; the identity when rate is 0 or no key is given
    (eval)."""
    if not rate or key is None:
        return x
    keep = keep_mask(key, x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _step_key(rng, dropout: float):
    """The step's key from ``batch["rng"]`` under the contract in the module
    docstring; None when dropout is off."""
    if not dropout:
        return None
    if rng is None:
        raise ValueError('dropout > 0 needs a per-step key in '
                         'batch["rng"] (the fused step is pure)')
    if torch.is_tensor(rng):
        if rng.device.type != "cpu":
            raise ValueError(
                'batch["rng"] must lie on the host (a CPU tensor or an '
                'array): a key on the card would be read back every step')
        rng = rng.numpy()
    rng = np.asarray(rng)
    if rng.ndim == 2:
        # one key per worker: a rank's batch carries its own rows first
        if rng.shape[-1] != 2:
            raise ValueError(f'batch["rng"] 2-D stack must be [W, 2] raw '
                             f'uint32 keys, got {rng.shape}')
        rng = rng[0]
    if rng.shape != (2,):
        raise ValueError(f'batch["rng"] must be a [2] key or a [W, 2] '
                         f'stack, got shape {rng.shape}')
    return (int(rng[0]) & _M32, int(rng[1]) & _M32)


# -------------------------------------------------------------------- remat
@contextlib.contextmanager
def _producing(name: str):
    """The matmuls issued inside produce the tensor ``name``: a selective
    policy that saves ``name`` saves their outputs, so that a recompute
    skips them, as XLA drops a saved value's producer."""
    _naming.name = name
    try:
        yield
    finally:
        _naming.name = None


def checkpoint_name(x, name: str):
    """``x`` tagged ``name`` for the selective remat policies: an
    ``aten.alias`` of it (no copy) issued while the name is set. For a
    tensor that no matmul of the block produces (the attention output);
    its producer is recomputed all the same."""
    with _producing(name):
        return torch.ops.aten.alias(x)


def _remat_policy(remat):
    """The ``context_fn`` of the block checkpoint for a remat mode (None
    for ``True``: recompute the whole block). ``"attn"``, ``"hybrid"`` and
    ``"hybrid_qkv"`` save the tensors that the JAX package's
    ``save_only_these_names`` names, ``"dots"`` every matmul output, as
    ``checkpoint_dots``."""
    if remat is True:
        return None
    if remat == "dots":
        names, dots = (), True
    elif remat in _SAVED_NAMES:
        names, dots = _SAVED_NAMES[remat], False
    else:
        raise ValueError(f"unknown remat mode {remat!r} "
                         "(expected True/False, 'attn', 'dots', 'hybrid' "
                         "or 'hybrid_qkv')")

    def policy(ctx, op, *args, **kwargs):
        named = getattr(_naming, "name", None) in names
        if op in _MATMULS and (dots or named) or (
                named and op is torch.ops.aten.alias.default):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


# ------------------------------------------------------------------- blocks
def _block(h, blk, heads, attn_fn, compute_dtype, ffn_fn=None, dropout=0.0,
           rng=None, group=None):
    """One pre-LN block: attention, then :func:`_block_tail`. Returns
    ``(h, aux)``. With a model ``group`` the block is Megatron tensor
    parallel: the q/k/v and MLP-in weights arrive cut on their output dim
    (this rank computes heads/n heads and hidden/n units), the output
    projection and MLP-out on their input dim, and the activations stay
    replicated."""
    B, T, _ = h.shape
    local_heads = heads // world(group)[1]
    x = copy_to_group(_ln(h, blk["ln1"]).to(compute_dtype), group)
    # q/k/v stay in compute_dtype: the kernels run their dots at the input
    # type with float32 sums
    if "wkv" in blk:
        wq, wkv = blk["wq"].to(compute_dtype), blk["wkv"].to(compute_dtype)
        with _producing("qkv"):
            q = x @ wq
            kv = (x @ wkv.reshape(wkv.shape[0], -1)).view(B, T, 2, -1)
        hd = q.shape[-1] // local_heads
        q = q.view(B, T, local_heads, hd)
        k = kv[:, :, 0].reshape(B, T, -1, hd)
        v = kv[:, :, 1].reshape(B, T, -1, hd)
    else:
        w = blk["qkv"].to(compute_dtype)
        with _producing("qkv"):
            qkv = (x @ w.reshape(w.shape[0], -1)).view(B, T, 3, -1)
        hd = qkv.shape[-1] // local_heads
        q, k, v = (qkv[:, :, i].reshape(B, T, local_heads, hd)
                   for i in range(3))
    a = attn_fn(q, k, v).reshape(B, T, -1)
    return _block_tail(h, blk, a, compute_dtype, ffn_fn, dropout, rng, group)


def _block_tail(h, blk, a, compute_dtype, ffn_fn=None, dropout=0.0,
                rng=None, group=None):
    """Output projection + residual, then the MLP (or ``ffn_fn(blk, x_2d
    [B*T, D]) -> (y_2d, aux)``, the MoE layer) + residual; the residual
    stream turns float32 here. Shared by the training block and the
    KV-cached decode block (``models/decode.py``). Returns ``(h, aux)``, aux
    0 for the dense MLP. A model ``group`` sums the two row-parallel
    products over its ranks before each residual add."""
    a = checkpoint_name(a, "attn_out")
    att = reduce_from_group(
        (a.to(compute_dtype) @ blk["proj"].to(compute_dtype)).float(), group)
    if dropout and rng is not None:  # GPT-style residual dropout
        att = _dropout(att, dropout, fold_in(rng, 0))
    h = h + att
    if ffn_fn is not None:
        B, T, D = h.shape
        y, aux = ffn_fn(blk, _ln(h, blk["ln2"]).reshape(B * T, D))
        return h + y.reshape(B, T, D), aux
    x = copy_to_group(_ln(h, blk["ln2"]).to(compute_dtype), group)
    w_in = blk["mlp_in"].to(compute_dtype)
    # the pre-GELU hidden: GELU's backward reads its input, so the hybrid
    # modes save this tensor, not its activation
    with _producing("mlp_hidden"):
        z = x @ w_in
    x = F.gelu(z, approximate="tanh")   # jax.nn.gelu's default
    m = reduce_from_group((x @ blk["mlp_out"].to(compute_dtype)).float(),
                          group)
    if dropout and rng is not None:
        m = _dropout(m, dropout, fold_in(rng, 1))
    return h + m, 0.0


def _forward(params, tokens, pos, heads, attn_fn, compute_dtype, ffn_fn=None,
             remat=False, head=True, dropout=0.0, rng=None, group=None,
             apply_blocks=None):
    """``(logits [B, T, vocab] float32, aux)``, or with ``head=False`` the
    final normed hidden state in place of the logits (the chunked-CE path
    applies the tied head itself). ``aux`` sums the blocks' MoE
    load-balancing losses (0 for dense blocks). ``remat`` checkpoints each
    block (see the module docstring); ``dropout`` with a key ``rng``
    applies GPT-style dropout. ``group`` is the blocks' tensor-parallel
    group; ``apply_blocks(h)`` replaces the loop over the blocks (the
    pipeline schedule), sharing the embedding, the final LN and the
    head."""
    context_fn = _remat_policy(remat) if remat else None
    if "pos_emb" in params:
        max_len = params["pos_emb"].shape[0]
        if pos.shape[0] > max_len:
            raise ValueError(f"sequence length {pos.shape[0]} exceeds the "
                             f"model's max_len {max_len}")
        h = params["tok_emb"][tokens] + params["pos_emb"][pos]
    else:
        h = params["tok_emb"][tokens]
        if attn_fn is not None:
            attn_fn = _rope_wrap(attn_fn, pos)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout rate {dropout} outside [0, 1)")
    if dropout and apply_blocks is not None:
        # the per-block residual dropout lives in the loop that the
        # schedule replaces: refuse rather than drop it
        raise ValueError("dropout > 0 is not supported on parallel-"
                         "schedule (apply_blocks) paths: per-block "
                         "residual dropout lives in the sequential loop")
    aux_total = 0.0
    if dropout and rng is not None:  # embedding dropout (GPT-style)
        h = _dropout(h, dropout, fold_in(rng, EMBED_SITE))
    if apply_blocks is not None:
        h = apply_blocks(h)
    for i, blk in enumerate(params["blocks"] if apply_blocks is None
                            else ()):
        blk_rng = (fold_in(rng, i) if dropout and rng is not None else None)
        args = (h, blk, heads, attn_fn, compute_dtype, ffn_fn, dropout,
                blk_rng, group)
        if remat:
            h, aux = checkpoint(_block, *args, use_reentrant=False,
                                context_fn=context_fn or noop_context_fn)
        else:
            h, aux = _block(*args)
        aux_total = aux_total + aux
    h = _ln(h, params["ln_f"])
    if not head:
        return h, aux_total
    return ((h.to(compute_dtype)
             @ params["tok_emb"].T.to(compute_dtype)).float(), aux_total)


def decay_mask(params):
    """Params-shaped 0/1 tree for AdamW's decoupled weight decay: 1 on
    matrices (ndim >= 2), 0 on LayerNorm gains and biases."""
    return tree_map(lambda x: torch.full_like(x, float(x.dim() >= 2)),
                    params)


def rope_rotate(x, pos, theta: float = 10000.0):
    """Rotary position embedding on ``x`` ``[B, T, H, hd]`` at GLOBAL
    positions ``pos`` ``[T]``: half-split pairs rotated by
    ``pos · theta^(-2i/hd)``, angles in float32, the product in x's type."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_wrap(attn_fn, pos):
    """Attention with RoPE applied to Q and K (never V)."""
    return lambda q, k, v: attn_fn(rope_rotate(q, pos), rope_rotate(k, pos),
                                   v)


def _attn_fn(attn_impl: str):
    """Causal attention by name: ``reference`` (plain scores) or ``flash``
    (K2–K4 on the card, their plain versions on the CPU)."""
    if attn_impl == "flash":
        from minips_tpu_torch.ops.flash_attention import flash_attention

        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    if attn_impl != "reference":
        raise ValueError(f"unknown attn_impl {attn_impl!r} "
                         "(expected 'reference' or 'flash')")
    return lambda q, k, v: reference_attention(q, k, v, causal=True)


def apply(params, tokens, *, heads=4, compute_dtype=torch.bfloat16,
          remat=False, attn_impl="reference", dropout=0.0, rng=None):
    """Logits ``[B, T, vocab]``; plain causal attention in one program.
    ``dropout`` with a key ``rng`` (a pair of words, :func:`prng_key`)
    applies GPT-style dropout, train-time only."""
    T = tokens.shape[1]
    return _forward(params, tokens, torch.arange(T, device=tokens.device),
                    heads, _attn_fn(attn_impl), compute_dtype, remat=remat,
                    dropout=dropout, rng=rng)[0]


def _sp_attn(attn_impl: str, group: Group):
    """Causal sequence-parallel attention over ``group`` by name: a ring
    (``reference``: online softmax; ``flash``: :func:`ring_step` per hop)
    or an all-to-all re-shard to head groups (``a2a``: the plain oracle
    inside; ``a2a_flash``: ``flash_attention``, K2–K4 on the card)."""
    if attn_impl == "flash":
        from minips_tpu_torch.ops.flash_attention import (
            ring_flash_attention_local)

        return lambda q, k, v: ring_flash_attention_local(
            q, k, v, group=group, causal=True)
    if attn_impl == "reference":
        from minips_tpu_torch.parallel.ring_attention import (
            ring_attention_local)

        return lambda q, k, v: ring_attention_local(q, k, v, group=group,
                                                    causal=True)
    if attn_impl in ("a2a", "a2a_flash"):
        from minips_tpu_torch.parallel.a2a_attention import (
            a2a_attention_local)

        inner = None
        if attn_impl == "a2a_flash":
            from minips_tpu_torch.ops.flash_attention import flash_attention

            inner = flash_attention  # a2a passes causal and scale
        return lambda q, k, v: a2a_attention_local(
            q, k, v, group=group, causal=True, inner=inner)
    raise ValueError(f"unknown attn_impl {attn_impl!r} (expected "
                     "'reference', 'flash', 'a2a', or 'a2a_flash')")


def apply_sp(params, tokens_local, shift: int, *, heads=4,
             group: Group = None, compute_dtype=torch.bfloat16, remat=False,
             attn_impl="reference"):
    """Sequence-parallel logits for this rank's token shard ``[B,
    T_local]`` at global offset ``shift`` (``rank · T_local``): full
    params, activations sharded on T, positions (learned or RoPE) at
    their global values. ``attn_impl`` as :func:`_sp_attn`; ``a2a`` and
    ``a2a_flash`` need heads divisible by the group size."""
    T_local = tokens_local.shape[1]
    pos = shift + torch.arange(T_local, device=tokens_local.device)
    return _forward(params, tokens_local, pos, heads,
                    _sp_attn(attn_impl, group), compute_dtype,
                    remat=remat)[0]


def sp_train_wiring(heads, T_local: int, group: Group = None,
                    attn_impl="reference"):
    """``(grad_fn, shard_batch)`` for sequence-parallel training through
    ``DenseTable.make_step(group=...)``: ``shard_batch(tokens)`` cuts this
    rank's ``{"inp", "tgt"}`` shards of a global ``[B, T+1]`` token batch
    (every rank holds all B rows, its slice of T), and ``grad_fn`` takes
    the shard-local loss at this rank's shift (``reduce="local"``: the
    step's 1/n already averages the ranks' gradients)."""
    rank = world(group)[0]
    cols = slice(rank * T_local, (rank + 1) * T_local)

    def sp_grad(params, batch):
        return value_and_grad(lambda p: loss_sp(
            p, batch["inp"], batch["tgt"], rank * T_local, heads=heads,
            group=group, reduce="local", attn_impl=attn_impl), params)

    def shard_batch(tokens):
        return {"inp": tokens[:, :-1][:, cols], "tgt": tokens[:, 1:][:, cols]}

    return sp_grad, shard_batch


def _replicated(tree):
    return tree_map(lambda _: None, tree)


def apply_tp(params, tokens, *, heads=4, group: Group = None,
             compute_dtype=torch.bfloat16):
    """Megatron tensor-parallel logits over the model ``group``: the block
    weights are this rank's shards per :func:`tp_specs`, the embeddings
    and LNs whole, the activations replicated; plain causal attention on
    this rank's heads/n heads."""
    tp = world(group)[1]
    if heads % tp:
        raise ValueError(f"heads {heads} not divisible by tensor-parallel "
                         f"size {tp} (head-boundary sharding)")
    blk0 = params["blocks"][0]
    if "wkv" in blk0:
        # the shard's kv width must be whole kv heads
        hd = params["tok_emb"].shape[1] // heads
        local_w = blk0["wkv"].shape[2]
        if local_w % hd:
            raise ValueError(
                f"GQA kv_heads {local_w * tp // hd} not divisible by "
                f"tensor-parallel size {tp} (each shard needs whole kv "
                f"heads)")
    T = tokens.shape[1]
    return _forward(params, tokens, torch.arange(T, device=tokens.device),
                    heads,
                    lambda q, k, v: reference_attention(q, k, v, causal=True),
                    compute_dtype, group=group)[0]


def tp_specs(params):
    """:func:`apply_tp`'s spec tree: each block's q/k/v (``qkv``, or GQA's
    ``wq`` and ``wkv``) and ``mlp_in`` cut on their output dim, ``proj``
    and ``mlp_out`` on their input dim, at head boundaries; the rest
    replicated."""
    def one_block(blk):
        out = {"ln1": _replicated(blk["ln1"]), "ln2": _replicated(blk["ln2"]),
               "proj": 0, "mlp_in": 1, "mlp_out": 0}
        if "wkv" in blk:
            out["wq"], out["wkv"] = 1, 2
        else:
            out["qkv"] = 2
        return out

    return {**{k: None for k in ("tok_emb", "pos_emb") if k in params},
            "ln_f": _replicated(params["ln_f"]),
            "blocks": [one_block(b) for b in params["blocks"]]}


def apply_pp(params, tokens, *, heads=4, group: Group = None,
             num_microbatches=4, compute_dtype=torch.bfloat16):
    """GPipe pipeline-parallel logits over the model ``group``:
    ``params["blocks"]`` is this rank's stage, a stacked tree
    (``parallel/pipeline.py:stack_layers``) cut on its depth axis per
    :func:`pp_specs`; the batch splits into ``num_microbatches``."""
    from minips_tpu_torch.parallel.pipeline import gpipe

    B, T = tokens.shape
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible into "
                         f"{num_microbatches} microbatches")
    blocks_local = params["blocks"]
    depth_local = tree_leaves(blocks_local)[0].shape[0]
    pos = torch.arange(T, device=tokens.device)
    attn = lambda q, k, v: reference_attention(  # noqa: E731
        q, k, v, causal=True)
    if "pos_emb" not in params:  # the stage closure, not _forward, wraps
        attn = _rope_wrap(attn, pos)

    def stage_fn(x):
        for i in range(depth_local):
            x, _ = _block(x, tree_map(lambda t: t[i], blocks_local), heads,
                          attn, compute_dtype)
        return x

    def piped_blocks(h):
        h_mb = h.reshape(num_microbatches, B // num_microbatches, T, -1)
        return gpipe(stage_fn, h_mb, group=group).reshape(B, T, -1)

    return _forward(params, tokens, pos, heads, None, compute_dtype,
                    apply_blocks=piped_blocks)[0]


def pp_specs(params_stacked):
    """:func:`apply_pp`'s spec tree: every stacked block leaf cut on its
    depth axis; the rest replicated."""
    return {**{k: None for k in ("tok_emb", "pos_emb")
               if k in params_stacked},
            "ln_f": _replicated(params_stacked["ln_f"]),
            "blocks": tree_map(lambda _: 0, params_stacked["blocks"])}


def init_moe_lm(gen: torch.Generator, *, vocab: int = 256, dim: int = 64,
                heads: int = 4, depth: int = 2, max_len: int = 1024,
                num_experts: int = 8, expert_hidden: int = 256,
                kv_heads: Optional[int] = None, rope: bool = False,
                device: DeviceLike = None):
    """The LM whose FFNs are Switch-style MoE layers
    (``parallel/moe.py``): ``init``'s attention, each block's MLP replaced
    by a router and stacked expert weights (``blk["moe"]``)."""
    from minips_tpu_torch.parallel.moe import init_moe

    device = resolve_device(device)
    base = init(gen, vocab=vocab, dim=dim, heads=heads, depth=depth,
                max_len=max_len, mlp_mult=1, kv_heads=kv_heads, rope=rope,
                device=device)
    for blk in base["blocks"]:
        del blk["mlp_in"], blk["mlp_out"]
        blk["moe"] = init_moe(gen, num_experts, dim, expert_hidden,
                              device=device)
    return base


def apply_moe_dense(params, tokens, *, heads=4, capacity: int,
                    compute_dtype=torch.bfloat16, k_top: int = 1):
    """The MoE LM on one device, plain causal attention: ``(logits
    [B, T, vocab], total aux loss)``."""
    from minips_tpu_torch.parallel.moe import moe_apply_dense

    return _forward(
        params, tokens, torch.arange(tokens.shape[1], device=tokens.device),
        heads, lambda q, k, v: reference_attention(q, k, v, causal=True),
        compute_dtype,
        ffn_fn=lambda blk, x: moe_apply_dense(
            blk["moe"], x, capacity=capacity, compute_dtype=compute_dtype,
            k_top=k_top))


def apply_ep(params, tokens_local, *, heads=4, group: Group = None,
             capacity: int, compute_dtype=torch.bfloat16, k_top: int = 1):
    """Expert-parallel MoE-LM ``(logits, aux)`` for this rank's batch shard:
    attention data-parallel with whole weights, each block's experts this
    rank's shard per :func:`ep_lm_specs`, every FFN's tokens sent to their
    experts by all-to-all over ``group``."""
    from minips_tpu_torch.parallel.moe import moe_apply_local

    return _forward(
        params, tokens_local,
        torch.arange(tokens_local.shape[1], device=tokens_local.device),
        heads, lambda q, k, v: reference_attention(q, k, v, causal=True),
        compute_dtype,
        ffn_fn=lambda blk, x: moe_apply_local(
            blk["moe"], x, group=group, capacity=capacity,
            compute_dtype=compute_dtype, k_top=k_top))


def ep_lm_specs(params):
    """:func:`apply_ep`'s spec tree: each block's expert stacks cut on the
    expert dim (``parallel/moe.py:ep_specs``); the rest replicated."""
    from minips_tpu_torch.parallel.moe import ep_specs

    def one_block(blk):
        out = _replicated({k: v for k, v in blk.items() if k != "moe"})
        out["moe"] = ep_specs()
        return out

    return {**{k: None for k in ("tok_emb", "pos_emb") if k in params},
            "ln_f": _replicated(params["ln_f"]),
            "blocks": [one_block(b) for b in params["blocks"]]}


def nll(logits, targets):
    """Mean next-token negative log-likelihood."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets[..., None])[..., 0])


def _chunk_nll_sum(hc, tok_emb, tc, compute_dtype):
    logits = (hc.to(compute_dtype) @ tok_emb.T.to(compute_dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tc[..., None]).sum()


def nll_chunked(h, tok_emb, targets, chunk, compute_dtype=torch.bfloat16):
    """Tied head + cross-entropy over sequence chunks of ``chunk``: each
    chunk's logits exist only inside its ``torch.utils.checkpoint`` (the
    backward recomputes them), the chunk sums add in float32, and the total
    divides by B·T — the full ``[B, T, vocab]`` logits never exist."""
    B, T, _ = h.shape
    if T % chunk:
        raise ValueError(f"seq len {T} must divide by head chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, h[:, c0:c0 + chunk], tok_emb,
            targets[:, c0:c0 + chunk], compute_dtype, use_reentrant=False)
    return total / (B * T)


def loss(params, batch, *, heads=4, compute_dtype=torch.bfloat16,
         attn_impl="reference", remat=False, head_chunk=0, dropout=0.0):
    """Next-token cross-entropy; ``batch = {"tokens": [B, T+1]}`` integer
    ids. ``head_chunk > 0`` takes the tied head and the CE in sequence
    chunks (:func:`nll_chunked`). ``dropout > 0`` reads the step's key from
    ``batch["rng"]`` (the contract in the module docstring) and raises
    without one."""
    toks = batch["tokens"].long()
    rng = _step_key(batch.get("rng"), dropout)
    if head_chunk:
        T = toks.shape[1] - 1
        h, _ = _forward(params, toks[:, :-1],
                        torch.arange(T, device=toks.device), heads,
                        _attn_fn(attn_impl), compute_dtype, remat=remat,
                        head=False, dropout=dropout, rng=rng)
        return nll_chunked(h, params["tok_emb"], toks[:, 1:], head_chunk,
                           compute_dtype)
    logits = apply(params, toks[:, :-1], heads=heads,
                   compute_dtype=compute_dtype, attn_impl=attn_impl,
                   remat=remat, dropout=dropout, rng=rng)
    return nll(logits, toks[:, 1:])


def loss_sp(params, tokens_local, targets_local, shift: int, *, heads=4,
            group: Group = None, compute_dtype=torch.bfloat16,
            reduce="pmean", attn_impl="reference"):
    """This rank's next-token loss over its sequence shard.
    ``reduce="pmean"`` gives the global mean (replicated);
    ``reduce="local"`` the shard's own mean, for ``make_step``, whose push
    already averages the ranks' gradients."""
    logits = apply_sp(params, tokens_local, shift, heads=heads, group=group,
                      compute_dtype=compute_dtype, attn_impl=attn_impl)
    local = nll(logits, targets_local)
    if reduce == "local":
        return local
    return pmean(local, group)


def grad_fn(params, batch, *, heads=4, attn_impl="reference", remat=False,
            head_chunk=0, dropout=0.0):
    """``(loss, grads)`` of :func:`loss` at its bf16 compute type, as the
    JAX package's ``grad_fn``. Under ``DenseTable.make_step(compute_dtype=
    bf16)`` the leaves it differentiates are the bf16 copies, as in JAX."""
    return value_and_grad(lambda p: loss(
        p, batch, heads=heads, attn_impl=attn_impl, remat=remat,
        head_chunk=head_chunk, dropout=dropout), params)


# --------------------------------------------------------------------- LFM2
def _lfm2_ffn_kind(config: dict, i: int) -> str:
    """``"dense"`` for the leading ``num_dense_layers``, else ``"moe"``."""
    return "dense" if i < config["num_dense_layers"] else "moe"


def lfm2_init(gen: torch.Generator, config: dict,
              device: DeviceLike = None) -> dict:
    """LFM2's parameter tree from its published configuration (HF's
    ``lfm2_moe`` keys; ``num_experts`` the experts held here, from
    ``expert_offset``, of ``published_num_experts``), drawn from ``gen``
    (a ``torch.Generator`` on ``device``) in this order, each matrix
    normal at fan-in^-1/2 and each norm gain 1: ``tok_emb [V, D]`` (scale
    D^-1/2), then layer by layer its mixer (conv: ``in_proj [D, 3D]``
    (B, C, x), ``conv [D, L]`` (fan-in L), ``out_proj [D, D]``; attention:
    ``wq [D, H·hd]``, ``wkv [D, 2, Hk·hd]``, ``out_proj [H·hd, D]``, the
    gains ``q_norm``, ``k_norm [hd]``), then its FFN (dense: ``w13 [D,
    2F]``, ``w2 [F, D]``; MoE: ``parallel/moe.py``'s ``init_dropless``),
    then its gains ``norm1``, ``norm2``; last ``norm_f``. The expert bias
    is no parameter (a constant, :func:`lfm2_expert_bias`)."""
    from minips_tpu_torch.parallel.moe import init_dropless

    device = resolve_device(device)
    if config["conv_bias"]:
        raise ValueError("conv_bias true is not supported (LFM2 publishes "
                         "false)")
    D, V = config["hidden_size"], config["vocab_size"]
    H, Hk = config["num_attention_heads"], config["num_key_value_heads"]
    hd, L = D // H, config["conv_L_cache"]
    F_dense = config["intermediate_size"]

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def ones(n):
        return torch.ones(n, device=device)

    params = {"tok_emb": normal(V, D, scale=D ** -0.5), "blocks": []}
    for i, kind in enumerate(config["layer_types"]):
        if kind == "conv":
            blk = {"in_proj": normal(D, 3 * D, scale=D ** -0.5),
                   "conv": normal(D, L, scale=L ** -0.5),
                   "out_proj": normal(D, D, scale=D ** -0.5)}
        elif kind == "full_attention":
            blk = {"wq": normal(D, H * hd, scale=D ** -0.5),
                   "wkv": normal(D, 2, Hk * hd, scale=D ** -0.5),
                   "out_proj": normal(H * hd, D, scale=(H * hd) ** -0.5),
                   "q_norm": ones(hd), "k_norm": ones(hd)}
        else:
            raise ValueError(f"unknown layer type {kind!r}")
        if _lfm2_ffn_kind(config, i) == "dense":
            blk["w13"] = normal(D, 2 * F_dense, scale=D ** -0.5)
            blk["w2"] = normal(F_dense, D, scale=F_dense ** -0.5)
        else:
            blk.update(init_dropless(
                gen, dim=D, hidden=config["moe_intermediate_size"],
                num_experts=config["published_num_experts"],
                held=config["num_experts"], device=device))
        blk["norm1"], blk["norm2"] = ones(D), ones(D)
        params["blocks"].append(blk)
    params["norm_f"] = ones(D)
    return params


def lfm2_expert_bias(config: dict, device: DeviceLike = None) -> list:
    """Each layer's constant expert bias: zeros over the published experts
    for an MoE layer (the aux-loss-free rule that would update it is in
    no published configuration), None for the others."""
    device = resolve_device(device)
    return [torch.zeros(config["published_num_experts"], device=device)
            if _lfm2_ffn_kind(config, i) == "moe" else None
            for i in range(len(config["layer_types"]))]


def _rms(x, g, eps: float):
    """RMSNorm in float32: ``x · rsqrt(mean(x²) + eps) · g``."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _lfm2_conv(a, blk, compute_dtype):
    """The gated short-conv mixer: ``[B | C | x] = in_proj(a)``, ``u = B ⊙
    x``, a depthwise causal conv of width L over ``u`` (three shifted
    multiply-adds at L 3, zero before t = 0), ``out_proj(C ⊙ conv)``;
    the elementwise part in ``compute_dtype``. The span ``conv``."""
    B, T, D = a.shape
    with Annotation("conv", a.device):
        b, c, x = (a.to(compute_dtype)
                   @ blk["in_proj"].to(compute_dtype)).chunk(3, dim=-1)
        u = b * x
        w = blk["conv"].to(u.dtype)
        L = w.shape[1]
        conv = u * w[:, L - 1]
        for j in range(1, L):  # u[t - j], zero before the start
            conv = conv + F.pad(u, (0, 0, j, 0))[:, :T] * w[:, L - 1 - j]
        return ((c * conv) @ blk["out_proj"].to(compute_dtype)).float()


def _lfm2_attn(a, blk, attn_fn, pos, heads, theta, eps, compute_dtype):
    """The attention mixer: GQA q/k/v projections, RMSNorm over the head
    dim on q and k, half-split RoPE at ``theta``, causal attention at
    scale hd^-1/2 (``attn_fn``), ``out_proj``."""
    B, T, _ = a.shape
    x = a.to(compute_dtype)
    with _producing("qkv"):
        q = x @ blk["wq"].to(compute_dtype)
        wkv = blk["wkv"].to(compute_dtype)
        kv = (x @ wkv.reshape(wkv.shape[0], -1)).view(B, T, 2, -1)
    hd = q.shape[-1] // heads
    q = _rms(q.view(B, T, heads, hd), blk["q_norm"], eps).to(compute_dtype)
    k = _rms(kv[:, :, 0].reshape(B, T, -1, hd), blk["k_norm"],
             eps).to(compute_dtype)
    v = kv[:, :, 1].reshape(B, T, -1, hd)
    o = attn_fn(rope_rotate(q, pos, theta), rope_rotate(k, pos, theta), v)
    o = checkpoint_name(o.reshape(B, T, -1), "attn_out")
    return (o.to(compute_dtype) @ blk["out_proj"].to(compute_dtype)).float()


def _lfm2_block(h, blk, bias, config, attn_fn, pos, compute_dtype):
    """One LFM2 layer: ``h += mixer(RMSNorm(h))``, then ``h +=
    ffn(RMSNorm(h))`` (a SwiGLU, or the dropless MoE when ``bias`` is the
    layer's expert bias); the residual stream float32."""
    from minips_tpu_torch.parallel.moe import moe_dropless

    eps = config["norm_eps"]
    a = _rms(h, blk["norm1"], eps)
    if "in_proj" in blk:
        h = h + _lfm2_conv(a, blk, compute_dtype)
    else:
        h = h + _lfm2_attn(a, blk, attn_fn, pos,
                           config["num_attention_heads"],
                           config["rope_theta"], eps, compute_dtype)
    a = _rms(h, blk["norm2"], eps)
    if bias is not None:
        B, T, D = a.shape
        y = moe_dropless(
            blk, a.reshape(B * T, D), expert_offset=config["expert_offset"],
            k_top=config["num_experts_per_tok"], expert_bias=bias,
            routed_scale=config["routed_scaling_factor"],
            compute_dtype=compute_dtype).view(B, T, D)
    else:
        hidden = blk["w2"].shape[0]
        with _producing("mlp_hidden"):
            z = a.to(compute_dtype) @ blk["w13"].to(compute_dtype)
        y = ((F.silu(z[..., :hidden]) * z[..., hidden:])
             @ blk["w2"].to(compute_dtype)).float()
    return h + y


def lfm2_hidden(params, tokens, *, config, expert_bias,
                compute_dtype=torch.bfloat16, attn_impl="reference",
                remat=False):
    """LFM2's final normed hidden state ``[B, T, D]`` float32 of ``tokens
    [B, T]``: the embedding, the layers of ``config["layer_types"]`` (each
    checkpointed under ``remat``, as :func:`_forward`'s blocks), then
    ``norm_f``. ``expert_bias``: :func:`lfm2_expert_bias`."""
    if not config.get("norm_topk_prob", True):
        raise ValueError("norm_topk_prob false is not supported")
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    attn_fn = _attn_fn(attn_impl)
    context_fn = _remat_policy(remat) if remat else None
    h = params["tok_emb"][tokens].float()
    for blk, bias in zip(params["blocks"], expert_bias):
        args = (h, blk, bias, config, attn_fn, pos, compute_dtype)
        if remat:
            h = checkpoint(_lfm2_block, *args, use_reentrant=False,
                           context_fn=context_fn or noop_context_fn)
        else:
            h = _lfm2_block(*args)
    return _rms(h, params["norm_f"], config["norm_eps"])


def lfm2_apply(params, tokens, *, compute_dtype=torch.bfloat16, **kw):
    """Logits ``[B, T, vocab]`` float32: :func:`lfm2_hidden` through the
    head tied to the embedding."""
    h = lfm2_hidden(params, tokens, compute_dtype=compute_dtype, **kw)
    return (h.to(compute_dtype)
            @ params["tok_emb"].T.to(compute_dtype)).float()


def lfm2_loss(params, batch, *, compute_dtype=torch.bfloat16, head_chunk=0,
              **kw):
    """LFM2's mean next-token cross-entropy on ``batch = {"tokens": [B,
    T+1]}``, the tied head in sequence chunks of ``head_chunk``
    (:func:`nll_chunked`) or whole; ``kw`` as :func:`lfm2_hidden`."""
    toks = batch["tokens"].long()
    tgt = toks[:, 1:]
    if not head_chunk:
        return nll(lfm2_apply(params, toks[:, :-1],
                              compute_dtype=compute_dtype, **kw), tgt)
    h = lfm2_hidden(params, toks[:, :-1], compute_dtype=compute_dtype, **kw)
    return nll_chunked(h, params["tok_emb"], tgt, head_chunk, compute_dtype)


def lfm2_grad_fn(params, batch, **kw):
    """``(loss, grads)`` of :func:`lfm2_loss`, as :func:`grad_fn`."""
    return value_and_grad(lambda p: lfm2_loss(p, batch, **kw), params)
