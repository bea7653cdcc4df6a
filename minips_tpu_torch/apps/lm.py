"""The decoder-LM training step — the port's counterpart of the setup in
``bench.py:bench_lm``, as ``apps/lrmlp.py`` is for ``bench_lrmlp``.

``build_lm`` builds one ``DenseTable`` named ``"lm"`` holding the whole LM
(Adam at ``lr``, 1e-3 by default, float32 master weights; the optimizer
state in float32, bfloat16 or blockwise int8 by ``opt_state``, as
``bench_lm``'s ``--lm-opt-state``) and its fused step
``table.make_step(grad_fn, compute_dtype=...)`` with flash attention and
the chunked tied head. Its defaults are ``bench_lm``'s: 8 blocks of width
2048 with 32 heads of 64, vocab 2^14, a learned positional table of
``seq`` rows, B = 16 sequences of T = 1024 tokens, bf16 compute, head
chunks of 128, and remat in mode ``"dots"`` (``bench_lm``'s default:
every matmul output saved, the rest of each block and its attention
forward recomputed in the backward). ``comm`` is the wire format of the
step's pull and push (``"float32"``, ``"bfloat16"`` or ``"int8"``), as
``minips_tpu/apps/lm_example.py`` passes ``--comm`` to ``make_step``;
given a process group, the table is range-sharded over it and each rank
steps on its shard of the batch. ``chip_smoke.py`` and the tests share
this function; it is not a benchmark.

Given a published ``config`` (HF's ``lfm2_moe`` keys, as
``benchmark/configs/lfm2-8b-a1b.json`` states them), ``build_lm`` builds
LFM2 in the same table with the same step: gated short-conv and GQA
layers in the configuration's ``layer_types``, SwiGLU FFNs in the leading
``num_dense_layers`` and the dropless top-k sigmoid MoE
(``parallel/moe.py``) after them, holding ``num_experts`` of the router's
``published_num_experts`` from ``expert_offset`` (one card's share of an
expert-parallel deployment), the head tied to the embedding
(``models/transformer.py`` ``lfm2_init``, ``lfm2_grad_fn``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from minips_tpu_torch.models import transformer as tfm
from minips_tpu_torch.parallel.mesh import (DeviceLike, Group,
                                            resolve_device, world)
from minips_tpu_torch.tables.dense import DenseTable

# bench_lm's --lm-opt-state: the updater that stores Adam's moments so
OPT_STATE_UPDATERS = {"f32": "adam", "bf16": "adam_bf16", "int8": "adam8"}


def build_lm(batch: int = 16, seq: int = 1024, *, dim: int = 2048,
             depth: int = 8, vocab: int = 1 << 14, device: DeviceLike = None,
             seed: int = 0, head_chunk: int = 128, remat="dots",
             compute_dtype: Optional[torch.dtype] = torch.bfloat16,
             kv_heads: Optional[int] = None, rope: bool = False,
             opt_state: str = "f32", comm: str = "float32",
             group: Group = None, config: Optional[dict] = None,
             lr: float = 1e-3):
    """The LM and its step at batch ``batch`` and sequence ``seq``, with
    ``dim // 64`` heads as in ``bench_lm``. ``opt_state`` is ``"f32"``
    (``adam``), ``"bf16"`` (``adam_bf16``) or ``"int8"`` (``adam8``).
    Returns a namespace with ``table``, ``step``
    (``table.step_inplace(step, b)`` runs it), ``grad_fn`` (the loss and
    gradients the step takes, of a params tree), ``batches`` (two
    ``{"tokens": [batch, seq + 1]}`` int64 batches on the device, drawn
    from ``numpy.random.default_rng(seed)`` as ``bench_lm`` draws them),
    ``heads``, ``remat`` and ``opt_state_bytes`` (the bytes of the
    optimizer-state tensors, as ``bench_lm`` counts them; this rank's
    shard's under a group). ``seed`` also seeds the weights (a
    ``torch.Generator`` on the device). Under a group, ``batch`` is the
    global batch, which must divide by the group size, and ``batches``
    hold this rank's rows. A ``config`` with ``model_type``
    ``"lfm2_moe"`` builds that model at its own sizes (``dim``,
    ``depth``, ``vocab``, ``kv_heads`` and ``rope`` then play no part)."""
    if opt_state not in OPT_STATE_UPDATERS:
        raise ValueError(f"opt_state must be one of "
                         f"{sorted(OPT_STATE_UPDATERS)}, got {opt_state!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if config is None:
        heads = dim // 64
        params = tfm.init(gen, vocab=vocab, dim=dim, heads=heads,
                          depth=depth, max_len=seq, kv_heads=kv_heads,
                          rope=rope, device=device)
        grad_fn = functools.partial(tfm.grad_fn, heads=heads,
                                    attn_impl="flash", remat=remat,
                                    head_chunk=head_chunk)
    elif config.get("model_type") == "lfm2_moe":
        heads, vocab = config["num_attention_heads"], config["vocab_size"]
        params = tfm.lfm2_init(gen, config, device)
        grad_fn = functools.partial(
            tfm.lfm2_grad_fn, config=config,
            expert_bias=tfm.lfm2_expert_bias(config, device),
            compute_dtype=compute_dtype or torch.float32,
            attn_impl="flash", remat=remat, head_chunk=head_chunk)
    else:
        raise ValueError(f"no model for model_type "
                         f"{config.get('model_type')!r} (known: lfm2_moe)")
    table = DenseTable(params, name="lm",
                       updater=OPT_STATE_UPDATERS[opt_state], lr=lr,
                       device=device, group=group)
    del params  # the table holds the only copy, as one flat vector
    step = table.make_step(grad_fn, compute_dtype=compute_dtype, comm=comm)
    rank, n = world(group)
    if batch % n:
        raise ValueError(f"batch {batch} must divide by the group size {n}")
    rows = slice(rank * (batch // n), (rank + 1) * (batch // n))
    rng = np.random.default_rng(seed)
    batches = [{"tokens": torch.as_tensor(
        rng.integers(0, vocab, size=(batch, seq + 1))[rows], device=device)}
        for _ in range(2)]
    opt_state_bytes = sum(x.numel() * x.element_size()
                          for x in table.opt_state)
    return SimpleNamespace(table=table, step=step, grad_fn=grad_fn,
                           batches=batches, heads=heads, remat=remat,
                           opt_state_bytes=opt_state_bytes)
