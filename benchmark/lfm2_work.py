"""What the ``lfm2-8b-a1b`` cell's readers count, from the configuration's
shapes alone (the counts never depend on the code that does the work):
model flops a token, the expert grouped GEMMs' operations and bytes, and
the program's span times a step.

Kept beside ``roofline.py`` (whose peaks and ``causal_pairs`` it uses),
as a module of its own.
"""

from __future__ import annotations

import statistics

from benchmark import roofline


def flops_per_token(config: dict, t: int) -> float:
    """Model flops a token of LFM2 trained at sequence ``t`` (PaLM,
    arXiv:2204.02311, appendix B): 6 per matmul parameter a token uses
    (the conv mixers' ``in_proj`` and ``out_proj``, the attention's q, k,
    v and output projections, the dense SwiGLUs, the routers, the tied
    head, and the expert SwiGLUs at ``k · E_held / E`` routes a token,
    the held share of the ``k`` routes) plus, for each attention layer,
    the score and value products, 12·D a live pair, the causal half
    counted once; norms, the depthwise conv and the routing's own work
    are no matmul, and no recompute is counted."""
    D, V = config["hidden_size"], config["vocab_size"]
    H, Hk = config["num_attention_heads"], config["num_key_value_heads"]
    kv = 2 * D * Hk // H
    Fd, Fe = config["intermediate_size"], config["moe_intermediate_size"]
    E, held = config["published_num_experts"], config["num_experts"]
    k = config["num_experts_per_tok"]
    kinds = config["layer_types"]
    n_attn = sum(kind == "full_attention" for kind in kinds)
    n_conv = len(kinds) - n_attn
    n_dense = config["num_dense_layers"]
    n_moe = len(kinds) - n_dense
    params = (n_conv * (3 * D * D + D * D)
              + n_attn * (D * D + D * kv + D * D)
              + n_dense * 3 * D * Fd
              + n_moe * (D * E + k * held / E * 3 * D * Fe)
              + V * D)
    attn = 12 * n_attn * D * roofline.causal_pairs(t) / t
    return 6 * params + attn


def expert_gemm_work(routes: float, d: int, f: int, held: int,
                     item: int = 2) -> tuple[float, float]:
    """(flops, bytes) of a step's expert grouped GEMMs over ``routes``
    held routes, forward and backward (three products each of ``w1``,
    ``w3`` and ``w2``): 2·3·routes·d·f a pass, three passes. Bytes: each
    pass reads the ``held`` experts' weights once and its row operand
    once and writes its result once; the forward ``[routes, d] x [d, 2f]
    -> [routes, 2f]`` and ``[routes, f] x [f, d] -> [routes, d]``, the
    input gradient the same rows the other way, and the weight gradient
    the two row operands in and the weights out."""
    w = held * 3 * d * f * item
    rows = routes * (d + 2 * f + f + d) * item
    return 2 * 3 * routes * d * f * 3, 3 * (w + rows)


def span_ms_per_step(profiling, name: str):
    """Median over the recorded steps of the device ms a step inside span
    ``name``: its instances (the forward's and a recompute's) summed step
    by step, the steps counted by the ``dense_step`` spans of the same
    registry. None where either span is missing, or the instances do not
    split evenly into the steps."""
    if not hasattr(profiling, "span_ms"):
        return None
    ms, steps = profiling.span_ms(name), len(profiling.span_ms("dense_step"))
    if not ms or not steps or len(ms) % steps:
        return None
    n = len(ms) // steps
    return statistics.median(sum(ms[i:i + n])
                             for i in range(0, len(ms), n))


def recorded_steps(profiling) -> int:
    """The steps the program's registry recorded (``dense_step`` spans)."""
    if not hasattr(profiling, "span_ms"):
        return 0
    return len(profiling.span_ms("dense_step"))
