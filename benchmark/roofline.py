"""Peaks of the card and the operations and bytes each piece of work needs.

The counts depend only on the work's shapes and, where the work depends on
the data (the distinct rows a gather names), on what those inputs need;
never on the code that does the work, so they stay the same whatever
implements a kernel. Each input byte is read once and each output byte
written once, whatever a kernel reads again; a
roofline share is the least time (the larger of operations over the peak
rate and bytes over the memory rate) over the time measured.
"""

from __future__ import annotations

# the card the benchmark runs on, as torch.cuda.get_device_name() names it:
# the H100 SXM (NVIDIA's data sheet, dense bf16 without sparsity, 700 W)
CARD = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = 989e12
MEM_BW = 3.35e12  # bytes/s


def has_peaks(kind: str) -> bool:
    """Whether the peaks are known for ``kind``: the card's, True; the
    CPU of the tests, False (a CPU run reads no share of a device peak);
    any other card is refused rather than given another card's rates."""
    if kind == CARD:
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no peaks for {kind!r}: the benchmark's card is "
                     f"{CARD!r}")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / MEM_BW)


# ------------------------------------------------------------------ K1
def gather_bytes(n: int, unique: float, d: int, item: int = 4,
                 index: int = 4) -> float:
    """Row gather of ``n`` keys of ``d`` elements that name ``unique``
    distinct rows: the ``n`` indices read, each distinct row read once
    (a row that several keys name is one input, read again from cache),
    and the ``n`` rows written."""
    return n * index + unique * d * item + n * d * item


# ------------------------------------------------------------- K2 - K4
def causal_pairs(t: int) -> int:
    """Live (query, key) pairs of one head of a causal sequence of ``t``."""
    return t * (t + 1) // 2


def flash_work(b: int, t: int, h: int, d: int, item: int = 2) -> dict:
    """{kernel: (flops, bytes)} of one causal launch of K2, K3 and K4 at
    ``[b, t, h, d]`` (``chip_smoke.py``'s ``attention_work``): 4·d, 6·d and
    8·d flops a live pair; q, k, v (and dO) read once, outputs and the
    float32 row vectors (lse, dvec) once."""
    pairs = b * h * causal_pairs(t)
    qb = kb = b * t * h * d * item
    rows = b * h * t * 4
    return {"flash_fwd": (4 * d * pairs, 2 * qb + 2 * kb + rows),
            "flash_bwd_dq": (6 * d * pairs, 3 * qb + 2 * kb + 2 * rows),
            "flash_bwd_dkv": (8 * d * pairs, 2 * qb + 4 * kb + 2 * rows)}


# -------------------------------------------------------------- models
def lm_flops_per_token(n_layer: int, d: int, vocab: int, t: int,
                       mlp_mult: int = 4) -> float:
    """Model flops a token of a decoder LM trained at sequence ``t``
    (PaLM, arXiv:2204.02311, appendix B): 6 per matmul parameter (q, k, v,
    the output projection, the MLP and the tied head; embeddings and
    LayerNorms are no matmul) plus the attention's score and value
    products, 12·d a live pair over the layers, the causal half counted
    once and no recompute."""
    matmul_params = n_layer * (4 * d * d + 2 * mlp_mult * d * d) + vocab * d
    attn = 12 * n_layer * d * causal_pairs(t) / t
    return 6 * matmul_params + attn


def mlp_flops(batch: int, sizes: list[int]) -> float:
    """Forward and backward matmul flops of a dense tower: 6 a weight a
    sample."""
    return 6.0 * batch * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def sparse_step_bytes(keys: int, unique: int, d: int, item: int = 4) -> int:
    """One table's share of a step: each touched unique row's weights and
    Adagrad state read and written once, and the gathered rows written
    once."""
    return 4 * unique * d * item + keys * d * item
