"""Quantized collectives for the PS data plane — the port of
``minips_tpu/ops/quantized_comm.py``.

Two halves, as in the JAX package:

- the numpy host codecs (per-row int8, sparse top-k, blockwise 8/4-bit,
  the sorted-run key deltas) are a copy, line for line, so the two
  packages speak one wire format bit for bit;
- the device collectives run on a ``torch.distributed`` group where the
  JAX functions run on a ``shard_map`` axis. ``group=None`` is a world of
  one device: no collective is called, but the codec still runs, as the
  JAX functions on a one-device mesh quantize and dequantize.

``comm="bfloat16"`` casts, moves and casts back; ``comm="int8"`` moves
symmetric absmax codes with one float32 scale per ``BLOCK`` elements
(round half to even, as ``jnp.round``). The reduce leg (``a2a_reduce``)
ships each destination's chunk through an all-to-all and sums the
decompressed contributions in float32, in rank order: the sum never runs
compressed. The float32 reduce-scatter takes the same all-to-all and the
same rank-order sum, which is the order the JAX package's ``psum_scatter``
adds in on the CPU. The JAX package computes all of this with XLA ops,
outside any Pallas kernel, so the port's are torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from minips_tpu_torch.parallel.mesh import Group, all_gather, all_to_all, world

VALID = ("float32", "bfloat16", "int8")


# --------------------------------------------------------------- host codec
# The per-ROW absmax int8 codec for the host PS wire (train/sharded_ps.py):
# the numpy twin of the blockwise device codec below, with the row (not a
# 256-element block) as the scale unit — PS frames already move row-major
# key slices, so one f32 scale per row is the natural framing. Both the
# push leg (gradients, stochastic rounding) and the pull leg (weights,
# nearest rounding) of the sharded PS speak this codec; it lives here so
# the device collectives and the host wire share one quantization home.

def quantize_rows_int8(rows: np.ndarray,
                       rng: np.random.Generator | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row absmax int8. With ``rng``, rounding is STOCHASTIC (round
    to floor with probability 1-frac, up with probability frac), making
    the codec UNBIASED: E[decode(encode(g))] = g — quantization noise
    averages out across steps instead of accumulating as drift, which is
    why the gradient push wire needs no error-feedback residual (EF
    would require a residual the size of the FULL table on every pusher,
    breaking the sharded PS's 1/N-memory-per-process claim).

    With ``rng=None``, rounding is round-to-NEAREST — the pull-wire mode
    for weights: deterministic, so every puller of an unchanged row
    decodes identical bytes, and half the worst-case per-element error.

    Returns ``(codes int8 [n, dim], scale f32 [n])``; decode is
    ``codes * scale[:, None]``. All-zero rows get scale 0."""
    rows = np.asarray(rows, np.float32)
    scale = (np.abs(rows).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    x = rows / safe[:, None]
    if rng is None:
        codes = np.rint(x)
    else:
        low = np.floor(x)
        codes = low + (rng.random(rows.shape) < (x - low))
    return np.clip(codes, -127, 127).astype(np.int8), scale


def dequantize_rows_int8(codes: np.ndarray,
                         scale: np.ndarray) -> np.ndarray:
    return codes.astype(np.float32) * scale[:, None]

# ------------------------------------- sparse top-k + blockwise host codec
# The compressed push wire's two levers (SparCML + EQuARX, PAPERS.md):
# magnitude top-k ROW selection over the owner-split gradient (ship the
# mass, not the touch set) and blockwise absmax quantization at 8 or 4
# bits (one f32 scale per HOST_BLOCK flattened elements — the numpy twin
# of the device codec's ``_quantize_blocks`` below, block size tunable).
# The pusher keeps ``g - decode(encode(g))`` plus every unselected row in
# its error-feedback residual store (train/sharded_ps.ResidualStore), so
# unlike the per-row int8 codec above, BIASED nearest rounding is sound
# here: the bias is measured and re-shipped, never accumulated.

HOST_BLOCK = 64  # default blockwise-scale unit for the host topk wire
                 # (f32-scale overhead = 4/HOST_BLOCK bytes per element;
                 # at 64 that is 1/16 the 8-bit code stream)


def topk_rows(rows: np.ndarray, *, mass: float = 0.9,
              frac_cap: float = 0.5) -> np.ndarray:
    """SORTED indices of the smallest row set capturing ``mass`` of the
    squared-L2 gradient mass, capped at ``ceil(frac_cap * n)`` rows —
    'k adaptive to the touched set': a zipf push whose summed hot rows
    dominate selects a few rows; a flat push selects up to the cap and
    leaves the rest to error feedback. Deterministic (stable sort);
    always selects at least one row of a nonzero gradient."""
    n = rows.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    mag = np.einsum("ij,ij->i", rows, rows, dtype=np.float64)
    total = float(mag.sum())
    cap = max(1, int(np.ceil(frac_cap * n)))
    if total <= 0.0:
        return np.arange(min(1, n), dtype=np.int64)
    order = np.argsort(-mag, kind="stable")
    k = int(np.searchsorted(np.cumsum(mag[order]), mass * total)) + 1
    return np.sort(order[: min(k, cap)])


def _block_grid(flat: np.ndarray, block: int) -> tuple[np.ndarray, int]:
    """Zero-pad a flat f32 array up to a block multiple and view it
    ``[nb, block]`` (zeros never move an absmax)."""
    L = flat.size
    nb = -(-L // block) if L else 0
    pad = nb * block - L
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    return flat.reshape(nb, block), L


def quantize_blockwise(rows: np.ndarray, bits: int, *,
                       block: int = HOST_BLOCK,
                       rng: np.random.Generator | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Blockwise absmax quantization of ``[n, dim]`` f32 rows flattened
    row-major: one f32 scale per ``block`` elements, codes at 8 bits
    (int8 stream) or 4 bits (two codes per byte, uint8 stream, offset
    +8 so the sign needs no second pass). ``rng`` selects stochastic
    rounding (unbiased); None is round-to-nearest (deterministic — the
    serve-plane refresh mode, where every replica must decode the same
    bytes). Returns ``(codes, scales f32 [nb])``."""
    if bits not in (4, 8):
        raise ValueError("blockwise codec supports 4 or 8 bits")
    levels = 127 if bits == 8 else 7
    flat = np.ascontiguousarray(rows, np.float32).reshape(-1)
    grid, L = _block_grid(flat, block)
    scale = (np.abs(grid).max(axis=1) / levels).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    x = grid / safe[:, None]
    if rng is None:
        q = np.rint(x)
    else:
        low = np.floor(x)
        q = low + (rng.random(x.shape) < (x - low))
    q = np.clip(q, -levels, levels).astype(np.int8).reshape(-1)[:L]
    if bits == 8:
        return q, scale
    u = (q.astype(np.int16) + 8).astype(np.uint8)  # 1..15, 0 unused
    if u.size % 2:
        u = np.concatenate([u, np.zeros(1, np.uint8)])
    return (u[0::2] << 4) | u[1::2], scale


def dequantize_blockwise(codes: np.ndarray, scales: np.ndarray,
                         n: int, dim: int, bits: int, *,
                         block: int = HOST_BLOCK) -> np.ndarray:
    """Inverse of :func:`quantize_blockwise` back to ``[n, dim]`` f32."""
    L = n * dim
    if bits == 8:
        q = np.frombuffer(codes, np.int8)[:L].astype(np.float32)
    else:
        packed = np.frombuffer(codes, np.uint8)
        u = np.empty(packed.size * 2, np.uint8)
        u[0::2] = packed >> 4
        u[1::2] = packed & 0x0F
        q = (u[:L].astype(np.int16) - 8).astype(np.float32)
    grid, _ = _block_grid(q, block)
    out = grid * np.asarray(scales, np.float32)[:, None]
    return out.reshape(-1)[:L].reshape(n, dim)


def blockwise_stream_bytes(n: int, dim: int, bits: int,
                           block: int = HOST_BLOCK) -> tuple[int, int]:
    """(code bytes, scale bytes) of the blockwise stream for ``n`` rows —
    the one size formula encoder, decoder, and frame validators share."""
    L = n * dim
    nb = -(-L // block) if L else 0
    code = L if bits == 8 else -(-L // 2)
    return code, 4 * nb


# ------------------------------------------- sorted-run key delta codec
# The other half of the index-stream bill (ROADMAP item 5's "cheap
# adjacent win"): the topk push wire ships SORTED unique keys (np.unique
# upstream, topk_rows returns sorted positions), and a hot zipf working
# set is near-contiguous in key space — so the gaps between adjacent
# keys fit a byte where the absolute keys need 2-8. Encode the first
# key absolute (i64) and the rest as unsigned run deltas at the
# narrowest width the largest gap fits. Strictly-increasing input only
# (deltas >= 1 by construction after dedup); the encoder is the one
# place that checks, so a caller with unsorted keys must sort first.

def delta_stream_bytes(n: int, dw: int) -> int:
    """Byte size of the delta key stream for ``n`` keys at delta width
    ``dw`` — shared by encoder and frame validators."""
    return 0 if n == 0 else 8 + (n - 1) * dw


def encode_key_deltas(keys: np.ndarray) -> tuple[int, bytes]:
    """Delta-encode strictly-increasing int64 ``keys``: 8-byte i64 base
    + ``n-1`` gaps at the narrowest unsigned width ∈ {1, 2, 4, 8} that
    fits the largest gap. Returns ``(delta_width, stream)``."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = keys.size
    if n == 0:
        return 1, b""
    if n == 1:
        return 1, keys.tobytes()
    gaps = np.diff(keys)
    if gaps.min() <= 0:
        raise ValueError("delta key codec requires strictly "
                         "increasing keys")
    top = int(gaps.max())
    dw = 1 if top <= 0xFF else 2 if top <= 0xFFFF \
        else 4 if top <= 0xFFFFFFFF else 8
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[dw]
    return dw, keys[:1].tobytes() + gaps.astype(dt).tobytes()


def decode_key_deltas(buf, n: int, dw: int) -> np.ndarray:
    """Inverse of :func:`encode_key_deltas` back to int64 keys."""
    if n == 0:
        return np.empty(0, np.int64)
    base = np.frombuffer(buf[:8], np.int64)
    if n == 1:
        return base.copy()
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[dw]
    gaps = np.frombuffer(buf[8:8 + (n - 1) * dw], dt).astype(np.int64)
    out = np.empty(n, np.int64)
    out[0] = base[0]
    np.cumsum(gaps, out=out[1:])
    out[1:] += base[0]
    return out


BLOCK = 256  # int8 quantization block: one f32 scale per 256 elements
             # (1.6% wire overhead). Per-BLOCK scales matter because a
             # raveled model mixes magnitudes (layernorm ~1.0, attention
             # weights ~0.005); one scale per shard would flush the small
             # tensors to zero.


def _check(comm: str) -> None:
    if comm not in VALID:
        raise ValueError(f"comm must be one of {VALID}, got {comm!r}")


def _quantize_blocks(x: torch.Tensor, block: int = BLOCK, *,
                     reciprocal: bool = False):
    """[..., L] f32 -> (int8 [..., nb, block], f32 scales [..., nb]).
    L is zero-padded up to a block multiple. ``reciprocal`` takes the
    scale as absmax times the f32 reciprocal of 127, as XLA computes it
    inside a compiled program (the JAX mesh plane's waves); the default
    is the true division of JAX's eager op."""
    L = x.shape[-1]
    nb = -(-L // block)
    pad = nb * block - L
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], nb, block)
    # 127 as a tensor on x's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds some scales
    # differently from JAX's (and the CPU's) true division
    amax = torch.clamp(torch.amax(torch.abs(xb), dim=-1), min=1e-30)
    if reciprocal:
        scale = amax * torch.full((), np.float32(1) / np.float32(127),
                                  dtype=torch.float32, device=x.device)
    else:
        scale = amax / torch.full((), 127.0, dtype=torch.float32,
                                  device=x.device)
    q = torch.round(xb / scale[..., None]).to(torch.int8)
    return q, scale


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                       length: int) -> torch.Tensor:
    """Inverse of ``_quantize_blocks`` over the last two dims."""
    x = q.to(torch.float32) * scale[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :length]


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    """``x[0] + x[1] + ...`` over dim 0, in rank order."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def quantized_all_gather(x: torch.Tensor, group: Group,
                         comm: str = "float32") -> torch.Tensor:
    """All-gather a [shard] f32 vector as ``comm`` dtype; returns f32
    [n * shard] (tiled). int8 sends one f32 scale per BLOCK alongside.
    float32 under ``group=None`` returns ``x`` itself."""
    _check(comm)
    if comm == "float32":
        return x if group is None else all_gather(x, group).reshape(-1)
    if comm == "bfloat16":
        g = all_gather(x.to(torch.bfloat16), group)
        return g.to(torch.float32).reshape(-1)
    shard = x.shape[0]
    q, scale = _quantize_blocks(x)
    qs = all_gather(q, group)                 # [n, nb, block]
    ss = all_gather(scale, group)             # [n, nb]
    return _dequantize_blocks(qs, ss, shard).reshape(-1)


def a2a_reduce(chunks: torch.Tensor, group: Group, comm: str, *,
               block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed REDUCE leg: ship ``[n, c]`` per-destination chunks
    through an all-to-all in the compressed dtype and sum the decompressed
    contributions in f32. Returns ``(reduced_c, sent)``: this rank's
    reduced chunk and exactly what it contributed after compression (the
    error-feedback hook: residual = input - sent)."""
    c = chunks.shape[1]
    if comm == "bfloat16":
        low = chunks.to(torch.bfloat16)
        recv = all_to_all(low, group)
        return _rank_sum(recv.to(torch.float32)), low.to(torch.float32)
    q, scale = _quantize_blocks(chunks, block)            # [n, nb, block]
    sent = _dequantize_blocks(q, scale, c)
    # chunk j of every rank -> rank j; received rows are the n ranks'
    # contributions to MY chunk
    q_recv = all_to_all(q, group)
    s_recv = all_to_all(scale, group)
    return _rank_sum(_dequantize_blocks(q_recv, s_recv, c)), sent


def gather_broadcast(chunk: torch.Tensor, group: Group,
                     comm: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed REPLICATE leg: all-gather this rank's ``[c]`` chunk
    in the compressed dtype; every rank dequantizes the same bytes, so the
    ``[n*c]`` result is bitwise identical everywhere. Returns ``(full,
    gap)`` with ``gap = chunk - what the others decode of it``."""
    c = chunk.shape[0]
    if comm == "bfloat16":
        low = chunk.to(torch.bfloat16)
        g = all_gather(low, group)
        return g.to(torch.float32).reshape(-1), chunk - low.to(torch.float32)
    q, s = _quantize_blocks(chunk[None, :])
    decoded = _dequantize_blocks(q, s, c)[0]
    qg = all_gather(q, group)
    sg = all_gather(s, group)
    return _dequantize_blocks(qg[:, 0], sg[:, 0], c).reshape(-1), \
        chunk - decoded


def quantized_psum_scatter(gpad: torch.Tensor, group: Group,
                           comm: str = "float32", *,
                           block: int = BLOCK) -> torch.Tensor:
    """Reduce-scatter a [n * shard] f32 gradient to this rank's [shard]
    chunk, summing over the group in rank order (compressed modes via
    :func:`a2a_reduce`). float32 under ``group=None`` returns ``gpad``
    itself."""
    _check(comm)
    n = world(group)[1]
    if comm == "float32":
        if group is None:
            return gpad
        return _rank_sum(all_to_all(gpad.reshape(n, -1), group))
    reduced, _ = a2a_reduce(gpad.reshape(n, -1), group, comm, block=block)
    return reduced


def quantized_psum_scatter_ef(gpad: torch.Tensor, group: Group,
                              comm: str = "float32", *,
                              block: int = BLOCK
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantized_psum_scatter` with the error-feedback hook kept:
    also returns this rank's compression residual, input minus what
    :func:`a2a_reduce` shipped, in ``gpad``'s layout. ``float32`` ships
    exactly, so its residual is zeros."""
    _check(comm)
    if comm == "float32":
        return (quantized_psum_scatter(gpad, group, comm),
                torch.zeros_like(gpad))
    n = world(group)[1]
    chunks = gpad.reshape(n, -1)
    reduced, sent = a2a_reduce(chunks, group, comm, block=block)
    return reduced, (chunks - sent).reshape(gpad.shape)
