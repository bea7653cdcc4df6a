"""Flash attention — the port of ``minips_tpu/ops/flash_attention.py``.

Exact ``softmax(QK^T·scale)V`` on the ``[B, T, H, D]`` layout of the rest
of the stack, never materialising the ``[T, T]`` scores on the card:

- ``blockwise_attention``: pure torch, an online-softmax loop over K/V
  chunks (the JAX package's ``lax.scan`` twin), with global ``q_off`` /
  ``k_off`` masking, ``return_lse`` and a padded ragged K tail.
- ``flash_attention`` / ``flash_with_lse``: the core primitive, a
  ``torch.autograd.Function`` mirroring the JAX package's
  ``_flash_with_lse`` custom VJP. Its outputs are ``out`` (input type) and
  ``lse`` ``[B, H, Tq, 1]`` float32, and lse is differentiable: the
  backward's ``dvec`` is ``rowsum(dO·O) − g_lse``. The offsets take no
  gradient.

Three kernels carry the primitive: K2 (``flash_forward``), K3
(``flash_bwd_dq``) and K4 (``flash_bwd_dkv``), hand-written CUDA C++ for
Hopper in ``minips_tpu_torch/csrc/flash_attn.cu``. On bfloat16 all three
are ``wgmma`` kernels (tensor cores, TMA tile loads into a ring of
shared-memory stages); on float32 they are the first SIMT kernels, which
keep full f32 products (``wgmma`` on f32 would be TF32). Which version
runs depends only on where the
tensors lie: a CUDA tensor launches the kernel (and counts it in
``<wrapper>.launches``) or raises; a CPU tensor runs the plain version
beside it (``flash_forward_reference``,
``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``), the same
function with the same rounding points and masks. There is no switch and
no fallback. On the card the shape gate is the kernels' own
(``kernel_supported``: any Tq and Tk, D a multiple of 8 up to 128, kv heads
dividing q heads), not the JAX package's block-size gate, which existed for
the TPU's tiles. The kernels tile K at ``KERNEL_BLOCK`` = 64 rows (Q at
64, or 128 in the bfloat16 K2/K3; the bfloat16 K4 holds 128 keys a block
and streams Q in tiles of 64); a caller's ``block_k`` sets only the
plain version's K tile (its online-softmax rounding follows its tiles, as
the TPU kernel's does).

``ring_flash_attention_local`` is ring attention (sequence parallelism
over a ``torch.distributed`` group) with the flash primitive doing each
step: ``ring_step`` runs K2 on the resident Q shard against the visiting
K/V shard at their global offsets (so whole shards are kept, skipped or
diagonal) and merges by logsumexp in float32. The merge gives the step's
lse a nonzero cotangent, which reaches K3 and K4 through ``dvec``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from minips_tpu_torch.parallel.mesh import Group, ppermute, world

NEG_INF = -1e30  # finite mask value: no -inf arithmetic on masked rows
KERNEL_BLOCK = 64  # the CUDA kernels' K tile rows
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gqa_group_size(num_q_heads: int, num_kv_heads: int) -> int:
    """Q heads per KV head (grouped-query attention); 1 is classic MHA.
    Raises unless kv divides q."""
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"GQA needs kv_heads ({num_kv_heads}) to divide q heads "
            f"({num_q_heads})")
    return num_q_heads // num_kv_heads


def _expand_kv(q, k, v):
    """Repeat K/V heads up to Q's head count for the plain paths (q head h
    reads kv head h // g). The kernels never materialise the repeat."""
    g = gqa_group_size(q.shape[2], k.shape[2])
    if g == 1:
        return k, v
    return (torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


# --------------------------------------------------------------- blockwise
def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, block_k: int = 256,
                        q_off=0, k_off=0, return_lse: bool = False):
    """Exact attention, looping over K/V in chunks of ``block_k``.

    q/k/v: ``[B, T, H, D]``; the result equals ``softmax(QK^T·scale)V`` to
    float tolerance with ``[B, Tq, block_k, H]`` live scores. A ragged K
    tail is zero-padded and masked. ``q_off``/``k_off`` shift the causal
    mask to global positions; ``return_lse=True`` also returns the row
    logsumexp ``[B, Tq, H]``. Differentiable by autograd."""
    B, Tq, H, D = q.shape
    k, v = _expand_kv(q, k, v)
    Tk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    bk = min(block_k, Tk)
    pad = (-Tk) % bk
    if pad:
        zeros = torch.zeros((B, pad, H, D), dtype=k.dtype, device=k.device)
        k = torch.cat([k, zeros], dim=1)
        v = torch.cat([v, zeros], dim=1)
    masked = causal or pad
    nk = (Tk + pad) // bk
    qf = q.float()
    kc = k.float().reshape(B, nk, bk, H, D)
    vc = v.float().reshape(B, nk, bk, H, D)
    q_pos = q_off + torch.arange(Tq, device=q.device)
    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Tq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Tq, H), dtype=torch.float32, device=q.device)
    for j in range(nk):
        s = torch.einsum("bqhd,bkhd->bqkh", qf, kc[:, j]) * scale
        if masked:
            k_local = j * bk + torch.arange(bk, device=q.device)
            keep = (k_local < Tk)[None, :]
            if causal:
                keep = keep & (q_pos[:, None] >= (k_off + k_local)[None, :])
            s = torch.where(keep[None, :, :, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=2))
        p = torch.exp(s - m_new[:, :, None, :])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=2)
        o = o * alpha[..., None] + torch.einsum("bqkh,bkhd->bqhd", p,
                                                vc[:, j])
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (o / l_safe[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l_safe)
    return out


# ------------------------------------------------------ the plain versions
def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (float32) as it reads once rounded to ``dtype``."""
    return x.to(dtype).float()


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` -> float32 ``[B, H, T, D]``."""
    return x.float().permute(0, 2, 1, 3)


def _live(Tq: int, Tk: int, q_off: int, k_off: int, causal: bool,
          k0: int = 0, k1: Optional[int] = None, device=None):
    """``[Tq, k1 - k0]`` bool: which (query, key) pairs survive the mask,
    by global positions ``q_off + i >= k_off + j``."""
    k1 = Tk if k1 is None else k1
    qi = torch.arange(Tq, device=device)[:, None]
    kj = torch.arange(k0, k1, device=device)[None, :]
    keep = kj < Tk
    if causal:
        keep = keep & (q_off + qi >= k_off + kj)
    return keep


def flash_forward_reference(q, k, v, q_off: int = 0, k_off: int = 0, *,
                            causal: bool, scale: float,
                            block_k: int = KERNEL_BLOCK):
    """Plain version of K2: ``(out [B, Tq, H, D] in q's type, lse
    [B, H, Tq, 1] float32)``. The online softmax over K tiles of
    ``block_k`` rows, with the kernel's numerics: f32 scores and state,
    ``p`` rounded to the input type before ``P·V``, masked entries exactly
    0 (a row that sees no key gets out 0)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    k, v = _expand_kv(q, k, v)
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    dev = q.device
    m = torch.full((B, H, Tq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Tk, block_k):
        if causal and k_off + k0 > q_off + Tq - 1:
            break  # this tile and every later one is dead
        k1 = min(k0 + block_k, Tk)
        live = _live(Tq, Tk, q_off, k_off, causal, k0, k1, dev)
        s = torch.where(live, (qh @ kh[:, :, k0:k1].transpose(-1, -2))
                        * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _round_to(p, q.dtype) @ vh[:, :, k0:k1]
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return out, m + torch.log(l_safe)


def _probs_and_ds(q, k, v, dout, lse, dvec, q_off, k_off, causal, scale):
    """The backward's recomputed ``p = exp(s − lse)`` and
    ``ds = p·(dO·Vᵀ − dvec)·scale``, ``[B, H, Tq, Tk]`` float32, masked
    entries 0; plus the float32 heads-first q, k (expanded)."""
    k, v = _expand_kv(q, k, v)
    qh, kh, vh, oh = (_heads_first(x) for x in (q, k, v, dout))
    live = _live(q.shape[1], k.shape[1], q_off, k_off, causal,
                 device=q.device)
    s = (qh @ kh.transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dp = oh @ vh.transpose(-1, -2)
    ds = p * (dp - dvec) * scale
    return p, ds, qh, kh, oh


def flash_bwd_dq_reference(q, k, v, dout, lse, dvec, q_off: int = 0,
                           k_off: int = 0, *, causal: bool, scale: float):
    """Plain version of K3: ``dQ = round(ds)·K`` in q's type."""
    _, ds, _, kh, _ = _probs_and_ds(q, k, v, dout, lse, dvec, q_off, k_off,
                                    causal, scale)
    dq = _round_to(ds, q.dtype) @ kh
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkv_reference(q, k, v, dout, lse, dvec, q_off: int = 0,
                            k_off: int = 0, *, causal: bool, scale: float):
    """Plain version of K4: ``dK = Σ round(ds)ᵀ·Q`` and
    ``dV = Σ round(p)ᵀ·dO``, summed in float32 over the q heads of each kv
    group, returned at the kv head count in k's and v's type."""
    B, Tk, Hk, D = k.shape
    g = gqa_group_size(q.shape[2], Hk)
    p, ds, qh, _, oh = _probs_and_ds(q, k, v, dout, lse, dvec, q_off, k_off,
                                     causal, scale)
    dv = _round_to(p, q.dtype).transpose(-1, -2) @ oh     # [B, H, Tk, D]
    dk = _round_to(ds, q.dtype).transpose(-1, -2) @ qh

    def group_sum(x):
        return x.reshape(B, Hk, g, Tk, D).sum(2).permute(0, 2, 1, 3)

    return (group_sum(dk).to(k.dtype).contiguous(),
            group_sum(dv).to(v.dtype).contiguous())


# ------------------------------------------------------------ the kernels
def kernel_supported(q_shape, k_shape) -> bool:
    """The CUDA kernels' own shape gate: any Tq and Tk, a head dim that is
    a multiple of 8 up to 128, kv heads dividing q heads. Unlike the JAX
    package's gate no block size enters: the kernels tile at 64 and mask
    ragged tails."""
    B, Tq, H, D = q_shape
    Tk, Hk = k_shape[1], k_shape[2]
    return (min(B, Tq, Tk, H, Hk) > 0 and H % Hk == 0 and D % 8 == 0
            and 0 < D <= MAX_HEAD_DIM)


@functools.lru_cache(maxsize=None)
def _lib():
    from minips_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    ptr, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    head = [ctypes.c_int, i64p, ctypes.c_float]
    for name, n_ptrs in (("flash_fwd_launch", 5), ("flash_bwd_dq_launch", 7),
                         ("flash_bwd_dkv_launch", 8)):
        fn = getattr(lib, name)
        fn.argtypes = head + [ptr] * (n_ptrs + 1)   # + the stream
        fn.restype = ctypes.c_int
    return lib


def _check(name, q, k, v, *rest):
    """Raise on anything the kernels do not take; True for CPU tensors
    (the plain version runs), False for CUDA tensors (the kernel runs)."""
    tensors = (q, k, v) + rest
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q [B, Tq, H, D] and k, v [B, Tk, Hk, D] "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    gqa_group_size(q.shape[2], k.shape[2])
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not kernel_supported(q.shape, k.shape):
        raise ValueError(f"{name}: the kernel takes D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return False


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bfloat16 kernels' TMA loads take ``t [B, T, H, D]``
    as it lies: unit stride along D, a 16-byte aligned base, 16-byte
    multiples for the other strides, and strides growing from H to T to B
    over the dims longer than 1 (the order of the kernels' tensor map). The
    LM's q/k/v, strided views of the fused ``qkv`` activation, pass as they
    are; a tensor that fails goes to the kernel as a contiguous copy. This
    is the one definition of the rule: ``make_map`` in ``csrc/flash_attn.cu``
    builds the map of a tensor that passes and only asserts the rule again
    (a launch that breaks it fails rather than reading a wrong map)."""
    item = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16:
        return False
    inner = t.shape[3]  # elements spanned by the dims inside
    for dim in (2, 1, 0):
        if t.shape[dim] == 1:
            continue
        stride = t.stride(dim)
        if (stride * item) % 16 or stride < inner:
            return False
        inner = stride * t.shape[dim]
    return True


def _for_tma(*tensors):
    """The tensors as the bfloat16 kernels take them: each that is not
    :func:`tma_ready` replaced by a contiguous copy (a fresh, aligned
    allocation)."""
    return tuple(t if tma_ready(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def _ints(q, k, v, dout, q_off, k_off, causal):
    B, Tq, H, D = q.shape
    vals = [B, Tq, k.shape[1], H, k.shape[2], D, q_off, k_off, int(causal)]
    for t in (q, k, v, dout if dout is not None else q):
        vals.extend(t.stride())
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn_name, name, q, k, v, dout, q_off, k_off, causal, scale,
            ptrs):
    ints = _ints(q, k, v, dout, q_off, k_off, causal)
    with torch.cuda.device(q.device):
        rc = getattr(_lib(), fn_name)(
            _DTYPE_CODE[q.dtype], ints, float(scale),
            *[t.data_ptr() for t in ptrs],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _rows(q, dout, lse, dvec):
    """The backward kernels' checks on dO, and lse and dvec as they read
    them: float32 ``[B, H, Tq, 1]``, contiguous."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dO {tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    rows = (q.shape[0], q.shape[2], q.shape[1], 1)
    for x in (lse, dvec):
        if tuple(x.shape) != rows:
            raise ValueError(f"per-row input of shape {tuple(x.shape)}, "
                             f"expected {rows}")
    return lse.float().contiguous(), dvec.float().contiguous()


def flash_forward(q, k, v, q_off: int = 0, k_off: int = 0, *, causal: bool,
                  scale: float, block_k: int = KERNEL_BLOCK):
    """K2: ``(out [B, Tq, H, D], lse [B, H, Tq, 1] float32)``. CUDA
    tensors launch the kernel (counted in ``flash_forward.launches``); CPU
    tensors run :func:`flash_forward_reference` with K tiles of
    ``block_k``. On bfloat16 a q, k or v that is not :func:`tma_ready` is
    made contiguous before the launch."""
    if _check("flash_forward", q, k, v):
        return flash_forward_reference(q, k, v, q_off, k_off, causal=causal,
                                       scale=scale, block_k=block_k)
    if q.dtype == torch.bfloat16:
        q, k, v = _for_tma(q, k, v)
    B, Tq, H, D = q.shape
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", "flash_forward", q, k, v, None, q_off, k_off,
            causal, scale, (q, k, v, out, lse))
    flash_forward.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, dvec, q_off: int = 0, k_off: int = 0,
                 *, causal: bool, scale: float):
    """K3: dQ ``[B, Tq, H, D]`` in q's type from the saved ``lse`` and
    ``dvec`` (both ``[B, H, Tq, 1]`` float32). CUDA tensors launch the
    kernel (counted in ``flash_bwd_dq.launches``); CPU tensors run
    :func:`flash_bwd_dq_reference`. On bfloat16 a q, k, v or dO that is not
    :func:`tma_ready` is made contiguous before the launch."""
    if _check("flash_bwd_dq", q, k, v, dout, lse, dvec):
        return flash_bwd_dq_reference(q, k, v, dout, lse, dvec, q_off, k_off,
                                      causal=causal, scale=scale)
    lse, dvec = _rows(q, dout, lse, dvec)
    if q.dtype == torch.bfloat16:
        q, k, v, dout = _for_tma(q, k, v, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq_launch", "flash_bwd_dq", q, k, v, dout, q_off,
            k_off, causal, scale, (q, k, v, dout, lse, dvec, dq))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dvec, q_off: int = 0, k_off: int = 0,
                  *, causal: bool, scale: float):
    """K4: ``(dK, dV)`` ``[B, Tk, Hk, D]`` at the kv head count, summed
    over each kv head's q heads. CUDA tensors launch the kernel (counted in
    ``flash_bwd_dkv.launches``); CPU tensors run
    :func:`flash_bwd_dkv_reference`. On bfloat16 a q, k, v or dO that is
    not :func:`tma_ready` is made contiguous before the launch."""
    if _check("flash_bwd_dkv", q, k, v, dout, lse, dvec):
        return flash_bwd_dkv_reference(q, k, v, dout, lse, dvec, q_off,
                                       k_off, causal=causal, scale=scale)
    lse, dvec = _rows(q, dout, lse, dvec)
    if q.dtype == torch.bfloat16:
        q, k, v, dout = _for_tma(q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_bwd_dkv_launch", "flash_bwd_dkv", q, k, v, dout, q_off,
            k_off, causal, scale, (q, k, v, dout, lse, dvec, dk, dv))
    flash_bwd_dkv.launches += 1
    return dk, dv


# kernel launches, for proof that a path used them
flash_forward.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# ------------------------------------------------------- the differentiable op
class _FlashWithLse(torch.autograd.Function):
    """``(out, lse)`` with global-offset causal masking; both outputs take
    gradients, the offsets none (``_flash_with_lse`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal, scale, block_k):
        out, lse = flash_forward(q, k, v, q_off, k_off, causal=causal,
                                 scale=scale, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_off, k_off, causal, scale)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        q_off, k_off, causal, scale = ctx.args
        # ds = p·(dp − rowsum(dO·O) + g_lse): the lse cotangent enters the
        # row term with the opposite sign (d lse / d s_k = p_k)
        dvec = (g_out.float() * out.float()).sum(-1).transpose(1, 2)[
            ..., None]
        if g_lse is not None:
            dvec = dvec - g_lse.float()
        dq = flash_bwd_dq(q, k, v, g_out, lse, dvec, q_off, k_off,
                          causal=causal, scale=scale)
        dk, dv = flash_bwd_dkv(q, k, v, g_out, lse, dvec, q_off, k_off,
                               causal=causal, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def flash_with_lse(q, k, v, q_off: int = 0, k_off: int = 0, *,
                   causal: bool = False, scale: Optional[float] = None,
                   block_k: int = KERNEL_BLOCK):
    """The core primitive: ``(out [B, Tq, H, D], lse [B, H, Tq, 1])`` with
    masking by global positions ``q_off + i >= k_off + j``; differentiable
    in q, k, v through both outputs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashWithLse.apply(q, k, v, int(q_off), int(k_off), bool(causal),
                               float(scale), block_k)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Fused attention with the signature of ``reference_attention``; never
    materialises the scores on the card. Grouped-query K/V (fewer heads,
    dividing q's) are read by q head h as kv head h // g. On the card
    K2–K4 run at their own 64-row tiles; on the CPU the plain versions run,
    the forward with K tiles of ``block_k`` (``block_q`` plays no part: the
    plain version handles every row at once)."""
    return flash_with_lse(q, k, v, causal=causal, scale=scale,
                          block_k=min(block_k, k.shape[1]))[0]


# ------------------------------------------------------- ring flash attn
def ring_step(q, k_blk, v_blk, q_off: int, k_off: int, acc=None, lse=None,
              *, causal: bool, scale: Optional[float] = None):
    """One step of the ring: the flash primitive (K2 forward; K3 and K4 in
    the backward) on the resident ``q`` ``[B, Tq, H, D]`` against a
    visiting K/V shard at global offsets ``q_off`` / ``k_off``, folded
    into the float32 running ``acc`` ``[B, Tq, H, D]`` and ``lse``
    ``[B, Tq, H]`` by logsumexp weighting. Returns the new ``(acc, lse)``;
    ``acc = lse = None`` starts the ring with this step's own output (the
    merge with an empty state, lse −1e30, is exactly that, in value and in
    gradient). The kernels launch on every step, a shard that the causal
    mask hides whole included (it gives out 0 and lse −1e30, which the
    merge weighs by 0), as the JAX scan runs every step."""
    o_s, lse_s = flash_with_lse(q, k_blk, v_blk, q_off, k_off,
                                causal=causal, scale=scale)
    lse_s = lse_s[..., 0].transpose(1, 2)                 # [B, Tq, H]
    if acc is None:
        return o_s.float(), lse_s
    lse_new = torch.logaddexp(lse, lse_s)
    acc = (acc * torch.exp(lse - lse_new)[..., None]
           + o_s.float() * torch.exp(lse_s - lse_new)[..., None])
    return acc, lse_new


def ring_flash_attention_local(q, k, v, *, group: Group,
                               causal: bool = False,
                               scale: Optional[float] = None):
    """Ring attention over ``group`` with :func:`ring_step` doing each of
    the n steps: q/k/v ``[B, T_local, H, D]`` are this rank's sequence
    shards (k/v may carry fewer heads); the K/V shards rotate with
    ``ppermute`` (n − 1 hops). Returns this rank's shard of exact
    attention over the gathered sequence in q's type. On CUDA tensors K2
    runs n times per call and K3 and K4 n times each in its backward; on
    CPU tensors their plain versions run. Training keeps each step's
    visiting shard for the backward (O(T) per rank over the n steps)."""
    r, n = world(group)
    Tq, Tk = q.shape[1], k.shape[1]
    acc = lse = None
    for step in range(n):
        src = (r - step) % n  # the rank whose shard is visiting
        acc, lse = ring_step(q, k, v, r * Tq, src * Tk, acc, lse,
                             causal=causal, scale=scale)
        if step < n - 1:
            k, v = ppermute(k, group), ppermute(v, group)
    return acc.to(q.dtype)
