"""The port's flash attention (K2, K3, K4 and their plain versions) against
the JAX package's.

The JAX side runs its Pallas kernels in interpret mode
(``_flash_with_lse(..., interpret=True)``), as
``tests/test_flash_attention.py`` does; the port's CPU tensors run the
plain versions. Both round ``p`` and ``ds`` to the input type at the same
points and tile the forward's online softmax alike (the port's plain
forward takes the JAX call's ``block_k``), so:

- float32: outputs, lse and gradients to 1e-5 absolute (O(1) values; the
  two sum in different orders);
- bfloat16: outputs and gradients to 2^-7 x max(1, max |value|), one
  bf16 rounding step at the largest value: the shared rounding points
  leave only f32 summation order, which can flip a rounding of p, ds or
  the output by one step; lse to 1e-5 (it is float32 either way).

The CUDA kernels are held against the plain versions on the card by the
``cuda`` tests here and by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ops import flash_attention as jfa
from minips_tpu.parallel import ring_attention as jring
from minips_tpu_torch.ops import _build
from minips_tpu_torch.ops import flash_attention as tfa
from minips_tpu_torch.parallel import ring_attention as tring

F32_ATOL = 1e-5
BF16_REL = 2.0 ** -7


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        assert np.abs(got - want).max() <= BF16_REL * max(
            1.0, np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _inputs(rng, B, Tq, Tk, H, Hk, D):
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, Hk, D)).astype(np.float32)
    return q, k, v


def _j(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _t(x, dtype, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return t.requires_grad_(True) if grad else t


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# (B, T, H, Hk, D, q_off, k_off, block)
CASES = [
    (2, 64, 2, 2, 16, 0, 0, 32),     # MHA
    (1, 64, 4, 1, 16, 0, 0, 32),     # MQA, g = 4
    (1, 64, 4, 2, 8, 16, 0, 16),     # GQA g = 2, offsets as a ring step
    (1, 32, 2, 2, 32, 32, 32, 32),   # a diagonal ring step
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_pallas_interpret(case, causal, dtype):
    B, T, H, Hk, D, q_off, k_off, blk = case
    q, k, v = _inputs(np.random.default_rng(1), B, T, T, H, Hk, D)
    out, lse = jfa._flash_with_lse(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.int32(q_off),
        jnp.int32(k_off), causal, D ** -0.5, blk, blk, True)
    got, glse = tfa.flash_forward(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  q_off, k_off, causal=causal,
                                  scale=D ** -0.5, block_k=blk)
    assert got.dtype == getattr(torch, dtype) and glse.dtype == torch.float32
    _close(got.float().numpy(), _f32(out), dtype)
    np.testing.assert_allclose(glse.numpy(), np.asarray(lse), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gradients_with_lse_cotangent_match_jax_vjp(case, causal, dtype):
    """A loss that uses both outputs: the lse cotangent enters dvec."""
    B, T, H, Hk, D, q_off, k_off, blk = case
    rng = np.random.default_rng(2)
    q, k, v = _inputs(rng, B, T, T, H, Hk, D)
    w = rng.normal(size=(B, T, H, D)).astype(np.float32)

    def jloss(q, k, v):
        out, lse = jfa._flash_with_lse(q, k, v, jnp.int32(q_off),
                                       jnp.int32(k_off), causal, D ** -0.5,
                                       blk, blk, True)
        return jnp.sum(out.astype(jnp.float32) * w) + jnp.sum(jnp.sin(lse))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        _j(q, dtype), _j(k, dtype), _j(v, dtype))
    tq, tk, tv = (_t(x, dtype, grad=True) for x in (q, k, v))
    out, lse = tfa.flash_with_lse(tq, tk, tv, q_off, k_off, causal=causal,
                                  block_k=blk)
    (torch.sum(out.float() * torch.from_numpy(w))
     + torch.sum(torch.sin(lse))).backward()
    for got, ref in zip((tq, tk, tv), want):
        assert got.grad.shape == got.shape  # dk, dv at the kv head count
        _close(got.grad.float().numpy(), _f32(ref), dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 4, 2, 16, 16, 0),    # GQA g = 2, offsets as a ring step
    # Tk > Tq, no offset: under the causal mask keys 32.. see no query
    (1, 32, 96, 4, 2, 16, 0, 0),
    (2, 64, 64, 8, 2, 16, 0, 0),     # GQA g = 4: K4 sums four q heads
])
def test_backward_plain_versions_match_jax_backward(shape, causal):
    """K3's and K4's plain versions against ``_flash_backward`` directly
    (blocks of 32, which tile every T here, as the JAX kernel's gate asks),
    with a dvec that is not rowsum(dO·O). Keys that no query sees get dK =
    dV = 0 exactly on both sides."""
    B, Tq, Tk, H, Hk, D, q_off, k_off = shape
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, B, Tq, Tk, H, Hk, D)
    assert jfa.kernel_supported(q.shape, k.shape, 32, 32)
    do = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    offs = (jnp.int32(q_off), jnp.int32(k_off))
    _, lse = jfa._flash_forward(*(jnp.asarray(x) for x in (q, k, v)), *offs,
                                causal, D ** -0.5, 32, 32, True)
    dvec = rng.normal(size=(B, H, Tq, 1)).astype(np.float32)
    dq, dk, dv = jfa._flash_backward(
        *(jnp.asarray(x) for x in (q, k, v)), *offs, jnp.asarray(do), lse,
        jnp.asarray(dvec), causal, D ** -0.5, 32, 32, True)
    args = [torch.from_numpy(x) for x in (q, k, v, do)] + [
        torch.from_numpy(np.asarray(lse)), torch.from_numpy(dvec)]
    kw = dict(causal=causal, scale=D ** -0.5)
    got_dq = tfa.flash_bwd_dq(*args, q_off, k_off, **kw)
    got_dk, got_dv = tfa.flash_bwd_dkv(*args, q_off, k_off, **kw)
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        _close(got.numpy(), np.asarray(want), "float32")
    unseen = min(max(q_off + Tq - k_off, 0), Tk) if causal else Tk
    for x in (got_dk.numpy(), got_dv.numpy(), np.asarray(dk),
              np.asarray(dv)):
        assert not x[:, unseen:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hk", [1, 2, 4])
def test_flash_attention_matches_reference_attention(hk, causal, dtype):
    """``flash_attention`` (any T, the default block sizes) against the
    port's and the JAX package's plain oracle."""
    q, k, v = _inputs(np.random.default_rng(4), 2, 48, 48, 4, hk, 16)
    got = tfa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=causal)
    ref = tring.reference_attention(_t(q, dtype), _t(k, dtype),
                                    _t(v, dtype), causal=causal)
    want = jring.reference_attention(_j(q, dtype), _j(k, dtype),
                                     _j(v, dtype), causal=causal)
    _close(ref.float().numpy(), _f32(want), dtype)
    # flash and the oracle round p at different places under bf16
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tk,block_k,q_off,k_off",
                         [(64, 16, 0, 0), (48, 32, 0, 0), (40, 16, 24, 8)])
def test_blockwise_matches_jax_blockwise(causal, tk, block_k, q_off, k_off):
    """Ragged K tails, offsets and ``return_lse`` (float32, 1e-5)."""
    q, k, v = _inputs(np.random.default_rng(5), 2, 32, tk, 4, 2, 16)
    out, lse = jfa.blockwise_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        block_k=block_k, q_off=q_off, k_off=k_off, return_lse=True)
    got, glse = tfa.blockwise_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        block_k=block_k, q_off=q_off, k_off=k_off, return_lse=True)
    _close(got.numpy(), np.asarray(out), "float32")
    _close(glse.numpy(), np.asarray(lse), "float32")


def test_ragged_sequences_plain_versions_agree_with_blockwise():
    """Tq, Tk not multiples of the kernels' 64-row tile: the plain versions
    (which the kernels are held to) against the blockwise scan and its
    autograd, float32, 1e-5."""
    q, k, v = _inputs(np.random.default_rng(6), 1, 100, 100, 4, 2, 24)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    out.square().sum().backward()
    grads = [x.grad.clone() for x in (tq, tk, tv)]
    for x in (tq, tk, tv):
        x.grad = None
    ref = tfa.blockwise_attention(tq, tk, tv, causal=True, block_k=64)
    ref.square().sum().backward()
    _close(out.detach().numpy(), ref.detach().numpy(), "float32")
    for got, x in zip(grads, (tq, tk, tv)):
        _close(got.numpy(), x.grad.numpy(), "float32")


def test_gqa_helpers_and_kernel_gate():
    assert tfa.gqa_group_size(8, 2) == jfa.gqa_group_size(8, 2) == 4
    with pytest.raises(ValueError, match="divide"):
        tfa.gqa_group_size(4, 3)
    q = torch.zeros(1, 5, 4, 8)
    k = torch.arange(2 * 5 * 8, dtype=torch.float32).reshape(1, 5, 2, 8)
    ek, _ = tfa._expand_kv(q, k, k)
    want, _ = jfa._expand_kv(jnp.zeros((1, 5, 4, 8)), jnp.asarray(k.numpy()),
                             jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(ek.numpy(), np.asarray(want))
    # the kernels' gate: any T, D a multiple of 8 up to 128
    assert tfa.kernel_supported((2, 100, 4, 64), (2, 37, 2, 64))
    assert tfa.kernel_supported((1, 1, 1, 128), (1, 1, 1, 128))
    assert not tfa.kernel_supported((1, 64, 4, 12), (1, 64, 4, 12))
    assert not tfa.kernel_supported((1, 64, 4, 256), (1, 64, 4, 256))
    assert not tfa.kernel_supported((1, 64, 4, 64), (1, 64, 3, 64))


def test_cpu_tensors_do_not_count_launches_and_other_devices_raise():
    q = torch.zeros(1, 8, 2, 8)
    before = (tfa.flash_forward.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    x = q.clone().requires_grad_(True)
    tfa.flash_attention(x, x, x, causal=True).sum().backward()
    assert (tfa.flash_forward.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_forward(meta, meta, meta, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_forward(q, q, meta, causal=True, scale=1.0)
    with pytest.raises(ValueError):
        tfa.flash_forward(q, q[:, :, :, :4], q, causal=True, scale=1.0)
    assert _build.library_path("flash_attn").name.startswith(
        "libflash_attn-")


def _bf16(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape).to(torch.bfloat16)


def _lm_views(make, B, T, H, Hk, D):
    """q, k, v as the LM block hands them over (``models/transformer.py``):
    strided views of one fused ``[B, T, 3, H·D]`` activation, or under GQA
    a q of its own and k, v views of a fused ``[B, T, 2, Hk·D]``."""
    if Hk == H:
        qkv = make(B, T, 3, H * D)
        return tuple(qkv[:, :, i].reshape(B, T, H, D) for i in range(3))
    kv = make(B, T, 2, Hk * D)
    return (make(B, T, H, D),) + tuple(
        kv[:, :, i].reshape(B, T, Hk, D) for i in range(2))


def _qkv_view(B=2, T=16, H=4, D=64):
    return _lm_views(_bf16, B, T, H, H, D)


@pytest.mark.parametrize("make,ready", [
    (lambda: _bf16(2, 16, 4, 64), True),                      # contiguous
    (lambda: _qkv_view()[0], True),                           # fused qkv: q
    (lambda: _qkv_view()[1], True),                           # ... k
    (lambda: _qkv_view()[2], True),                           # ... and v
    (lambda: _lm_views(_bf16, 2, 16, 4, 2, 64)[2], True),     # GQA's kv: v
    (lambda: _bf16(2, 4, 16, 64).transpose(1, 2), False),     # [B, H, T, D]
    (lambda: _bf16(2, 16, 4, 128)[..., ::2], False),          # D stride 2
    (lambda: _bf16(4 * 64 + 8)[8:].reshape(1, 4, 1, 64), True),   # base + 16B
    (lambda: _bf16(4 * 64 + 4)[4:].reshape(1, 4, 1, 64), False),  # base + 8B
    (lambda: _bf16(4 * 64 + 1)[1:].reshape(1, 4, 1, 64), False),  # base + 2B
    (lambda: _bf16(64 * 68).as_strided((1, 16, 1, 64), (0, 68, 0, 1)),
     False),                                                  # 136-byte rows
    (lambda: _bf16(64 * 72).as_strided((1, 16, 1, 64), (5, 72, 3, 1)),
     True),                                                   # size-1 dims
])
def test_tma_ready_predicate(make, ready):
    """Which [B, T, H, D] tensors the bf16 K2/K3 read through TMA as they
    lie, and that the others go over as aligned contiguous copies with the
    same values."""
    x = make()
    assert tfa.tma_ready(x) is ready
    (y,) = tfa._for_tma(x)
    assert (y is x) is ready
    assert tfa.tma_ready(y) and torch.equal(y, x)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K2-K4 are CUDA only")
    return torch.device("cuda")


def _norm_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 128, 128, 4, 4, 64, 0, 0),
    (1, 100, 100, 8, 2, 40, 0, 0),      # ragged T, GQA g = 4, D = 40
    (1, 64, 192, 4, 1, 128, 128, 0),    # offsets, Tq != Tk, MQA, D = 128
    (16, 1024, 1024, 32, 32, 64, 0, 0),  # the LM's full width
    (1, 192, 192, 8, 2, 64, 0, 0),      # Tq not a multiple of the 128-row
                                        # bf16 Q tile, GQA g = 4
    (2, 1, 70, 4, 2, 8, 69, 0),         # one query row at the end, D = 8
    (1, 130, 130, 2, 1, 72, 0, 0),      # D = 72: a second atom 8 wide
    (1, 64, 256, 4, 2, 64, 0, 192),     # causal rows that see no key
    # the bf16 K4's 128-row K tiles: the last one ends inside its second
    # warpgroup, with a ragged Tq and offsets
    (2, 200, 328, 4, 2, 64, 128, 0),
    (1, 128, 384, 8, 2, 64, 0, 0),      # Tk > Tq: causal K tiles 1, 2 see
                                        # no query, GQA g = 4
    # q, k, v as the LM block makes them: views of the fused activation
    (16, 1024, 1024, 32, 32, 64, 0, 0, "lm_views"),
    (1, 192, 192, 8, 2, 64, 0, 0, "lm_views"),
])
def test_kernels_match_plain_versions_on_card(cuda_device, shape, causal,
                                              dtype):
    """K2, K3, K4 against their plain versions: float32 to 1e-4 and
    bfloat16 to 2^-7 of max(1, max |value|) (the rounding points are
    shared; only the f32 summation order differs). Keys that no query sees
    get dK = dV = 0 exactly, though the caching allocator hands K4 outputs
    over memory filled with NaN just before."""
    B, Tq, Tk, H, Hk, D, q_off, k_off, *layout = shape
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    if layout:
        q, k, v = _lm_views(rnd, B, Tq, H, Hk, D)
    else:
        q, k, v = rnd(B, Tq, H, D), rnd(B, Tk, Hk, D), rnd(B, Tk, Hk, D)
    do = rnd(B, Tq, H, D)
    args = dict(causal=causal, scale=D ** -0.5)
    before = tfa.flash_forward.launches
    out, lse = tfa.flash_forward(q, k, v, q_off, k_off, **args)
    torch.cuda.synchronize()
    assert tfa.flash_forward.launches == before + 1
    ref, rlse = tfa.flash_forward_reference(q, k, v, q_off, k_off, **args)
    assert _norm_err(out, ref) <= tol
    assert float((lse - rlse).abs().max()) <= 1e-4
    dvec = (do.float() * ref.float()).sum(-1).transpose(1, 2)[..., None]
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, dvec, q_off, k_off, **args)
    # freed at once: the allocator hands its NaNs to K4's outputs
    torch.full((4 * k.numel(),), float("nan"), device=cuda_device)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, rlse, dvec, q_off, k_off, **args)
    torch.cuda.synchronize()
    assert _norm_err(dq, tfa.flash_bwd_dq_reference(
        q, k, v, do, rlse, dvec, q_off, k_off, **args)) <= tol
    rdk, rdv = tfa.flash_bwd_dkv_reference(q, k, v, do, rlse, dvec, q_off,
                                           k_off, **args)
    assert _norm_err(dk, rdk) <= tol and _norm_err(dv, rdv) <= tol
    unseen = min(max(q_off + Tq - k_off, 0), Tk) if causal else Tk
    assert not dk[:, unseen:].any() and not dv[:, unseen:].any()


@pytest.mark.cuda
def test_bf16_dkv_is_bit_identical_across_launches_on_card(cuda_device):
    """The bf16 K4 sums the four q heads of each kv head (GQA g = 4) in a
    fixed order with no atomics: two launches on the same inputs give the
    same dK and dV to the bit."""
    B, T, H, Hk, D = 2, 512, 16, 4, 64
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(
            torch.bfloat16)

    q, k, v, do = rnd(B, T, H, D), rnd(B, T, Hk, D), rnd(B, T, Hk, D), \
        rnd(B, T, H, D)
    args = dict(causal=True, scale=D ** -0.5)
    out, lse = tfa.flash_forward(q, k, v, **args)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    dk1, dv1 = tfa.flash_bwd_dkv(q, k, v, do, lse, dvec, **args)
    dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, do, lse, dvec, **args)
    torch.cuda.synchronize()
    assert dk1.abs().max() > 0 and dv1.abs().max() > 0
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["heads_first", "misaligned"])
def test_bf16_views_tma_cannot_read_go_as_copies_on_card(cuda_device, view):
    """A bf16 q that the kernels' TMA maps cannot take as it lies ([B, H, T,
    D] storage seen transposed, or a base 2 bytes off 16) reaches K2 and K3
    as a contiguous copy: same results as the plain versions, 2^-7 of
    max(1, max |value|), and lse to 1e-4."""
    B, T, H, Hk, D = 2, 160, 4, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(
            torch.bfloat16)

    if view == "heads_first":
        q = rnd(B, H, T, D).transpose(1, 2)
    else:
        q = rnd(B * T * H * D + 1)[1:].reshape(B, T, H, D)
    assert not tfa.tma_ready(q)
    k, v, do = rnd(B, T, Hk, D), rnd(B, T, Hk, D), rnd(B, T, H, D)
    args = dict(causal=True, scale=D ** -0.5)
    out, lse = tfa.flash_forward(q, k, v, **args)
    ref, rlse = tfa.flash_forward_reference(q, k, v, **args)
    dvec = (do.float() * ref.float()).sum(-1).transpose(1, 2)[..., None]
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, dvec, **args)
    torch.cuda.synchronize()
    assert _norm_err(out, ref) <= 2.0 ** -7
    assert float((lse - rlse).abs().max()) <= 1e-4
    assert _norm_err(dq, tfa.flash_bwd_dq_reference(
        q, k, v, do, rlse, dvec, **args)) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["lm_views", "size_one_dims", "base_16"])
def test_tma_ready_views_launch_as_they_lie_on_card(cuda_device, view):
    """Views that :func:`tma_ready` passes go to K2 and K3 uncopied, and the
    kernels' own tensor maps (``make_map``) take them: the launch succeeds
    and agrees with the plain versions to 2^-7 of max(1, max |value|), lse
    to 1e-4. This holds the C++ map builder to the Python rule."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(
            torch.bfloat16)

    T, D = 160, 64
    if view == "lm_views":
        q, k, v = _lm_views(rnd, 2, T, 4, 2, D)
    elif view == "size_one_dims":  # B = H = 1 with strides TMA never reads
        q, k, v = (rnd(T * 72 + 8).as_strided((1, T, 1, D), (5, 72, 3, 1))
                   for _ in range(3))
    else:  # a base 16 bytes past an allocation's start
        q, k, v = (rnd(T * 2 * D + 8)[8:].reshape(1, T, 2, D)
                   for _ in range(3))
    assert all(tfa.tma_ready(x) for x in (q, k, v))
    assert all(a is b for a, b in zip(tfa._for_tma(q, k, v), (q, k, v)))
    do = rnd(*q.shape)
    args = dict(causal=True, scale=D ** -0.5)
    out, lse = tfa.flash_forward(q, k, v, **args)
    ref, rlse = tfa.flash_forward_reference(q, k, v, **args)
    dvec = (do.float() * ref.float()).sum(-1).transpose(1, 2)[..., None]
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, dvec, **args)
    torch.cuda.synchronize()
    assert _norm_err(out, ref) <= 2.0 ** -7
    assert float((lse - rlse).abs().max()) <= 1e-4
    assert _norm_err(dq, tfa.flash_bwd_dq_reference(
        q, k, v, do, rlse, dvec, **args)) <= 2.0 ** -7
