"""Sort-dedup row Adagrad on the card: the CUDA kernel
(``minips_tpu_torch/csrc/row_adagrad.cu``, ``row_adagrad_apply``) over the
k distinct rows of a push, against its plain version
(``_row_adagrad_sorted_reference``). The plain version is held against the
JAX package in ``test_torch_sparse_update.py``; this file imports no JAX,
so that its ``cuda`` tests run on the card.

The kernel does the plain version's float32 arithmetic in the same order,
and the plain version's tail adds exact zeros, so on one dedup the two
agree bit for bit. The dedup's own segment sum uses atomics on the card,
in no fixed order, so the tests on the card run in PyTorch's deterministic
mode: both sides then sum each row's gradient the same way.

On the CPU: the plain version against a numpy loop over the distinct rows
(the kernel's own walk), the private dedup's k, the kernel
path's wiring with the launch emulated, the wrapper's refusals and the
launch counter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minips_tpu_torch.ops import sparse_update as tsu
from minips_tpu_torch.utils import profiling
from minips_tpu_torch.utils.profiling import counter_sum, profile_trace

LR, EPS = 0.05, 1e-10
DIMS = (1, 8, 13, 64)
CTR_N, CTR_SLOTS = 131072 * 26, 1 << 26  # the CTR cell's push and table


def draw_slots(rng, n, num_rows, dist):
    """n slots in [0, num_rows): Zipf(1.05) ranks spread over the table by
    an odd multiplier (a bijection mod a power of two), or uniform."""
    if dist == "zipf":
        ranks = rng.zipf(1.05, n) - 1
        return (ranks % num_rows * 2654435761) % num_rows
    return rng.integers(0, num_rows, n)


def make_push(rng, num_rows, d, n, dist, index_dtype, device="cpu"):
    slots = torch.as_tensor(draw_slots(rng, n, num_rows, dist),
                            dtype=index_dtype, device=device)
    grads = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                            device=device)
    return slots, grads


def make_table(rng, num_rows, d, device="cpu", offset=0):
    """emb and accum as views ``offset`` floats into their buffers (drawn
    on the device: the CTR's table is 2^26 rows)."""
    gen = torch.Generator(device).manual_seed(int(rng.integers(1 << 31)))
    size = num_rows * d + offset
    emb = 0.01 * torch.randn(size, generator=gen, device=device)
    accum = torch.full((size,), 0.1, device=device)
    return (emb[offset:].view(num_rows, d), accum[offset:].view(num_rows, d))


def adagrad_loop(emb, accum, slots, grads, lr, eps):
    """The kernel's walk in numpy float32: sum each distinct slot's
    gradients in push order, then update each distinct row once."""
    emb, accum = emb.copy(), accum.copy()
    uniq, inv = np.unique(slots, return_inverse=True)
    g_sum = np.zeros((uniq.size, emb.shape[1]), np.float32)
    np.add.at(g_sum, inv, grads)
    neg_lr, eps = np.float32(-lr), np.float32(eps)
    for r, g in zip(uniq, g_sum):
        acc = accum[r] + g * g
        accum[r] = acc
        emb[r] = emb[r] + (neg_lr * g) / (np.sqrt(acc) + eps)
    return emb, accum


@pytest.fixture
def rng():
    return np.random.default_rng(21)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the row Adagrad kernel is CUDA "
                    "only")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """The dedup's segment sum without atomics on the card, so that two
    dedups of one push give the same sums."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("d", DIMS)
def test_plain_version_is_the_loop_over_distinct_rows(rng, d, dist,
                                                      index_dtype):
    num_rows, n = 1 << 12, 3000
    emb, accum = make_table(rng, num_rows, d)
    want = emb.numpy(), accum.numpy()
    for _ in range(2):
        slots, grads = make_push(rng, num_rows, d, n, dist, index_dtype)
        want = adagrad_loop(*want, slots.numpy(), grads.numpy(), LR, EPS)
        emb, accum = tsu._row_adagrad_sorted_reference(emb, accum, slots,
                                                       grads, LR, EPS)
    # accum takes no square root: bit for bit. emb within two float32 ulps
    # of its values (|emb| < 0.25): PyTorch's CPU square root is not
    # correctly rounded under AVX-512 (numpy's, and the card's, are)
    np.testing.assert_array_equal(accum.numpy(), want[1])
    assert np.abs(want[0]).max() < 0.25
    np.testing.assert_allclose(emb.numpy(), want[0], rtol=0, atol=3e-8)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (50, 8)])
def test_private_dedup_gives_k_on_the_device(rng, shape, index_dtype):
    slots = torch.as_tensor(rng.integers(0, 20, shape), dtype=index_dtype)
    grads = torch.as_tensor(rng.normal(size=(*shape, 3)).astype(np.float32))
    rep, g_sum, valid, k = tsu._dedup_segment_sum(slots, grads)
    public = tsu.dedup_segment_sum(slots, grads)
    for got, want in zip((rep, g_sum, valid), public):
        assert torch.equal(got, want)
    assert k.dim() == 0 and k.dtype == torch.int64
    assert int(k) == torch.unique(slots).numel() == int(valid.sum())
    # the first k entries are the distinct slots, ascending
    assert torch.equal(rep[:int(k)], torch.unique(slots))


def emulated_kernel(calls):
    """row_adagrad_apply's contract in plain PyTorch, for the kernel path's
    Python on the CPU: the first k rows are distinct; each is updated once
    and nothing else is touched."""

    def apply(emb, accum, rows, g_sum, k, lr, eps):
        calls.append((rows.shape[0], int(k)))
        r = rows[:int(k)].long()
        assert r.unique().numel() == r.numel()
        g = g_sum[:r.numel()]
        acc = accum[r] + g * g
        accum[r] = acc
        emb[r] = emb[r] + -lr * g / (acc.sqrt() + eps)

    return apply


@pytest.mark.parametrize("shape", [(400,), (50, 8)])
def test_kernel_path_walks_k_rows_and_counts_them(rng, monkeypatch, tmp_path,
                                                  empty_registry, shape):
    calls = []
    monkeypatch.setattr(tsu, "row_adagrad_apply", emulated_kernel(calls))
    slots = torch.as_tensor(rng.integers(0, 60, shape), dtype=torch.int32)
    grads = torch.as_tensor(rng.normal(size=(*shape, 4)).astype(np.float32))
    emb, accum = make_table(rng, 64, 4)
    want = tsu._row_adagrad_sorted_reference(emb.clone(), accum.clone(),
                                             slots, grads, LR, EPS)
    profiling.reset()
    with profile_trace(str(tmp_path), device="cpu"):
        got = tsu._row_adagrad_sorted_kernel(emb, accum, slots, grads, LR,
                                             EPS)
    k = torch.unique(slots).numel()
    assert calls == [(slots.numel(), k)]
    # on the kernel path every write the push issues is a distinct row
    assert counter_sum("sparse.entries") == counter_sum("sparse.rows") == k
    assert got[0] is emb and got[1] is accum  # in place
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_tensors_do_not_count_launches(rng):
    before = tsu.row_adagrad_apply.launches
    emb, accum = make_table(rng, 64, 8)
    slots, grads = make_push(rng, 64, 8, 100, "zipf", torch.int32)
    for dense in (False, True):
        tsu.row_adagrad(emb, accum, slots, grads, LR, prefer_dense=dense)
    assert tsu.row_adagrad_apply.launches == before


def _args(**change):
    """A valid call's arguments but for ``change`` (CPU tensors)."""
    args = dict(emb=torch.zeros(16, 8), accum=torch.zeros(16, 8),
                rows=torch.zeros(5, dtype=torch.int32),
                g_sum=torch.zeros(5, 8), k=torch.tensor(1), lr=LR, eps=EPS)
    args.update(change)
    return args


REFUSED = {
    "emb_float64": (TypeError, _args(emb=torch.zeros(16, 8,
                                                     dtype=torch.float64),
                                     accum=torch.zeros(16, 8,
                                                       dtype=torch.float64))),
    "accum_bfloat16": (TypeError,
                       _args(accum=torch.zeros(16, 8, dtype=torch.bfloat16))),
    "g_sum_float16": (TypeError,
                      _args(g_sum=torch.zeros(5, 8, dtype=torch.float16))),
    "rows_int16": (TypeError, _args(rows=torch.zeros(5, dtype=torch.int16))),
    "k_int32": (TypeError, _args(k=torch.tensor(1, dtype=torch.int32))),
    "k_not_0d": (TypeError, _args(k=torch.ones(1, dtype=torch.int64))),
    "emb_3d": (ValueError, _args(emb=torch.zeros(16, 8, 1),
                                 accum=torch.zeros(16, 8, 1))),
    "accum_other_shape": (ValueError, _args(accum=torch.zeros(16, 4))),
    "rows_2d": (ValueError, _args(rows=torch.zeros(5, 1, dtype=torch.int32))),
    "g_sum_other_rows": (ValueError, _args(g_sum=torch.zeros(4, 8))),
    "g_sum_other_width": (ValueError, _args(g_sum=torch.zeros(5, 4))),
    "mixed_devices": (ValueError, _args(k=torch.tensor(1, device="meta"))),
    "emb_not_contiguous": (ValueError,
                           _args(emb=torch.zeros(8, 16).t(),
                                 accum=torch.zeros(16, 8))),
    "g_sum_not_contiguous": (ValueError, _args(g_sum=torch.zeros(8, 5).t())),
    # a device with no kernel raises; nothing falls back to the plain version
    "cpu": (ValueError, _args()),
    "meta": (ValueError, {k: v.to("meta") if torch.is_tensor(v) else v
                          for k, v in _args().items()}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    exc, args = REFUSED[case]
    before = tsu.row_adagrad_apply.launches
    with pytest.raises(exc):
        tsu.row_adagrad_apply(**args)
    assert tsu.row_adagrad_apply.launches == before


# ---------------------------------------------------------------- the card
def _kernel_against_plain(emb, accum, pushes):
    """Both versions over the same pushes from the same table; returns the
    kernel's launches."""
    ref = emb.clone(), accum.clone()
    before = tsu.row_adagrad_apply.launches
    for slots, grads in pushes:
        got = tsu._row_adagrad_sorted(emb, accum, slots, grads, LR, EPS)
        ref = tsu._row_adagrad_sorted_reference(*ref, slots, grads, LR, EPS)
        assert got[0] is emb and got[1] is accum
    torch.cuda.synchronize()
    assert torch.equal(emb, ref[0]), "emb differs from the plain version"
    assert torch.equal(accum, ref[1]), "accum differs from the plain version"
    return tsu.row_adagrad_apply.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("d", DIMS)
def test_kernel_matches_plain_version_on_card(cuda_device, deterministic, rng,
                                              d, dist, index_dtype):
    num_rows, n = 1 << 16, 50000
    emb, accum = make_table(rng, num_rows, d, cuda_device)
    pushes = [make_push(rng, num_rows, d, n, dist, index_dtype, cuda_device)
              for _ in range(2)]
    assert _kernel_against_plain(emb, accum, pushes) == 2


EDGES = ("one_slot", "one_slot_zero", "slot_zero_among_rows", "all_distinct",
         "unaligned_table", "empty")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 13])
@pytest.mark.parametrize("case", EDGES)
def test_kernel_edges_on_card(cuda_device, deterministic, rng, case, d):
    num_rows, n = 4096, 3000
    # tables one float into their buffers: 4-byte aligned, the scalar kernel
    emb, accum = make_table(rng, num_rows, d, cuda_device,
                            offset=int(case == "unaligned_table"))
    slots = torch.as_tensor(draw_slots(rng, n, num_rows, "zipf"),
                            dtype=torch.int32, device=cuda_device)
    if case == "one_slot":
        slots.fill_(77)
    elif case == "one_slot_zero":
        slots.fill_(0)
    elif case == "slot_zero_among_rows":
        slots[::5] = 0
    elif case == "all_distinct":
        slots = torch.randperm(num_rows, device=cuda_device)[:n].int()
    elif case == "empty":
        slots = slots[:0]
    grads = torch.randn((slots.numel(), d), device=cuda_device)
    untouched = torch.ones(num_rows, dtype=torch.bool, device=cuda_device)
    untouched[slots.long()] = False
    before = emb[untouched].clone(), accum[untouched].clone()
    launches = _kernel_against_plain(emb, accum, [(slots, grads)] * 2)
    assert launches == (0 if case == "empty" else 2)
    assert torch.equal(emb[untouched], before[0])
    assert torch.equal(accum[untouched], before[1])


@pytest.mark.cuda
def test_ctr_push_on_card(cuda_device, deterministic, rng):
    # the CTR cell's emb push: 131072 x 26 Zipf slots into 2^26 x 8 rows,
    # through the public entry point, which picks sort-dedup at this size
    emb, accum = make_table(rng, CTR_SLOTS, 8, cuda_device)
    slots, grads = make_push(rng, CTR_SLOTS, 8, CTR_N, "zipf", torch.int32,
                             cuda_device)
    ref = emb.clone(), accum.clone()
    before = tsu.row_adagrad_apply.launches
    tsu.row_adagrad(emb, accum, slots.view(131072, 26),
                    grads.view(131072, 26, 8), LR)
    tsu._row_adagrad_sorted_reference(*ref, slots, grads, LR, EPS)
    torch.cuda.synchronize()
    assert tsu.row_adagrad_apply.launches == before + 1
    assert torch.equal(emb, ref[0]) and torch.equal(accum, ref[1])
