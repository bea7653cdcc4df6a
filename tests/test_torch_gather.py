"""The port's row gather (K1) against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card (the ``cuda`` test here, and
``chip_smoke.py``). A gather copies values, so every comparison is exact.

The (D, N, slot-view offset) grid is the kernel's edges: rows of 4 bytes
(one word, four rows to a 16-byte unit), 32 bytes (two 16-byte words) and
512 bytes (32 words) have kernels of their own, other widths the
runtime-width kernel; N around the 4-row unit; a slot view that starts 1 to
3 elements into its buffer has rows before its first 16-byte aligned slot.
On the CPU the main path's N = 1,703,936 is cut to N_LARGE (memory).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ops import pallas_kernels as pk
from minips_tpu_torch.ops import _build
from minips_tpu_torch.ops.gather import gather_rows, gather_rows_reference


DIMS = (1, 2, 3, 4, 8, 16, 128, 129)
SMALL_NS = (1, 3, 4, 5, 7, 8, 9)
N_LARGE = 4104  # a multiple of 8, as the Pallas kernel needs
N_MAIN = 65536 * 26
OFFSETS = (0, 1, 2, 3)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
BITS = {4: torch.int32, 2: torch.int16}


def slot_view(rng, n, off, num_rows, device="cpu", in_range=False):
    """n int32 slots as a view ``off`` elements into its buffer: random
    rows, with boundary (and unless ``in_range``, out-of-range) slots inside
    the first two 4-slot groups and at the end, and a run of repeats."""
    vals = rng.integers(0, num_rows, n)
    edge = ([0, num_rows - 1, 0, num_rows - 1, num_rows - 1, 0, 1, 1]
            if in_range else
            [-4, num_rows + 9, 0, num_rows - 1, num_rows - 1, 0, -1,
             num_rows])
    vals[:min(n, 8)] = edge[:min(n, 8)]
    if n > 136:
        vals[8:72] = vals[72:136]
        vals[-3:] = (0, num_rows - 1, num_rows - 1) if in_range else (
            -7, num_rows, num_rows - 1)
    buf = torch.empty(n + off, dtype=torch.int32, device=device)
    buf[off:] = torch.as_tensor(vals, dtype=torch.int32, device=device)
    view = buf[off:]
    assert view.storage_offset() == off and view.shape == (n,)
    return view


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the gather kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.parametrize("slot_kind", ["random", "repeated_and_boundary"])
def test_plain_matches_pallas_interpret(rng, slot_kind):
    # the shape at which the JAX package runs its kernel: D=128, N=64
    S, D, N = 512, 128, 64
    emb = rng.normal(size=(S, D)).astype(np.float32)
    if slot_kind == "random":
        slots = rng.integers(0, S, N).astype(np.int32)
    else:
        slots = np.tile(np.asarray([0, 0, S - 1, S - 1, 3, 3, 0, S - 1],
                                   np.int32), N // 8)
    want = np.asarray(pk.gather_rows(jnp.asarray(emb), jnp.asarray(slots),
                                     interpret=True))
    got = gather_rows(torch.from_numpy(emb), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)  # a copy: exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(1, 7), (8, 7), (1, 64), (8, 1)])
def test_any_width_and_count_against_numpy(rng, d, n, dtype):
    S = 64
    emb = torch.from_numpy(rng.normal(size=(S, d)).astype(np.float32)).to(
        dtype)
    slots = rng.integers(0, S, n).astype(np.int32)
    got = gather_rows(emb, torch.from_numpy(slots))
    assert got.shape == (n, d) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  emb.float().numpy()[slots])


@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("n", SMALL_NS + (N_LARGE,))
@pytest.mark.parametrize("d", DIMS)
def test_edge_grid_plain_version_against_numpy(rng, d, n, off):
    S = 64
    slots = slot_view(rng, n, off, S)
    for dtype in DTYPES:
        emb = torch.from_numpy(rng.normal(size=(S, d)).astype(np.float32)
                               ).to(dtype)
        got = gather_rows(emb, slots)
        assert got.shape == (n, d) and got.dtype == dtype
        want = emb.view(BITS[emb.element_size()]).numpy()[
            np.clip(slots.numpy(), 0, S - 1)]
        np.testing.assert_array_equal(
            got.view(BITS[emb.element_size()]).numpy(), want)


@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("n", [n for n in SMALL_NS + (N_LARGE,)
                               if n % 8 == 0])
def test_edge_grid_plain_version_against_pallas_interpret(rng, n, off):
    # the grid's cases the JAX package runs its kernel at: D % 128 == 0 and
    # N % 8 == 0, slots in range
    S, d = 512, 128
    slots = slot_view(rng, n, off, S, in_range=True)
    emb = rng.normal(size=(S, d)).astype(np.float32)
    want = np.asarray(pk.gather_rows(jnp.asarray(emb),
                                     jnp.asarray(slots.numpy()),
                                     interpret=True))
    got = gather_rows(torch.from_numpy(emb), slots)
    np.testing.assert_array_equal(got.numpy(), want)


def test_field_shapes_and_out_of_range_clamp(rng):
    # [B, F] slots give [B, F, D] rows; out-of-range slots clamp as XLA's
    # gather does
    S, D = 16, 8
    emb = torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
    slots = np.asarray([[0, 15, -3], [99, 4, 4]], np.int32)
    got = gather_rows(emb, torch.from_numpy(slots))
    assert got.shape == (2, 3, D)
    np.testing.assert_array_equal(got.numpy(),
                                  emb.numpy()[np.clip(slots, 0, S - 1)])


def test_cpu_tensors_do_not_count_launches(rng):
    before = gather_rows.launches
    gather_rows(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32))
    assert gather_rows.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    emb = torch.zeros(4, 2)
    with pytest.raises(TypeError):
        gather_rows(emb, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(4, 2, 2), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_rows(emb.to(torch.int32), torch.zeros(3, dtype=torch.int32))
    # a device with no kernel raises; nothing falls back to the plain version
    with pytest.raises(ValueError):
        gather_rows(emb.to("meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    # the build runs at first use on the card; without nvcc it says so
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert _build.library_path("gather_rows").name.startswith(
        "libgather_rows-")


@pytest.mark.cuda
@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("n", SMALL_NS + (N_LARGE, N_MAIN))
@pytest.mark.parametrize("d", DIMS)
def test_kernel_matches_plain_version_on_card(cuda_device, rng, d, n, off):
    S = 1 << 18
    slots = slot_view(rng, n, off, S, device=cuda_device)
    for dtype in DTYPES:
        emb = torch.randn((S, d), device=cuda_device).to(dtype)
        before = gather_rows.launches
        got = gather_rows(emb, slots)
        torch.cuda.synchronize()
        assert gather_rows.launches == before + 1
        bits = BITS[emb.element_size()]
        assert torch.equal(got.view(bits),
                           gather_rows_reference(emb, slots).view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8])
def test_kernel_takes_field_shapes_on_card(cuda_device, rng, d):
    # [B, 26] slots, as the LR + MLP step hands them over
    S = 1 << 18
    emb = torch.randn((S, d), device=cuda_device)
    slots = torch.as_tensor(rng.integers(0, S, (65536, 26)),
                            dtype=torch.int32, device=cuda_device)
    got = gather_rows(emb, slots)
    assert got.shape == (65536, 26, d)
    assert torch.equal(got, gather_rows_reference(emb, slots))
