"""The port's row gather (K1) against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card (the ``cuda`` test here, and
``chip_smoke.py``). A gather copies values, so every comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ops import pallas_kernels as pk
from minips_tpu_torch.ops import _build
from minips_tpu_torch.ops.gather import gather_rows, gather_rows_reference


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(1, 1703936), (8, 1703936), (128, 4096),
                                 (8, 7), (128, 1)])
def test_kernel_matches_plain_version_on_card(cuda_device, rng, d, n, dtype):
    S = 1 << 18
    emb = torch.randn((S, d), device=cuda_device).to(dtype)
    slots = rng.integers(0, S, n).astype(np.int32)
    slots[: min(n, 4)] = [0, S - 1, 0, S - 1][: min(n, 4)]
    slots_t = torch.from_numpy(slots).to(cuda_device)
    before = gather_rows.launches
    got = gather_rows(emb, slots_t)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_reference(emb, slots_t))
