"""Row gather ``emb[slots]`` — the port of K1,
``minips_tpu/ops/pallas_kernels.py:gather_rows`` (``_gather_kernel``).

The JAX package runs its Pallas kernel only on a one-device TPU mesh, for
``D % 128 == 0`` and ``N % 8 == 0``, behind an opt-in switch; elsewhere XLA
gathers. In the port the hand-written CUDA kernel
(``minips_tpu_torch/csrc/gather_rows.cu``) is THE row gather of the
package, at any D and any N: ``SparseTable.pull`` and ``PSTrainStep``'s
row gather both call :func:`gather_rows`.

Which version runs depends only on where the tensors lie. A CUDA tensor
launches the kernel or raises — there is no fallback and no switch. A CPU
tensor takes :func:`gather_rows_reference`, the plain PyTorch version the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.

The gather is forward-only, as in JAX: ``PSTrainStep`` differentiates with
respect to the gathered rows as a leaf, never through the gather.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def gather_rows_reference(emb: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """Plain version: ``emb[clamp(slots, 0, S-1)]``, shape
    ``[*slots.shape, D]``. The clamp is XLA's out-of-range gather rule."""
    return emb[slots.clamp(0, emb.shape[0] - 1).long()]


@functools.lru_cache(maxsize=None)
def _launcher():
    from minips_tpu_torch.ops import _build

    fn = _build.load("gather_rows").gather_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(emb: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[..., :] = emb[clamp(slots[...], 0, S-1), :]``.

    emb: ``[S, D]`` float32, bfloat16 or float16, contiguous.
    slots: int32 of any shape. Returns ``[*slots.shape, D]`` in emb's type.
    On CUDA tensors this launches the kernel (and counts the launch in
    ``gather_rows.launches``); on CPU tensors it runs the plain version.
    """
    if emb.dim() != 2:
        raise ValueError(f"emb must be [S, D], got shape {tuple(emb.shape)}")
    if emb.dtype not in _DTYPES:
        raise TypeError(f"emb dtype {emb.dtype} not in {_DTYPES}")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")
    if emb.device != slots.device:
        raise ValueError(f"emb on {emb.device} but slots on {slots.device}")
    if emb.device.type == "cpu":
        return gather_rows_reference(emb, slots)
    if emb.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {emb.device}")
    if not emb.is_contiguous():
        raise ValueError("emb must be contiguous")
    if emb.shape[0] == 0:
        raise ValueError("cannot gather from an empty table")
    flat = slots.contiguous().view(-1)
    n, d = flat.shape[0], emb.shape[1]
    out = torch.empty((n, d), dtype=emb.dtype, device=emb.device)
    if n and d:
        with torch.cuda.device(emb.device):
            rc = _launcher()(emb.data_ptr(), flat.data_ptr(), out.data_ptr(),
                             n, emb.shape[0], d * emb.element_size(),
                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gather_rows kernel launch failed: CUDA "
                               f"error {rc}")
        gather_rows.launches += 1
    return out.view(*slots.shape, d)


gather_rows.launches = 0  # kernel launches, for proof that a path used it
