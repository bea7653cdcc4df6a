"""The donated Adam update of a dense table as one CUDA pass.

:func:`adam_apply` launches ``minips_tpu_torch/csrc/adam_apply.cu``: for a
flat float32 gradient ``g`` and the table's params and moments, in place,

    mu = (1 - b1) g + b1 mu;    nu = (1 - b2) g g + b2 nu
    params = params + (-lr) ((mu / bc1) / (sqrt(nu / bc2) + eps))

and the bias corrections ``bc1 = 1 - b1 ** t``, ``bc2 = 1 - b2 ** t`` 0-d float32
tensors on the card, which only the card reads. Its plain version is the
updater's own donated update, ``scale_by_adam``'s ``update_`` followed by
``scale_by_learning_rate`` and ``params.add_`` (``tables/updaters.py``):
the kernel does that float32 arithmetic in the same order with the same
float32 constants, so the two agree bit for bit. ``adam``'s fused form
(``Updater.apply_``) takes the kernel for float32 tensors on the card and
the plain version for any other; this wrapper launches or raises.

The JAX package has no kernel here: XLA fuses optax's update into its
step.
"""

from __future__ import annotations

import ctypes
import functools

import torch


@functools.lru_cache(maxsize=None)
def _launcher():
    from minips_tpu_torch.ops import _build

    fn = _build.load("adam_apply").adam_apply_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adam_apply(g: torch.Tensor, params: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
               b1: float, b2: float, eps: float, lr: float) -> None:
    """One Adam step over ``params``, ``mu`` and ``nu`` in place, from the
    gradient ``g``, of the params' length.

    Launches the CUDA kernel on the current stream and counts the launch
    in ``adam_apply.launches``. All tensors float32, contiguous, on one
    CUDA device; ``g``, ``params``, ``mu`` and ``nu`` one 1-D shape and
    not overlapping, ``bc1`` and ``bc2`` 0-d. Anything else raises."""
    tensors = {"g": g, "params": params, "mu": mu, "nu": nu, "bc1": bc1,
               "bc2": bc2}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if bc1.dim() != 0 or bc2.dim() != 0:
        raise ValueError(f"bc1 and bc2 must be 0-d, got shapes "
                         f"{tuple(bc1.shape)} and {tuple(bc2.shape)}")
    n = params.numel()
    if params.dim() != 1 or n == 0 or any(t.shape != params.shape
                                          for t in (g, mu, nu)):
        raise ValueError(f"g, params, mu and nu must be one non-empty [n] "
                         f"shape, got {tuple(g.shape)}, "
                         f"{tuple(params.shape)}, {tuple(mu.shape)} and "
                         f"{tuple(nu.shape)}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {devices}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("g, params, mu, nu, bc1 and bc2 must be contiguous")
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for t in (g, params, mu, nu) if t.numel())
    if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError("g, params, mu and nu must not overlap")
    if params.device.type != "cuda":
        raise ValueError(f"no Adam kernel for device {params.device}")
    with torch.cuda.device(params.device):
        rc = _launcher()(g.data_ptr(), params.data_ptr(), mu.data_ptr(),
                         nu.data_ptr(), n, bc1.data_ptr(),
                         bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, -lr,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adam_apply kernel launch failed: CUDA error "
                           f"{rc}")
    adam_apply.launches += 1


adam_apply.launches = 0  # kernel launches, for proof a path used it
