"""What the references share: the configurations' key hash, and the
roundings of their controls. A control is the same plain arithmetic with
each stated precision taken one step down (float32 storage to bfloat16,
bfloat16 matmul inputs to float8 e4m3 with one scale a tensor, as a float8
training recipe scales them); the products still sum in float32. Plain
PyTorch; imports nothing of the program."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
HASH_MULT = 2654435761  # Knuth's multiplicative constant
MASK32 = 0xFFFFFFFF


def slot_hash(keys: torch.Tensor, num_slots: int, salt: int) -> torch.Tensor:
    """The configurations' key hash, ``((k * M) ^ (k >> 16) ^ salt) mod
    num_slots`` over the key's low 32 bits in uint32 arithmetic, as int64
    slots. The product mod 2^32 is taken from the key's two 16-bit halves,
    so that no partial product leaves int64."""
    k = keys.to(torch.int64) & MASK32
    hi = (((k >> 16) * HASH_MULT) & 0xFFFF) << 16
    prod = ((k & 0xFFFF) * HASH_MULT + hi) & MASK32
    return (prod ^ (k >> 16) ^ (salt & MASK32)) & (num_slots - 1)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` stored in bfloat16 and read back as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, read back as float32. The gradient passes
    straight through (the backward's products stay float32)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32, its inputs first rounded to float8 under the
    control."""
    if precision == "control":
        return to_fp8(a) @ to_fp8(b)
    return a @ b


def store(x: torch.Tensor, precision: str) -> torch.Tensor:
    """State as the precision stores it: float32, or bfloat16 under the
    control."""
    return to_bf16(x) if precision == "control" else x


# The first gradient as an optimizer got it, worked out from its state after
# one step (``delta``: the parameters' change in that step).
def grad_from_row_adagrad(delta, acc, lr: float, eps: float):
    """Row Adagrad, eps outside the root: ``delta = -lr g / (sqrt(acc) +
    eps)``."""
    return -delta * (torch.sqrt(acc) + eps) / lr


def grad_from_adagrad(delta, acc, lr: float, eps: float):
    """Adagrad, eps inside the root: ``delta = -lr g / sqrt(acc + eps)``."""
    return -delta * torch.sqrt(acc + eps) / lr


def grad_from_adam_m(m, b1: float):
    """Adam's first moment after one step from zero: ``m = (1 - b1) g``."""
    return m / (1 - b1)
