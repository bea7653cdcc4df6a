"""Server-side updaters — the port of ``minips_tpu/tables/updaters.py``.

The JAX package applies optax transforms to a dense table's flat
parameter vector at push time. The port keeps optax's numerics exactly
(read from optax 0.2.6), not ``torch.optim``'s: ``optax.adagrad`` starts
its accumulator at 0.1 and puts eps INSIDE the root,
``g * where(acc > 0, rsqrt(acc + eps), 0)``, where ``torch.optim.Adagrad``
starts at 0 and adds eps outside the sqrt.

An updater here is a pair of plain functions over one flat tensor:
``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, with ``params + updates`` the new parameters. The
state is a list of tensors in the order of ``jax.tree.leaves`` of the
optax state it mirrors (adagrad ``[sum_of_squares]``, adam
``[count, mu, nu]``, a schedule appends its ``count``), so the two
packages exchange optimizer state leaf by leaf. Updates are functional:
the dense vector is small, and no table-sized state is copied.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

UPDATERS = ("sgd", "adagrad", "adam", "adamw", "adam_bf16", "adam8")

# a float, or a schedule: a callable of the int32 step-count tensor that
# returns the learning rate (optax's ScalarOrSchedule)
LearningRate = Union[float, Callable[[torch.Tensor], object]]

_INT32_MAX = torch.iinfo(torch.int32).max


class Updater(NamedTuple):
    init: Callable[[torch.Tensor], list]
    update: Callable[[torch.Tensor, list, torch.Tensor],
                     tuple[torch.Tensor, list]]
    num_leaves: int  # len(init(params)): fixed per transform


def _count0(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params.device)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: saturates at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def chain(*parts: Updater) -> Updater:
    """optax.chain: updates flow through each part in turn; the state is
    the parts' leaves concatenated in order."""
    def init(params):
        return [leaf for p in parts for leaf in p.init(params)]

    def update(updates, state, params):
        new_state, i = [], 0
        for p in parts:
            updates, s = p.update(updates, state[i:i + p.num_leaves], params)
            new_state.extend(s)
            i += p.num_leaves
        return updates, new_state

    return Updater(init, update, sum(p.num_leaves for p in parts))


def _stateless(fn) -> Updater:
    return Updater(lambda params: [],
                   lambda g, state, params: (fn(g, params), []), 0)


def clip_by_global_norm(max_norm: float) -> Updater:
    """Scale the gradient down to global norm ``max_norm`` when above it."""
    def clip(g, params):
        g_norm = torch.sqrt(torch.sum(g * g))
        return torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)
    return _stateless(clip)


def trace(decay: float) -> Updater:
    """optax.trace (heavy-ball momentum): ``t = g + decay * t``."""
    def update(g, state, params):
        (t,) = state
        new = g + decay * t
        return new, [new]
    return Updater(lambda p: [torch.zeros_like(p)], update, 1)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Updater:
    """optax.scale_by_rss: Adagrad's root of the summed squares."""
    def update(g, state, params):
        (sos,) = state
        sos = g * g + sos
        inv = torch.where(sos > 0, torch.rsqrt(sos + eps), 0.0)
        return inv * g, [sos]
    return Updater(
        lambda p: [torch.full_like(p, initial_accumulator_value)], update, 1)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Updater:
    """optax.scale_by_adam: int32 ``count``, bias correction on both
    moments, eps outside the sqrt."""
    def update(g, state, params):
        count, mu, nu = state
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        count = _safe_increment(count)
        t = count.to(torch.float32)
        mu_hat = mu / (1 - b1 ** t).to(mu.dtype)
        nu_hat = nu / (1 - b2 ** t).to(nu.dtype)
        return mu_hat / (torch.sqrt(nu_hat) + eps), [count, mu, nu]
    return Updater(
        lambda p: [_count0(p), torch.zeros_like(p), torch.zeros_like(p)],
        update, 3)


def add_decayed_weights(weight_decay: float) -> Updater:
    return _stateless(lambda g, params: g + weight_decay * params)


def masked_weight_decay(weight_decay: float, mask: torch.Tensor) -> Updater:
    """Decoupled weight decay where ``mask`` is 1. As in the JAX package,
    the mask rides in the optimizer state (one leaf)."""
    def update(g, state, params):
        (m,) = state
        return g + weight_decay * params * m, [m]
    return Updater(lambda p: [mask.to(device=p.device, dtype=p.dtype)],
                   update, 1)


def scale_by_learning_rate(lr: LearningRate) -> Updater:
    """``-lr * g``; a schedule is called with the step count and keeps its
    own int32 ``count`` leaf, as optax.scale_by_schedule does."""
    if not callable(lr):
        return _stateless(lambda g, params: (-lr) * g)

    def update(g, state, params):
        (count,) = state
        step = torch.as_tensor(-lr(count), dtype=g.dtype, device=g.device)
        return step * g, [_safe_increment(count)]
    return Updater(lambda p: [_count0(p)], update, 1)


def make_updater(name: str, lr: LearningRate, **kwargs) -> Updater:
    """The port of ``make_updater``: ``sgd`` (``momentum``), ``adagrad``
    (``initial_accumulator_value``), ``adam`` and ``adamw``
    (``b1``, ``b2``; ``weight_decay`` and ``decay_mask`` for adamw).
    ``clip_norm`` prepends global-norm clipping over the vector this
    updater sees."""
    name = name.lower()
    clip = kwargs.get("clip_norm")
    if name == "sgd":
        momentum = kwargs.get("momentum", 0.0) or None
        parts = ([trace(momentum)] if momentum is not None else []) + [
            scale_by_learning_rate(lr)]
    elif name == "adagrad":
        parts = [scale_by_rss(kwargs.get("initial_accumulator_value", 0.1)),
                 scale_by_learning_rate(lr)]
    elif name == "adam":
        parts = [scale_by_adam(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
                 scale_by_learning_rate(lr)]
    elif name == "adamw":
        wd = kwargs.get("weight_decay", 0.01)
        mask: Optional[torch.Tensor] = kwargs.get("decay_mask")
        decay = (add_decayed_weights(wd) if mask is None
                 else masked_weight_decay(wd, mask))
        parts = [scale_by_adam(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
                 decay, scale_by_learning_rate(lr)]
    elif name in ("adam_bf16", "adam8"):
        raise NotImplementedError(
            f"updater {name!r} is not ported yet (ROADMAP.md queue 1, "
            "tables/updaters.py: low-precision Adam moments)")
    else:
        raise ValueError(
            f"unknown updater {name!r}; expected one of {UPDATERS}")
    if clip:
        parts = [clip_by_global_norm(clip)] + parts
    return chain(*parts)
