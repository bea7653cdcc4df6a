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
``[count, mu, nu]``, ``adam_bf16`` the same in bfloat16, ``adam8``
``[count, mu_q, mu_s, nu_q, nu_s]``, a schedule appends its ``count``), so
the two packages exchange optimizer state leaf by leaf. Updates are
functional: they return new tensors and write none they were given. Each
updater also carries ``restore(new, old, mask) -> state``, the state a
masked push keeps: untouched keys get their old per-key state back.

``adam_bf16`` and ``adam8`` are the JAX package's optimizer-state memory
levers: Adam whose moments are stored in bfloat16, or as blockwise uint8
log-codebook codes with one float32 absmax scale per ``block`` elements.
Their math runs in float32 with the JAX code's constants and operation
order (``b1`` and ``1 - b1`` rounded to float32 first, ``b1 ** t`` in
float32), so the stored moments agree with the JAX package's bit for bit
wherever the float32 moments do.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

UPDATERS = ("sgd", "adagrad", "adam", "adamw", "adam_bf16", "adam8")

# a float, or a schedule: a callable of the int32 step-count tensor that
# returns the learning rate (optax's ScalarOrSchedule)
LearningRate = Union[float, Callable[[torch.Tensor], object]]

_INT32_MAX = torch.iinfo(torch.int32).max
# adam8 updates its flat vector this many elements at a time (rounded down
# to whole blocks): 16 M float32 temporaries are 64 MB each
_ADAM8_SLICE = 1 << 24


class Updater(NamedTuple):
    init: Callable[[torch.Tensor], list]
    update: Callable[[torch.Tensor, list, torch.Tensor],
                     tuple[torch.Tensor, list]]
    num_leaves: int  # len(init(params)): fixed per transform
    # (new_state, old_state, mask) -> the state after a push that touched
    # only the keys where mask > 0
    restore: Callable[[list, list, torch.Tensor], list]


def _per_key(new: list, old: list, mask: torch.Tensor) -> list:
    """Restore for leaves that each hold one value per key."""
    return [torch.where(mask > 0, n, o) for n, o in zip(new, old)]


def _count_then_per_key(new: list, old: list, mask: torch.Tensor) -> list:
    """Restore for ``[count, per-key leaves...]``: the count advances."""
    return [new[0]] + _per_key(new[1:], old[1:], mask)


def _take_new(new: list, old: list, mask: torch.Tensor) -> list:
    return list(new)


def _count0(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params.device)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: saturates at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def chain(*parts: Updater) -> Updater:
    """optax.chain: updates flow through each part in turn; the state is
    the parts' leaves concatenated in order, and each part restores its
    own leaves."""
    def init(params):
        return [leaf for p in parts for leaf in p.init(params)]

    def update(updates, state, params):
        new_state, i = [], 0
        for p in parts:
            updates, s = p.update(updates, state[i:i + p.num_leaves], params)
            new_state.extend(s)
            i += p.num_leaves
        return updates, new_state

    def restore(new, old, mask):
        out, i = [], 0
        for p in parts:
            j = i + p.num_leaves
            out.extend(p.restore(new[i:j], old[i:j], mask))
            i = j
        return out

    return Updater(init, update, sum(p.num_leaves for p in parts), restore)


def _stateless(fn) -> Updater:
    return Updater(lambda params: [],
                   lambda g, state, params: (fn(g, params), []), 0,
                   _take_new)


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
    return Updater(lambda p: [torch.zeros_like(p)], update, 1, _per_key)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Updater:
    """optax.scale_by_rss: Adagrad's root of the summed squares."""
    def update(g, state, params):
        (sos,) = state
        sos = g * g + sos
        inv = torch.where(sos > 0, torch.rsqrt(sos + eps), 0.0)
        return inv * g, [sos]
    return Updater(
        lambda p: [torch.full_like(p, initial_accumulator_value)], update, 1,
        _per_key)


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
        update, 3, _count_then_per_key)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as ``jnp.float32(x)`` gives it."""
    return float(np.float32(x))


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """``1 - b1 ** t`` and ``1 - b2 ** t`` in float32 from the float32
    count, as the JAX package's low-precision Adam computes them."""
    t = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=count.device)
    return (one - torch.pow(one * b1, t), one - torch.pow(one * b2, t))


def scale_by_adam_lowp(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       state_dtype="bfloat16") -> Updater:
    """Adam whose both moments are stored in ``state_dtype`` (bfloat16 by
    default): the math runs in float32 and the new moments are cast down
    on store. State ``[count, mu, nu]``; ``count`` increments without
    saturating, as in the JAX code."""
    sd = (getattr(torch, state_dtype) if isinstance(state_dtype, str)
          else state_dtype)
    b1f, b2f = _f32(b1), _f32(b2)
    c1, c2 = _f32(np.float32(1) - np.float32(b1)), \
        _f32(np.float32(1) - np.float32(b2))

    def init(params):
        return [_count0(params), torch.zeros_like(params, dtype=sd),
                torch.zeros_like(params, dtype=sd)]

    def update(g, state, params):
        count, mu, nu = state
        count = count + 1
        g = g.to(torch.float32)
        # two independent computations, one per moment, as the JAX code's
        # two tree maps
        m_new = b1f * mu.to(torch.float32) + c1 * g
        v_new = b2f * nu.to(torch.float32) + c2 * torch.square(g)
        bc1, bc2 = _bias_corrections(count, b1f, b2f)
        out = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        return out, [count, m_new.to(sd), v_new.to(sd)]

    return Updater(init, update, 3, _count_then_per_key)


class Adam8bitState(NamedTuple):
    """adam8's state, in the JAX package's leaf order."""
    count: torch.Tensor
    mu_q: torch.Tensor  # uint8 codes, params-shaped
    mu_s: torch.Tensor  # float32 absmax scales, one per block
    nu_q: torch.Tensor
    nu_s: torch.Tensor


@functools.lru_cache(maxsize=None)
def _codebook_np(signed: bool) -> np.ndarray:
    """The blockwise-dynamic 8-bit codebooks, built as the JAX package
    builds them (``np.logspace`` in float64, then float32), so that both
    give the same codes. Log-spaced magnitudes keep a block's small
    elements' relative precision next to an outlier.

    signed (m): 255 codes {-1..-1e-6, 0, 1e-6..1};
    unsigned (v): 256 codes {0, 1e-7..1}."""
    if signed:
        mags = np.logspace(-6, 0, 127)
        vals = np.concatenate([-mags[::-1], [0.0], mags])
    else:
        vals = np.concatenate([[0.0], np.logspace(-7, 0, 255)])
    return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=None)
def _codebook(signed: bool, device: torch.device) -> torch.Tensor:
    # kept per device: a host-to-device copy at every call would wait for
    # the card at each slice of the update
    return torch.from_numpy(_codebook_np(signed)).to(device)


def _quantize_block(x: torch.Tensor, block: int, signed: bool = True):
    """Normalize each block by its absmax, then snap to the nearest code
    (ties to the upper code). Returns (uint8 codes, float32 scales)."""
    cb = _codebook(signed, x.device)
    xb = x.reshape(-1, block)
    s = torch.amax(torch.abs(xb), dim=1)
    xn = xb / torch.clamp(s, min=1e-30)[:, None]
    # jnp.searchsorted's side="left"; int32 indices, not int64
    idx = torch.searchsorted(cb, xn, out_int32=True).clamp_(1, cb.numel() - 1)
    left = torch.index_select(cb, 0, (idx - 1).reshape(-1)).view_as(xn)
    right = torch.index_select(cb, 0, idx.reshape(-1)).view_as(xn)
    q = torch.where(xn - left < right - xn, idx - 1, idx)
    if not signed:
        # a positive second moment far below the block's absmax would snap
        # to code 0 and be stored as exactly zero, which spikes the next
        # update; it goes up to the floor code instead
        q = torch.where((xn > 0) & (q == 0), 1, q)
    return q.to(torch.uint8).reshape(-1), s


def _dequantize_block(q: torch.Tensor, s: torch.Tensor, block: int,
                      signed: bool = True) -> torch.Tensor:
    cb = _codebook(signed, q.device)
    vals = torch.index_select(cb, 0, q.reshape(-1).to(torch.int32))
    return (vals.view(-1, block) * s[:, None]).reshape(-1)


def masked_merge_adam8(new_state: Adam8bitState, old_state: Adam8bitState,
                       mask: torch.Tensor) -> Adam8bitState:
    """Block-granular masked restore of quantized moments. A block with no
    touched key gets its old codes and scale back exactly; a block that
    mixes touched and untouched keys is merged in float32 (both states
    dequantized, selected by ``mask``) and quantized again, so its
    untouched keys take one quantize round trip and never a rescale
    against another absmax. An elementwise restore of the codes alone
    would pair them with the new scales. ``block`` is read off the state
    (codes are params-long, scales one per block)."""
    block = new_state.mu_q.shape[0] // new_state.mu_s.shape[0]
    keep = mask > 0
    m = torch.where(keep,
                    _dequantize_block(new_state.mu_q, new_state.mu_s, block),
                    _dequantize_block(old_state.mu_q, old_state.mu_s, block))
    v = torch.where(keep,
                    _dequantize_block(new_state.nu_q, new_state.nu_s, block,
                                      signed=False),
                    _dequantize_block(old_state.nu_q, old_state.nu_s, block,
                                      signed=False))
    mq, ms = _quantize_block(m, block)
    vq, vs = _quantize_block(v, block, signed=False)
    touched = torch.amax(mask.reshape(-1, block), dim=1) > 0
    telem = torch.repeat_interleave(touched, block)
    return Adam8bitState(
        new_state.count,
        torch.where(telem, mq, old_state.mu_q),
        torch.where(touched, ms, old_state.mu_s),
        torch.where(telem, vq, old_state.nu_q),
        torch.where(touched, vs, old_state.nu_s))


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       block: int = 256) -> Updater:
    """Adam with blockwise-quantized 8-bit moments: uint8 log-codebook
    codes plus one float32 absmax scale per ``block`` elements (about
    2 + 8/block bytes of state a parameter against Adam's 8),
    dequantized to float32 for the update and quantized again on store.
    It runs on a dense table's flat vector, whose length must divide by
    ``block`` (the table aligns its padding to the block). State
    :class:`Adam8bitState`, as a list in its leaf order."""
    b1f, b2f = _f32(b1), _f32(b2)
    c1, c2 = _f32(np.float32(1) - np.float32(b1)), \
        _f32(np.float32(1) - np.float32(b2))

    def init(params):
        if params.ndim != 1 or params.shape[0] % block:
            raise ValueError(
                "adam8 runs on DenseTable's flat raveled vector with "
                f"length divisible by block={block}; got shape "
                f"{tuple(params.shape)}")
        n, dev = params.shape[0], params.device
        return [_count0(params),
                torch.full((n,), 127, dtype=torch.uint8, device=dev),  # 0.0
                torch.zeros(n // block, dtype=torch.float32, device=dev),
                torch.zeros(n, dtype=torch.uint8, device=dev),         # 0.0
                torch.zeros(n // block, dtype=torch.float32, device=dev)]

    # elements per slice of the update: whole blocks, so each slice's
    # scales are its own and the result does not depend on the slicing
    step = max(_ADAM8_SLICE // block, 1) * block

    def update(g, state, params):
        st = Adam8bitState(*state)
        count = st.count + 1
        bc1, bc2 = _bias_corrections(count, b1f, b2f)
        n = g.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=g.device)
        mq, vq = torch.empty_like(st.mu_q), torch.empty_like(st.nu_q)
        ms, vs = torch.empty_like(st.mu_s), torch.empty_like(st.nu_s)
        # dequantize -> moments -> quantize one slice at a time: the float32
        # moments and the search's temporaries stay slice-sized, so the
        # update needs little beyond its output and the new codes
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            blo, bhi = lo // block, hi // block
            gs = g[lo:hi].to(torch.float32)
            m = _dequantize_block(st.mu_q[lo:hi], st.mu_s[blo:bhi], block)
            v = _dequantize_block(st.nu_q[lo:hi], st.nu_s[blo:bhi], block,
                                  signed=False)
            m_new = b1f * m + c1 * gs
            v_new = b2f * v + c2 * gs * gs   # ((1 - b2) * g) * g, as in JAX
            torch.div(m_new / bc1, torch.sqrt(v_new / bc2) + eps,
                      out=out[lo:hi])
            mq[lo:hi], ms[blo:bhi] = _quantize_block(m_new, block)
            vq[lo:hi], vs[blo:bhi] = _quantize_block(v_new, block,
                                                     signed=False)
        return out, [count, mq, ms, vq, vs]

    def restore(new, old, mask):
        return list(masked_merge_adam8(Adam8bitState(*new),
                                       Adam8bitState(*old), mask))

    return Updater(init, update, 5, restore)


def add_decayed_weights(weight_decay: float) -> Updater:
    return _stateless(lambda g, params: g + weight_decay * params)


def masked_weight_decay(weight_decay: float, mask: torch.Tensor) -> Updater:
    """Decoupled weight decay where ``mask`` is 1. As in the JAX package,
    the mask rides in the optimizer state (one leaf)."""
    def update(g, state, params):
        (m,) = state
        return g + weight_decay * params * m, [m]
    return Updater(lambda p: [mask.to(device=p.device, dtype=p.dtype)],
                   update, 1, _per_key)


def scale_by_learning_rate(lr: LearningRate) -> Updater:
    """``-lr * g``; a schedule is called with the step count and keeps its
    own int32 ``count`` leaf, as optax.scale_by_schedule does."""
    if not callable(lr):
        return _stateless(lambda g, params: (-lr) * g)

    def update(g, state, params):
        (count,) = state
        step = torch.as_tensor(-lr(count), dtype=g.dtype, device=g.device)
        return step * g, [_safe_increment(count)]
    return Updater(lambda p: [_count0(p)], update, 1, _take_new)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0):
    """``optax.warmup_cosine_decay_schedule`` (0.2.6) as a schedule of the
    int32 count tensor: a linear ramp from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (warm-up included), held there. Its
    float32 operations are optax's, in optax's order."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cosine_steps}.")

    def f32(x, like):
        return torch.tensor(x, dtype=torch.float32, device=like.device)

    def linear(count):  # optax.polynomial_schedule at power 1
        if warmup_steps <= 0:
            return f32(init_value, count)
        c = torch.clamp(count, 0, warmup_steps).to(torch.float32)
        frac = 1 - c / f32(warmup_steps, count)
        return f32(init_value - peak_value, count) * frac + peak_value

    def cosine(count):  # optax.cosine_decay_schedule
        steps = f32(cosine_steps, count)
        c = torch.minimum(count.to(torch.float32), steps)
        decay = 0.5 * (1 + torch.cos(f32(np.pi, count) * c / steps))
        decayed = f32(1 - alpha, count) * decay ** exponent + alpha
        return f32(peak_value, count) * decayed

    def schedule(count):
        count = torch.as_tensor(count, dtype=torch.int32)
        return torch.where(count < warmup_steps, linear(count),
                           cosine(count - warmup_steps))

    return schedule


def make_updater(name: str, lr: LearningRate, **kwargs) -> Updater:
    """The port of ``make_updater``: ``sgd`` (``momentum``), ``adagrad``
    (``initial_accumulator_value``), ``adam``, ``adamw``, ``adam_bf16``
    and ``adam8`` (``b1``, ``b2``; ``weight_decay`` and ``decay_mask`` for
    adamw, ``state_dtype`` for adam_bf16, ``block`` for adam8).
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
    elif name == "adam_bf16":
        # both moments stored bf16: half Adam's optimizer-state bytes
        parts = [scale_by_adam_lowp(kwargs.get("b1", 0.9),
                                    kwargs.get("b2", 0.999),
                                    state_dtype=kwargs.get("state_dtype",
                                                           "bfloat16")),
                 scale_by_learning_rate(lr)]
    elif name == "adam8":
        # blockwise int8 moments: about a quarter of Adam's state bytes
        parts = [scale_by_adam_8bit(kwargs.get("b1", 0.9),
                                    kwargs.get("b2", 0.999),
                                    block=kwargs.get("block", 256)),
                 scale_by_learning_rate(lr)]
    else:
        raise ValueError(
            f"unknown updater {name!r}; expected one of {UPDATERS}")
    if clip:
        parts = [clip_by_global_norm(clip)] + parts
    return chain(*parts)
