"""Row-wise sparse updates — the port of ``minips_tpu/ops/sparse_update.py``.

The per-key server update of a sparse table: scatter-add for SGD, or a
row-wise accumulator step (Adagrad, lazy Adam) on the touched rows only,
with duplicate slots summed before the update ("sum duplicate Adds, then
update"). Shapes stay static, as in the JAX package: the sort-dedup
helper returns a full-length result whose invalid tail has ``rep == 0``
and zero deltas, so the scatter-adds it feeds are no-ops there.

Table state (``emb``, ``accum``, and the sort-dedup path's ``m``, ``v``,
``steps``) is updated IN PLACE and returned, which saves a table-sized
copy per push; callers use the returned tensors as the new state, as with
the JAX functions. Each in-place write is marked below.

On the card ``index_add_`` sums duplicate slots with atomics in no fixed
order, so a row touched many times can differ from the CPU in the last
bits; that, not the algorithm, is the on-card tolerance.

Sort-dedup Adagrad on CUDA tensors launches a hand-written kernel
(``minips_tpu_torch/csrc/row_adagrad.cu``, :func:`row_adagrad_apply`) over
the k distinct rows only, with k left on the card, and no atomics; it does
the plain version's float32 arithmetic in the same order, so its result is
bitwise the plain version's on the same dedup. CPU tensors take the plain
version, :func:`_row_adagrad_sorted_reference`, which the CPU tests hold
against the JAX package and ``chip_smoke.py`` holds the kernel against.
There is no fallback and no switch: a CUDA tensor launches or raises.

A push may touch no row at all: an owner whose shard none of a push's keys
hash into (``tables/sparse.py`` over a process group) gets zero slots, and
each update is then the identity.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from minips_tpu_torch.utils.profiling import Annotation, count, tracing

# Above this table size (elements), the dense-accumulate path's extra
# table-shaped scratch buffer stops being worth it and sort-dedup takes over
# (the same threshold, and so the same strategy per table, as JAX).
DENSE_ACCUM_MAX_ELEMS = 1 << 26


def dedup_segment_sum(slots: torch.Tensor, grads: torch.Tensor):
    """Merge duplicate slots. Returns (rep_slots [B], summed [B, D], valid
    [B]) where only the first k entries (k = number of unique slots) are
    valid; invalid entries have summed == 0 so scatter-adds are no-ops.
    While a profiler runs, the span ``sparse.dedup`` covers it and the
    counter ``sparse.rows`` gets k."""
    return _dedup_segment_sum(slots, grads)[:3]


def _dedup_segment_sum(slots, grads):
    """:func:`dedup_segment_sum`'s three results and k, the number of
    unique slots, as a 0-d int64 tensor on the slots' device: the row
    Adagrad kernel reads it there, so the host never waits for it."""
    slots = slots.reshape(-1)
    n = slots.shape[0]
    if n == 0:
        return slots, grads.reshape(0, grads.shape[-1]), torch.zeros(
            0, dtype=torch.bool, device=slots.device), torch.zeros(
            (), dtype=torch.int64, device=slots.device)
    with Annotation("sparse.dedup", slots.device):
        grads = grads.reshape(n, -1)
        order = torch.argsort(slots, stable=True)
        s_sorted = slots[order]
        g_sorted = grads[order]
        first = torch.ones(n, dtype=torch.bool, device=slots.device)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        seg_id = torch.cumsum(first, 0) - 1
        g_sum = torch.zeros_like(g_sorted).index_add_(0, seg_id, g_sorted)
        rep = torch.zeros(n, dtype=slots.dtype,
                          device=slots.device).scatter_reduce_(
            0, seg_id, s_sorted, "amax")
        k = seg_id[-1] + 1
        valid = torch.arange(n, device=slots.device) < k
        g_sum = torch.where(valid[:, None], g_sum, 0)
        rep = torch.where(valid, rep, 0)
    if tracing():
        count("sparse.rows", k)
    return rep, g_sum, valid, k


def row_sgd(emb: torch.Tensor, slots: torch.Tensor, grads: torch.Tensor,
            lr: float) -> torch.Tensor:
    """SGD scatter: duplicates accumulate natively under scatter-add."""
    flat = slots.reshape(-1)
    step = -lr * grads.reshape(flat.shape[0], emb.shape[1]).to(emb.dtype)
    return emb.index_add_(0, flat, step)  # in place: emb


def row_adagrad(emb: torch.Tensor, accum: torch.Tensor, slots: torch.Tensor,
                grads: torch.Tensor, lr: float, eps: float = 1e-10,
                prefer_dense: bool | None = None):
    """Row-wise Adagrad on the touched rows only: ``accum += g²``,
    ``emb -= lr·g / (sqrt(accum) + eps)`` with eps OUTSIDE the root.

    Two numerically identical strategies, chosen by table size as in JAX:
    dense-accumulate (scatter the batch into a table-shaped buffer, then a
    whole-table update; no sort) up to ``DENSE_ACCUM_MAX_ELEMS``, and
    sort-dedup (argsort + segment sum, O(B log B + B·D), no table-shaped
    scratch) above it."""
    if eps <= 0:
        raise ValueError(f"eps must be > 0, got {eps}")  # dense path divides
    if prefer_dense is None:
        prefer_dense = emb.numel() <= DENSE_ACCUM_MAX_ELEMS
    if prefer_dense:
        return _row_adagrad_dense(emb, accum, slots, grads, lr, eps)
    return _row_adagrad_sorted(emb, accum, slots, grads, lr, eps)


def _scatter_dense(emb, slots, grads):
    flat = slots.reshape(-1)
    with Annotation("sparse.scatter", emb.device):
        return torch.zeros_like(emb).index_add_(
            0, flat, grads.reshape(flat.shape[0], emb.shape[1]).to(emb.dtype))


def _row_adagrad_dense(emb, accum, slots, grads, lr, eps):
    # Untouched rows need no masking: their scattered g is exactly 0, so
    # accum is unchanged and the step is 0/(sqrt(accum)+eps) = 0.
    g = _scatter_dense(emb, slots, grads)
    accum.add_(g * g)  # in place: accum
    emb.sub_(lr * g / (accum.sqrt() + eps))  # in place: emb
    return emb, accum


def _row_adagrad_sorted(emb, accum, slots, grads, lr, eps):
    if emb.device.type == "cpu":
        return _row_adagrad_sorted_reference(emb, accum, slots, grads, lr,
                                             eps)
    return _row_adagrad_sorted_kernel(emb, accum, slots, grads, lr, eps)


def _row_adagrad_sorted_kernel(emb, accum, slots, grads, lr, eps):
    """The dedup, then the kernel over its k distinct rows."""
    rep, g_sum, _, k = _dedup_segment_sum(slots, grads.to(emb.dtype))
    if tracing():  # the rows the kernel writes: k, a 0-d tensor
        count("sparse.entries", k)
    row_adagrad_apply(emb, accum, rep, g_sum, k, lr, eps)
    return emb, accum


def _row_adagrad_sorted_reference(emb, accum, slots, grads, lr, eps):
    """The plain version of sort-dedup Adagrad: a gather and two row
    scatters issued with all n entries of the dedup, whose invalid tail
    adds exact zeros onto row 0."""
    rep, g_sum, _ = dedup_segment_sum(slots, grads.to(emb.dtype))
    if tracing():  # the entries each row scatter below is issued with
        count("sparse.entries", rep.shape[0])
    g2 = g_sum * g_sum
    acc_rows = accum[rep] + g2
    accum.index_add_(0, rep, g2)  # in place: accum
    step = -lr * g_sum / (acc_rows.sqrt() + eps)
    emb.index_add_(0, rep, step)  # in place: emb
    return emb, accum


@functools.lru_cache(maxsize=None)
def _launcher():
    from minips_tpu_torch.ops import _build

    fn = _build.load("row_adagrad").row_adagrad_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_INDEX_DTYPES = (torch.int32, torch.int64)


def row_adagrad_apply(emb: torch.Tensor, accum: torch.Tensor,
                      rows: torch.Tensor, g_sum: torch.Tensor,
                      k: torch.Tensor, lr: float, eps: float) -> None:
    """Row Adagrad, in place, on the first k entries of a sort-dedup push:
    for ``i < k``, ``r = rows[i]``, ``g = g_sum[i]``: ``accum[r] += g*g``,
    then ``emb[r] += -lr*g / (sqrt(accum[r]) + eps)``.

    Launches the CUDA kernel and counts the launch in
    ``row_adagrad_apply.launches``. emb, accum: ``[S, D]`` float32; rows:
    ``[n]`` int32 or int64, whose first k entries are distinct; g_sum:
    ``[n, D]`` float32; k: a 0-d int64 tensor, which only the card reads.
    All contiguous and on one CUDA device; anything else raises (a CPU
    push takes :func:`_row_adagrad_sorted_reference` instead)."""
    if emb.dim() != 2 or accum.shape != emb.shape:
        raise ValueError(f"emb and accum must be one [S, D] shape, got "
                         f"{tuple(emb.shape)} and {tuple(accum.shape)}")
    for name, t in (("emb", emb), ("accum", accum), ("g_sum", g_sum)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if rows.dtype not in _INDEX_DTYPES:
        raise TypeError(f"rows must be int32 or int64, got {rows.dtype}")
    if k.dtype != torch.int64 or k.dim() != 0:
        raise TypeError(f"k must be a 0-d int64 tensor, got {k.dtype} of "
                        f"shape {tuple(k.shape)}")
    if rows.dim() != 1 or g_sum.shape != (rows.shape[0], emb.shape[1]):
        raise ValueError(f"rows must be [n] and g_sum [n, {emb.shape[1]}], "
                         f"got {tuple(rows.shape)} and "
                         f"{tuple(g_sum.shape)}")
    n = rows.shape[0]
    devices = {t.device for t in (emb, accum, rows, g_sum, k)}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {devices}")
    if not all(t.is_contiguous() for t in (emb, accum, rows, g_sum)):
        raise ValueError("emb, accum, rows and g_sum must be contiguous")
    if emb.device.type != "cuda":
        raise ValueError(f"no row Adagrad kernel for device {emb.device}")
    if emb.shape[0] == 0:
        raise ValueError("cannot update an empty table")
    if n == 0 or emb.shape[1] == 0:
        return
    with torch.cuda.device(emb.device):
        rc = _launcher()(emb.data_ptr(), accum.data_ptr(), rows.data_ptr(),
                         rows.element_size(), g_sum.data_ptr(), k.data_ptr(),
                         n, emb.shape[0], emb.shape[1], lr, eps,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_adagrad kernel launch failed: CUDA error "
                           f"{rc}")
    row_adagrad_apply.launches += 1


row_adagrad_apply.launches = 0  # kernel launches, for proof a path used it


def row_adam(emb: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             steps: torch.Tensor, slots: torch.Tensor, grads: torch.Tensor,
             lr: float, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, prefer_dense: bool | None = None):
    """Row-wise LAZY Adam: touched rows get one full Adam step (moments,
    per-row bias correction from a per-row int32 step counter); untouched
    rows are left alone. Same two strategies as :func:`row_adagrad`, with
    the dense path's crossover 4x lower (it streams m and v whole-table and
    makes two more table-shaped temporaries)."""
    if eps <= 0:
        raise ValueError(f"eps must be > 0, got {eps}")
    if prefer_dense is None:
        prefer_dense = emb.numel() <= DENSE_ACCUM_MAX_ELEMS // 4
    if prefer_dense:
        return _row_adam_dense(emb, m, v, steps, slots, grads, lr, b1, b2,
                               eps)
    return _row_adam_sorted(emb, m, v, steps, slots, grads, lr, b1, b2, eps)


def _bias_corrections(active, steps_new, dtype, b1, b2):
    tf = steps_new.to(dtype)
    bc1 = torch.where(active, 1 - b1 ** tf, 1.0)[:, None]
    bc2 = torch.where(active, 1 - b2 ** tf, 1.0)[:, None]
    return bc1, bc2


def _row_adam_dense(emb, m, v, steps, slots, grads, lr, b1, b2, eps):
    # whole-table where()s build new moments anyway, so this path returns
    # new tensors instead of writing in place
    flat = slots.reshape(-1)
    g = _scatter_dense(emb, slots, grads)
    touched = torch.zeros(emb.shape[0], dtype=torch.bool, device=emb.device)
    touched[flat] = True
    tcol = touched[:, None]
    steps_new = steps + touched.to(steps.dtype)
    m_new = torch.where(tcol, b1 * m + (1 - b1) * g, m)
    v_new = torch.where(tcol, b2 * v + (1 - b2) * g * g, v)
    bc1, bc2 = _bias_corrections(touched, steps_new, emb.dtype, b1, b2)
    update = lr * (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
    return emb - torch.where(tcol, update, 0.0), m_new, v_new, steps_new


def _row_adam_sorted(emb, m, v, steps, slots, grads, lr, b1, b2, eps):
    rep, g_sum, valid = dedup_segment_sum(slots, grads.to(emb.dtype))
    if tracing():  # the entries each row scatter below is issued with
        count("sparse.entries", rep.shape[0])
    vcol = valid[:, None]
    m_rows, v_rows = m[rep], v[rep]
    s_new = steps[rep] + valid.to(steps.dtype)
    m_n = b1 * m_rows + (1 - b1) * g_sum
    v_n = b2 * v_rows + (1 - b2) * g_sum * g_sum
    bc1, bc2 = _bias_corrections(valid, s_new, emb.dtype, b1, b2)
    update = lr * (m_n / bc1) / ((v_n / bc2).sqrt() + eps)
    # masked DELTA scatter-adds: invalid entries contribute exactly zero,
    # so the duplicate rep=0 rows of the invalid tail are harmless
    emb.index_add_(0, rep, torch.where(vcol, -update, 0.0))  # in place
    m.index_add_(0, rep, torch.where(vcol, m_n - m_rows, 0.0))  # in place
    v.index_add_(0, rep, torch.where(vcol, v_n - v_rows, 0.0))  # in place
    steps.index_add_(0, rep, valid.to(steps.dtype))  # in place
    return emb, m, v, steps
