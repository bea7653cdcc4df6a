"""The program's spans and counters (``utils/profiling.py``): off without a
profiler (no ``record_function``, no event, no kernel, only the host
``totals``), one instance a call of each span of ``PSTrainStep``,
``ops/sparse_update.py`` and ``DenseTable.make_step`` under a capture, in
the registry and as a ``user_annotation`` in the Chrome trace, the
distinct-rows counter, tables bitwise the same with and without a
profiler, and the benchmark's three readers of the registry."""

from __future__ import annotations

import os
import statistics
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from minips_tpu_torch.apps.lrmlp import build_lrmlp
from minips_tpu_torch.models import lr as lr_model
from minips_tpu_torch.ops import sparse_update
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.utils import profiling
from minips_tpu_torch.utils import trace_analysis as ta
from minips_tpu_torch.utils.profiling import (Annotation, counter_sum,
                                              profile_trace, span_ms,
                                              span_names)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import spec  # noqa: E402

CPU = torch.device("cpu")
B, SLOTS = 64, 1 << 10

# one call of each step: the LR step (``wide``, dense-accumulate), the MLP
# step (``emb``, sort-dedup) and one DenseTable step
WANT = {"ps_step": 2, "ps_step.loss_grad": 2, "ps_step.dense_update": 2,
        "ps_step.route.wide": 1, "ps_step.gather.wide": 1,
        "ps_step.sparse_update.wide": 1, "ps_step.route.emb": 1,
        "ps_step.gather.emb": 1, "ps_step.sparse_update.emb": 1,
        "sparse.scatter": 1, "sparse.dedup": 1, "dense_step": 1,
        "dense_step.pull": 1, "dense_step.grad": 1, "dense_step.update": 1}


@pytest.fixture(autouse=True)
def _empty_registry(monkeypatch):
    # as in the CTR cell: ``wide`` (SLOTS x 1) at the threshold takes the
    # dense-accumulate path, ``emb`` (SLOTS x 8) above it sort-dedup
    monkeypatch.setattr(sparse_update, "DENSE_ACCUM_MAX_ELEMS", SLOTS)
    profiling.reset()
    yield
    profiling.reset()


def _pair(seed=3):
    return build_lrmlp(B, CPU, seed=seed, num_slots=SLOTS,
                       mlp_compute_dtype=torch.float32)


def _dense(accum=1):
    t = DenseTable(lr_model.init(13, device=CPU), name="lr", updater="adam",
                   lr=1e-2, device=CPU)
    g = torch.Generator().manual_seed(5)
    batch = {"x": torch.randn(B, 13, generator=g),
             "y": (torch.rand(B, generator=g) < 0.5).float()}
    return t, t.make_step(lr_model.grad_fn_dense, accum=accum,
                          compute_dtype=torch.bfloat16), batch


def _one_of_each(accum=1):
    ns, (t, step, batch) = _pair(), _dense(accum)
    b = ns.batches[0]
    ns.lr_step(b)
    ns.mlp_step(b)
    t.step_inplace(step, batch)
    return ns, t


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_without_a_profiler(monkeypatch):
    """No profiler: no ``record_function``, no event, no tensor op, nothing
    in the registry; the host ``totals`` still add up (a parent's at least
    its children's)."""
    def refuse(*a, **k):
        raise AssertionError("entered while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with _CountOps() as ops:
        with Annotation("probe", CPU):
            pass
    assert ops.n == 0
    _one_of_each()
    assert not Annotation.spans and not Annotation.counters
    tot = Annotation.totals
    assert set(WANT) <= set(tot)
    for parent in ("ps_step", "dense_step"):
        kids = sum(tot[n] for n in WANT if n.startswith(parent + "."))
        assert 0 < kids <= tot[parent]


@pytest.mark.parametrize("accum", [1, 2])
def test_each_span_once_a_call_under_a_capture(tmp_path, accum):
    with profile_trace(str(tmp_path), device="cpu"):
        _one_of_each(accum)
    assert {n: len(span_ms(n)) for n in span_names()} == WANT
    assert all(ms >= 0 for n in WANT for ms in span_ms(n))
    events, _ = ta.load_events(ta.latest_trace_file(str(tmp_path)))
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    assert {n: sum(e["name"] == n for e in ann) for n in WANT} == WANT
    # nesting is the capture's: each dense_step.* lies inside dense_step
    (outer,) = [e for e in ann if e["name"] == "dense_step"]
    for e in ann:
        if e["name"].startswith("dense_step."):
            assert outer["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("updater", ["adagrad", "adam"])
@pytest.mark.parametrize("shape", [(400,), (50, 8)])
def test_rows_counter_is_the_distinct_slots(tmp_path, shape, updater,
                                            monkeypatch):
    g = torch.Generator().manual_seed(1)
    slots = torch.randint(0, 60, shape, generator=g, dtype=torch.int32)
    emb = torch.randn(64, 4, generator=g)
    state = [torch.full((64, 4), 0.1)]
    if updater == "adam":
        state += [torch.full((64, 4), 0.1),
                  torch.zeros(64, dtype=torch.int32)]
    grads = torch.randn(*shape, 4, generator=g)
    # sparse.entries is the length of the index the row scatters get
    issued = []
    index_add = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kw):
        issued.append(index.numel())
        return index_add(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    fn = getattr(sparse_update, "row_" + updater)
    with profile_trace(str(tmp_path), device="cpu"):
        fn(emb, *state, slots, grads, 0.05, prefer_dense=False)
    assert counter_sum("sparse.rows") == torch.unique(slots).numel()
    # the dedup's own segment sum first, then the row scatters
    assert issued[0] == slots.numel() and len(set(issued[1:])) == 1
    assert counter_sum("sparse.entries") == issued[-1] == slots.numel()
    assert len(span_ms("sparse.dedup")) == 1


def _state(ns, t):
    out = {}
    for name in ("wide", "emb"):
        tab = getattr(ns, name)
        out[name] = [tab.emb] + list(tab.opt_state())
    for name in ("lin", "deep"):
        tab = getattr(ns, name)
        out[name] = [tab.params] + list(tab.opt_state)
    out["lr"] = [t.params] + list(t.opt_state)
    return out


def test_tables_are_bitwise_the_same_under_a_profiler(tmp_path):
    plain = _state(*_one_of_each())
    with profile_trace(str(tmp_path), device="cpu"):
        traced = _state(*_one_of_each())
    assert plain.keys() == traced.keys()
    for k in plain:
        for a, b in zip(plain[k], traced[k], strict=True):
            assert torch.equal(a, b), k


def test_the_benchmarks_readers_of_the_registry(tmp_path, monkeypatch):
    readers = {n: spec.metric_reader(n) for n in
               ("sparse_update_ms.ctr", "update_ms.lm", "scatter_useful.ctr")}
    record = SimpleNamespace(setup_s=1.0, window=None, trace=None, work={},
                             units={}, kind="cpu")
    assert {n: r.read(record) for n, r in readers.items()} == dict.fromkeys(
        readers)
    with profile_trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            _one_of_each()
    got = {n: r.read(record) for n, r in readers.items()}
    assert got["sparse_update_ms.ctr"] == pytest.approx(sum(
        statistics.median(span_ms(f"ps_step.sparse_update.{t}"))
        for t in ("wide", "emb")))
    assert got["update_ms.lm"] == statistics.median(
        span_ms("dense_step.update"))
    ns = _pair()
    rows = torch.unique(ns.emb.slots_of(ns.batches[0]["cat"])).numel()
    assert got["scatter_useful.ctr"] == pytest.approx(100.0 * rows / (B * 26))
    # an older program, without the registry, reads None
    for fn in ("span_names", "span_ms", "counter_sum"):
        monkeypatch.delattr(profiling, fn)
    assert {n: r.read(record) for n, r in readers.items()} == dict.fromkeys(
        readers)
