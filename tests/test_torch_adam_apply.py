"""The donated Adam update as one CUDA pass: ``adam``'s fused form
(``Updater.apply_``, ``tables/updaters.py`` :func:`fused_adam`), the
kernel wrapper (``ops/adam_apply.py``, ``csrc/adam_apply.cu``) and
``DenseTable.make_step``'s fused path at one shard, against the plain
donated update (``update_`` then ``params.add_``), which the JAX-parity
tests hold against the JAX package. This file imports no JAX, so that its
``cuda`` tests run on the card.

The kernel does the plain update's float32 arithmetic in the same order
with the same float32 constants, so the two agree bit for bit.

On the CPU: ``make_step``'s fused path (the raveled gradient handed to
``apply_`` as it is, no padded copy) against the padded pure step;
``apply_`` against ``update_`` then ``params.add_``; the kernel branch's
Python with the launch emulated; the updaters that keep their own path;
the wrapper's refusals. On the card: the kernel against the plain
version, the captured step, the group, wire and clip paths, the CTR step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minips_tpu_torch.apps.lrmlp import build_lrmlp
from minips_tpu_torch.ops import adam_apply as aa
from minips_tpu_torch.parallel.mesh import init_group
from minips_tpu_torch.tables import updaters as tupd
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.updaters import make_updater
from minips_tpu_torch.utils import profiling
from minips_tpu_torch.utils.profiling import counter_sum, profile_trace
from minips_tpu_torch.utils.tree import value_and_grad

LR = 3e-2
CPU = torch.device("cpu")


def template(num_keys: int, seed: int = 5) -> dict:
    """A params tree of ``num_keys`` elements: a [k, 3] matrix and a bias
    of the rest."""
    gen = torch.Generator().manual_seed(seed)
    k = max((num_keys - 1) // 3, 1)
    return {"w": 0.3 * torch.randn(k, 3, generator=gen),
            "b": 0.1 * torch.randn(num_keys - 3 * k, generator=gen)}


def grad_fn(params, batch):
    def loss(p):
        h = batch["x"][:, :p["w"].shape[0]] @ p["w"]
        return (torch.tanh(h).sum(-1) ** 2).mean() + (p["b"] ** 2).sum()
    return value_and_grad(loss, params)


def elementwise_grad_fn(params, batch):
    """``grad_fn``'s kind of loss from elementwise work and sums, with no
    matrix product, whose algorithm a capture's stream could change."""
    def loss(p):
        x = batch["x"][:, :p["w"].shape[0], None]
        return (torch.tanh(x * p["w"]) ** 2).mean() + (p["b"] ** 2).sum()
    return value_and_grad(loss, params)


def batches(num_keys: int, n: int = 3, device=CPU) -> list[dict]:
    rng = np.random.default_rng(num_keys)
    width = max((num_keys - 1) // 3, 1)
    return [{"x": torch.as_tensor(rng.normal(size=(8, width))
                                  .astype(np.float32), device=device)}
            for _ in range(n)]


def state(table: DenseTable) -> list[torch.Tensor]:
    return [table.params] + list(table.opt_state)


def assert_same(a: DenseTable, b: DenseTable) -> None:
    for x, y in zip(state(a), state(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def spy_apply(table: DenseTable, calls: list) -> None:
    """Record the gradient each ``apply_`` call is handed."""
    inner = table.tx.apply_

    def apply_(g, st, params):
        calls.append(g.shape[0])
        return inner(g, st, params)

    table.tx = table.tx._replace(apply_=apply_)


@pytest.fixture
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("grad_reduce", ["mean", "sum"])
@pytest.mark.parametrize("num_keys", [7, 13, 64, 4099])
def test_fused_step_is_the_padded_update_bit_for_bit(num_keys, grad_reduce,
                                                     accum):
    """Three donated steps through ``apply_`` (the raveled gradient as it
    is) against the step without ``apply_``: the padded copy, the divide by
    the one shard and the pure update, which is ``update_`` then
    ``params.add_`` bit for bit (``test_torch_lfm2.py``)."""
    tree = template(num_keys)
    fused = DenseTable(tree, updater="adam", lr=LR, grad_reduce=grad_reduce,
                       device=CPU)
    plain = DenseTable(tree, updater="adam", lr=LR, grad_reduce=grad_reduce,
                       device=CPU)
    plain.tx = plain.tx._replace(apply_=None)
    calls = []
    spy_apply(fused, calls)
    assert fused.num_keys == num_keys
    steps = [t.make_step(grad_fn, accum=accum) for t in (fused, plain)]
    for b in batches(num_keys):
        losses = [t.step_inplace(s, b) for t, s in zip((fused, plain), steps)]
        assert torch.equal(*losses)
        assert_same(fused, plain)
    assert calls == [num_keys] * 3  # no padded copy
    assert int(fused.opt_state[0]) == 3
    assert fused.params[num_keys:].numel() == fused.padded - num_keys == 0


@pytest.mark.parametrize("n", [1, 3, 37, 4097])
def test_apply_is_update_then_add_on_the_cpu(n):
    """On the CPU ``apply_`` is the plain version, ``update_`` then
    ``params.add_``, written over the params and moments it is handed."""
    tx = make_updater("adam", LR)
    gen = torch.Generator().manual_seed(n)
    params = torch.randn(n, generator=gen)
    st = tx.init(params)
    ref_p, ref_st = params.clone(), [x.clone() for x in st]
    mu, nu = st[1], st[2]
    for _ in range(3):
        g = torch.randn(n, generator=gen)
        params_out, st = tx.apply_(g.clone(), st, params)
        updates, ref_st = tx.update_(g, ref_st, ref_p)
        ref_p.add_(updates)
    assert params_out is params and st[1] is mu and st[2] is nu
    assert torch.equal(params, ref_p)
    assert all(torch.equal(a, b) for a, b in zip(st, ref_st))
    assert int(st[0]) == 3


def emulated_kernel(calls):
    """The kernel's arithmetic as written in ``csrc/adam_apply.cu``, line by
    line in PyTorch on the CPU (its float32 constants from the wrapper's
    doubles), for the kernel branch's Python."""

    def apply(g, params, mu, nu, bc1, bc2, *, b1, b2, eps, lr):
        calls.append(g.shape[0])
        f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        m = g * f(1 - b1) + mu * f(b1)
        v = (g * g) * f(1 - b2) + nu * f(b2)
        u = (m / bc1) / (torch.sqrt(v / bc2) + f(eps))
        params.copy_(params + f(-lr) * u)
        mu.copy_(m)
        nu.copy_(v)

    return apply


@pytest.mark.parametrize("count0", [0, 5, torch.iinfo(torch.int32).max])
def test_kernel_branch_wiring_with_the_launch_emulated(monkeypatch, tmp_path,
                                                       empty_registry,
                                                       count0):
    calls = []
    monkeypatch.setattr(tupd, "adam_apply", emulated_kernel(calls))
    monkeypatch.setattr(tupd, "_kernel_takes", lambda *tensors: True)
    tx = make_updater("adam", LR, b1=0.8, b2=0.99)
    gen = torch.Generator().manual_seed(3)
    params = torch.randn(50, generator=gen)
    st = tx.init(params)
    st[0].fill_(count0)
    st[1].copy_(torch.randn(50, generator=gen))
    st[2].copy_(torch.rand(50, generator=gen))
    ref_p, ref_st = params.clone(), [x.clone() for x in st]
    mu, nu = st[1], st[2]
    with profile_trace(str(tmp_path), device="cpu"):
        for _ in range(2):
            g = torch.randn(50, generator=gen)
            params_out, st = tx.apply_(g.clone(), st, params)
            updates, ref_st = tx.update_(g, ref_st, ref_p)
            ref_p.add_(updates)
    monkeypatch.undo()
    assert calls == [50] * 2
    assert params_out is params and st[1] is mu and st[2] is nu  # in place
    assert torch.equal(params, ref_p)
    assert all(torch.equal(a, b) for a, b in zip(st, ref_st))
    assert st[0].dtype == torch.int32
    assert int(st[0]) == min(count0 + 2, torch.iinfo(torch.int32).max)
    assert counter_sum("dense.fused_update") == 2 * 50


PADDED_PATHS = ["group", "bfloat16_wire", "table_clip"]


def padded_path_steps(path, device, store_path, launches):
    """Three donated steps on the padded, reduced and clipped gradient:
    under a one-rank group (gloo on the CPU, NCCL on the card: the
    reduce-scatter and the loss's all-reduce run), through the bfloat16
    wire, or with the table's clip, against the same table without
    ``apply_``; bit for bit, with ``launches()`` up by one a step."""
    group = None
    if path == "group":
        group, _ = init_group(0, 1, store_path, device)
    try:
        tree = {k: v.to(device) for k, v in template(4099).items()}
        kw = ({"updater_kwargs": {"clip_norm": 0.05}}
              if path == "table_clip" else {})
        fused, plain = (DenseTable(tree, updater="adam", lr=LR,
                                   device=device, group=group, **kw)
                        for _ in range(2))
        plain.tx = plain.tx._replace(apply_=None)
        comm = "bfloat16" if path == "bfloat16_wire" else "float32"
        steps = [t.make_step(elementwise_grad_fn, comm=comm)
                 for t in (fused, plain)]
        before = launches()
        for b in batches(4099, 3, device):
            losses = [t.step_inplace(s, b) for t, s in zip((fused, plain),
                                                            steps)]
            assert torch.equal(*losses)
        if device.type == "cuda":
            torch.cuda.synchronize()
        assert launches() == before + 3
        assert_same(fused, plain)
        assert int(fused.opt_state[0]) == 3
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


@pytest.mark.parametrize("path", PADDED_PATHS)
def test_the_padded_gradient_paths_with_the_launch_emulated(monkeypatch,
                                                            tmp_path, path):
    calls = []
    monkeypatch.setattr(tupd, "adam_apply", emulated_kernel(calls))
    monkeypatch.setattr(tupd, "_kernel_takes", lambda *tensors: True)
    padded_path_steps(path, CPU, str(tmp_path / "store"),
                      lambda: len(calls))
    assert calls == [4099] * 3


def _schedule():
    return tupd.warmup_cosine_decay_schedule(0.0, LR, 2, 10)


# the updaters that keep their own path: (DenseTable kwargs)
NOT_FUSED = {
    "adamw": dict(updater="adamw", lr=LR),
    "adam_bf16": dict(updater="adam_bf16", lr=LR),
    "adam8": dict(updater="adam8", lr=LR, updater_kwargs={"block": 4}),
    "schedule_lr": dict(updater="adam", lr=None),
    "updater_clip_norm": dict(tx=make_updater("adam", LR, clip_norm=0.05)),
    "sgd": dict(updater="sgd", lr=LR),
    "adagrad": dict(updater="adagrad", lr=LR),
}


@pytest.mark.parametrize("case", sorted(NOT_FUSED))
def test_other_updaters_keep_their_own_path(case, tmp_path, empty_registry):
    """No ``apply_``: the donated step is the pure step bit for bit, and
    no kernel launches or counts."""
    kw = dict(NOT_FUSED[case])
    if kw.get("lr", 0) is None:
        kw["lr"] = _schedule()
    tree = template(24)
    donated, pure = (DenseTable(tree, device=CPU, **kw) for _ in range(2))
    assert donated.tx.apply_ is None
    before = aa.adam_apply.launches
    step = donated.make_step(grad_fn)
    with profile_trace(str(tmp_path), device="cpu"):
        for b in batches(24):
            donated.step_inplace(step, b)
            pure.params, pure.opt_state, _ = step(pure.params,
                                                  pure.opt_state, b)
    assert_same(donated, pure)
    assert aa.adam_apply.launches == before
    assert counter_sum("dense.fused_update") == 0


def test_table_clip_and_compressed_wire_take_the_padded_gradient():
    """The table's own clip and a compressed wire keep the padded, coded
    and clipped gradient, which ``apply_`` then consumes: bit for bit the
    parent's ``update_`` path."""
    tree = template(31)
    for kw in (dict(updater_kwargs={"clip_norm": 0.05}), {}):
        comm = "float32" if kw else "bfloat16"
        fused, plain = (DenseTable(tree, updater="adam", lr=LR, device=CPU,
                                   **kw) for _ in range(2))
        plain.tx = plain.tx._replace(apply_=None)
        calls = []
        spy_apply(fused, calls)
        steps = [t.make_step(grad_fn, comm=comm) for t in (fused, plain)]
        for b in batches(31):
            for t, s in zip((fused, plain), steps):
                t.step_inplace(s, b)
            assert_same(fused, plain)
        assert calls == [fused.padded] * 3


def test_pure_step_and_push_do_not_take_apply_():
    """The pure step (no donation) and ``DenseTable.push`` run ``update``."""
    tree = template(20)
    table = DenseTable(tree, updater="adam", lr=LR, device=CPU)
    calls = []
    spy_apply(table, calls)
    step = table.make_step(grad_fn)
    b = batches(20)[0]
    table.params, table.opt_state, _ = step(table.params, table.opt_state, b)
    table.push({"w": torch.ones_like(tree["w"]),
                "b": torch.ones_like(tree["b"])})
    assert calls == []
    assert int(table.opt_state[0]) == 2


def _args(**change):
    """A valid call's arguments but for ``change`` (CPU tensors)."""
    args = dict(g=torch.zeros(8), params=torch.zeros(8), mu=torch.zeros(8),
                nu=torch.zeros(8), bc1=torch.tensor(0.1),
                bc2=torch.tensor(0.001), b1=0.9, b2=0.999, eps=1e-8, lr=LR)
    args.update(change)
    return args


_BUF = torch.zeros(20)
REFUSED = {  # (exception, its message, arguments)
    "g_float64": (TypeError, "g must be float32",
                  _args(g=torch.zeros(8, dtype=torch.float64))),
    "params_bfloat16": (TypeError, "params must be float32",
                        _args(params=torch.zeros(8, dtype=torch.bfloat16))),
    "nu_float16": (TypeError, "nu must be float32",
                   _args(nu=torch.zeros(8, dtype=torch.float16))),
    "bc1_float64": (TypeError, "bc1 must be float32",
                    _args(bc1=torch.tensor(0.1, dtype=torch.float64))),
    "bc2_not_0d": (ValueError, "0-d", _args(bc2=torch.ones(1))),
    "params_2d": (ValueError, "non-empty", _args(params=torch.zeros(2, 4),
                                                 mu=torch.zeros(2, 4),
                                                 nu=torch.zeros(2, 4))),
    "mu_other_shape": (ValueError, "non-empty", _args(mu=torch.zeros(7))),
    "g_longer": (ValueError, "non-empty", _args(g=torch.zeros(9))),
    # g is always the params' length: nothing past it reads as zero
    "g_shorter": (ValueError, "non-empty", _args(g=torch.zeros(7))),
    "empty": (ValueError, "non-empty",
              _args(g=torch.zeros(0), params=torch.zeros(0),
                    mu=torch.zeros(0), nu=torch.zeros(0))),
    "mixed_devices": (ValueError, "more than one device",
                      _args(bc1=torch.tensor(0.1, device="meta"))),
    "g_not_contiguous": (ValueError, "contiguous",
                         _args(g=torch.zeros(16)[::2])),
    "overlap": (ValueError, "overlap",
                _args(g=_BUF[:8], params=_BUF[4:12])),
    # a device with no kernel raises; nothing falls back to the plain update
    "cpu": (ValueError, "no Adam kernel", _args()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    exc, message, args = REFUSED[case]
    before = aa.adam_apply.launches
    with pytest.raises(exc, match=message):
        aa.adam_apply(**args)
    assert aa.adam_apply.launches == before


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Adam kernel is CUDA only")
    return torch.device("cuda")


def _views(n, offsets, device, seed):
    """g, params, mu, nu [n], each a view ``offsets[i]`` floats into its
    own buffer, with a state as after some steps (nu > 0)."""
    gen = torch.Generator(device).manual_seed(seed)
    out = []
    for off, draw in zip(offsets, ("randn", "randn", "randn", "rand")):
        buf = getattr(torch, draw)(n + off, generator=gen, device=device)
        out.append(buf[off:])
    g, p, m, v = out
    return g, p, 0.1 * m, 0.01 * v


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1), (3, 3, 3, 3),
                                     (1, 0, 0, 0), (0, 2, 1, 3)])
@pytest.mark.parametrize("n", [1, 3, 4, 4097, 1 << 16])
def test_kernel_matches_the_plain_update_on_card(cuda_device, n, offsets):
    g, params, mu, nu = _views(n, offsets, cuda_device, n)
    tx = make_updater("adam", LR)
    st = [torch.tensor(7, dtype=torch.int32, device=cuda_device), mu, nu]
    ref_p, ref_st = params.clone(), [x.clone() for x in st]
    before = aa.adam_apply.launches
    for i in range(3):
        gi = g * (i + 1)
        params, st = tx.apply_(gi, st, params)
        updates, ref_st = tx.update_(gi.clone(), ref_st, ref_p)
        ref_p.add_(updates)
    torch.cuda.synchronize()
    assert aa.adam_apply.launches == before + 3
    assert torch.equal(params, ref_p), "params differ from the plain update"
    for a, b in zip(st, ref_st):
        assert torch.equal(a, b), "Adam's state differs from the plain update"


@pytest.mark.cuda
def test_the_captured_fused_step_replays_the_eager_steps(cuda_device):
    """Five fused steps, eager and as the captured step (the capture's own
    step, then four replays), bit for bit; the kernel launches once in the
    capture's warm step and once as it is captured, not at a replay."""
    tree = {k: v.to(cuda_device) for k, v in template(4099).items()}
    eager, graphed = (DenseTable(tree, updater="adam", lr=LR,
                                 device=cuda_device) for _ in range(2))
    bs = batches(4099, 5, cuda_device)
    step_e = eager.make_step(elementwise_grad_fn)
    step_g = graphed.make_step(elementwise_grad_fn)
    before = aa.adam_apply.launches
    want = [float(eager.step_inplace(step_e, b)) for b in bs]
    assert aa.adam_apply.launches == before + 5
    replay, loss = graphed.capture_step(step_g, bs[0])
    assert aa.adam_apply.launches == before + 7
    got = [float(loss)] + [float(replay(b)) for b in bs[1:]]
    torch.cuda.synchronize()
    assert aa.adam_apply.launches == before + 7
    assert got == want
    assert_same(graphed, eager)
    assert int(graphed.opt_state[0]) == 5
    replay.release()


@pytest.mark.cuda
@pytest.mark.parametrize("path", PADDED_PATHS)
def test_the_padded_gradient_paths_launch_the_kernel_bitwise(cuda_device,
                                                             tmp_path, path):
    padded_path_steps(path, cuda_device, str(tmp_path / "store"),
                      lambda: aa.adam_apply.launches)


@pytest.mark.cuda
def test_the_ctr_step_does_not_launch_the_kernel(cuda_device):
    """``PSTrainStep``'s dense update is the pure ``update``: the CTR pair
    launches no Adam kernel."""
    pair = build_lrmlp(1024, cuda_device, seed=0, num_slots=1 << 16)
    before = aa.adam_apply.launches
    for i in range(2):
        pair.lr_step(pair.batches[i % 2])
        pair.mlp_step(pair.batches[i % 2])
    torch.cuda.synchronize()
    assert aa.adam_apply.launches == before
