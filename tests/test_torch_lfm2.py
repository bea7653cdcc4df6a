"""LFM2 in the port (``models/transformer.py`` ``lfm2_*``,
``parallel/moe.py`` ``moe_dropless``, ``apps/lm.py`` ``build_lm(config=)``)
against the plain reference ``benchmark/reference/lfm2-8b-a1b.py``, on the
CPU at a tiny size: dim 64, 4 q and 2 kv heads, 8 layers of both mixer
kinds with 2 dense FFNs, 8 experts of which a share is held, vocab 256.

Also: the held shares add up to the uncut layer, routing drops nothing,
the conv is causal, every remat mode gives remat off's gradients, the
spans and counters record under a profiler only, the donated Adam update
is the pure one bit for bit, and the new benchmark cell runs through
``benchmark/tinytree.py`` (correct, and not correct under either fault).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark import compare, spec, tinytree  # noqa: E402
from minips_tpu_torch.apps.lm import build_lm  # noqa: E402
from minips_tpu_torch.models import transformer as tfm  # noqa: E402
from minips_tpu_torch.parallel import moe  # noqa: E402
from minips_tpu_torch.tables.dense import DenseTable, cast_floating  # noqa
from minips_tpu_torch.tables.updaters import make_updater  # noqa: E402
from minips_tpu_torch.utils import profiling  # noqa: E402

CELL = "lfm2-8b-a1b.t8192-b2"
REF = spec.load_module(os.path.join(REPO, "benchmark", "reference",
                                    "lfm2-8b-a1b.py"),
                       "benchmark_reference__lfm2-8b-a1b")
with open(os.path.join(REPO, "benchmark", "configs", "lfm2-8b-a1b.json")) as f:
    CONFIG = json.load(f)
# the published keys cut to a tiny size; both mixer kinds, 2 dense layers,
# 6 MoE layers holding experts 2-5 of 8
TINY = dict(CONFIG, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=8,
            layer_types=["conv", "conv", "full_attention", "conv", "conv",
                         "full_attention", "conv", "conv"],
            intermediate_size=96, moe_intermediate_size=32, num_experts=4,
            published_num_experts=8, expert_offset=2, num_experts_per_tok=2,
            vocab_size=256, head_chunk=16)
T = 32
CPU = torch.device("cpu")


def _tokens(seed, b=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (b, T + 1), generator=gen)


def _port_params(seed):
    gen = torch.Generator(device=CPU).manual_seed(seed)
    return tfm.lfm2_init(gen, TINY, CPU)


def _kw(cfg=TINY):
    return {"config": cfg, "expert_bias": tfm.lfm2_expert_bias(cfg, CPU)}


def _ref_grads(p, tokens, precision="f32"):
    """The reference's loss and gradients over a batch, by leaf path."""
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    n = tokens.shape[0] * (tokens.shape[1] - 1)
    total = sum(REF.sequence_nll(p, row, TINY, precision)
                for row in tokens) / n
    total.backward()
    return float(total.detach()), {k: v.grad for k, v in p.items()}


# ---------------------------------------------------- against the reference
def test_the_reference_draws_the_ports_initial_weights():
    prog = compare.flat(_port_params(5))
    ref = REF.init(TINY, 5, CPU)
    assert set(prog) == set(ref)
    for k in ref:
        assert torch.equal(prog[k], ref[k]), k


def test_logits_in_float32_agree_with_the_reference():
    params, toks = _port_params(11), _tokens(12)[:, :-1]
    got = tfm.lfm2_apply(params, toks, compute_dtype=torch.float32,
                         attn_impl="flash", **_kw())
    ref = REF.init(TINY, 11, CPU)
    for b in range(toks.shape[0]):
        want = REF.sequence_hidden(ref, toks[b], TINY) @ ref["tok_emb"].T
        # summation order alone (the grouped GEMM, the flash tiles)
        torch.testing.assert_close(got[b], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_bf16_loss_and_gradient_norms_are_near_the_reference(seed):
    params, toks = _port_params(seed), _tokens(seed + 100)
    loss, grads = tfm.lfm2_grad_fn(
        cast_floating(params, torch.bfloat16), {"tokens": toks},
        compute_dtype=torch.bfloat16, attn_impl="flash", head_chunk=16,
        **_kw())
    ref_loss, ref_grads = _ref_grads(REF.init(TINY, seed, CPU), toks)
    # bf16 matmul inputs and conv gating (2^-8 relative) against float32:
    # seeds 21-32 read at most 0.0048
    assert abs(float(loss) - ref_loss) / ref_loss < 1e-2
    got = {k: compare.norm(v) for k, v in compare.flat(grads).items()}
    want = {k: compare.norm(v) for k, v in ref_grads.items()}
    nums = compare.numbers({"loss": [[1.0]], "grad": got, "delta": got},
                           {"loss": [[1.0]], "grad": want, "delta": want})
    # a leaf's norm sums few products at this size, and a route that bf16
    # flips moves a whole token's share: seeds 21-32 read 0.024-0.110 of
    # the leaf (or the median leaf); a wrong equation reads O(1)
    assert nums["grad_gap"] < 0.15, nums


def test_three_adam_steps_in_float32_agree_with_the_reference():
    cfg = dict(TINY, compute_dtype="float32")
    mix = {"kind": "lm_uniform", "batch": 2, "seq": T, "pool": 3}
    fam = spec.load_module(os.path.join(REPO, "benchmark", "families",
                                        "lfm2.py"), "benchmark_family_lfm2")
    program = fam.Program(cfg, mix, 31, CPU)
    got = program.checked_steps()
    inputs = program.check_inputs()
    program.free()
    want = REF.readings(cfg, inputs, 31, CPU)
    nums = compare.numbers(got, want)
    # float32 on both sides: summation order, through three Adam steps
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-4 \
        and nums["delta_gap"] < 1e-4, nums


# ---------------------------------------------------------------- the MoE
def _uncut_layer(seed, n=48):
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_dropless(gen, dim=64, hidden=32, num_experts=8, held=8,
                          device=CPU)
    x = torch.randn(n, 64, generator=gen)
    return p, x


def _share(p, e0, held):
    return {"router": p["router"], "w13": p["w13"][e0:e0 + held],
            "w2": p["w2"][e0:e0 + held]}


def _ref_moe(p, x, offset=0, bias=None, k=2):
    cfg = dict(TINY, num_experts_per_tok=k)
    return REF.moe(x, p["router"], p["w13"], p["w2"], cfg, torch.matmul,
                   torch.matmul, offset=offset, bias=bias)


def test_four_held_shares_add_up_to_the_uncut_layer():
    p, x = _uncut_layer(41)
    total = sum(moe.moe_dropless(_share(p, e0, 2), x, expert_offset=e0,
                                 k_top=2, expert_bias=torch.zeros(8),
                                 compute_dtype=torch.float32)
                for e0 in range(0, 8, 2))
    torch.testing.assert_close(total, _ref_moe(p, x), rtol=0, atol=1e-6)


def test_routing_drops_no_route_when_every_token_picks_one_expert():
    p, x = _uncut_layer(42)
    bias = torch.zeros(8)
    bias[3] = 10.0  # expert 3 is every token's first choice
    share = _share(p, 2, 4)
    profiling.reset()
    with profile():
        got = moe.moe_dropless(share, x, expert_offset=2, k_top=2,
                               expert_bias=bias, compute_dtype=torch.float32)
    torch.testing.assert_close(got, _ref_moe(share, x, offset=2, bias=bias),
                               rtol=0, atol=1e-6)
    # all 48 tokens reach expert 3, none is dropped
    assert profiling.counter_sum("moe.max_load") == x.shape[0]
    profiling.reset()


def test_what_the_grouped_gemm_leaves_past_the_routes_reaches_nothing(
        monkeypatch):
    p, x = _uncut_layer(43)
    share = _share(p, 0, 2)
    plain = torch._grouped_mm

    def poison(t, offs):  # NaN in every row past the groups
        past = torch.arange(t.shape[0]) >= offs[-1]
        return torch.where(past[:, None], float("nan"), t)

    class Poisoned(torch.autograd.Function):
        """The grouped GEMM with its rows past the groups NaN, in its
        output and in the row operand's gradient."""

        @staticmethod
        def forward(ctx, a, b, offs):
            ctx.save_for_backward(a, b, offs)
            return poison(plain(a, b, offs=offs), offs)

        @staticmethod
        def backward(ctx, g):
            a, b, offs = ctx.saved_tensors
            with torch.enable_grad():
                a, b = a.detach().requires_grad_(), b.detach().requires_grad_()
                ga, gb = torch.autograd.grad(plain(a, b, offs=offs), (a, b), g)
            return poison(ga, offs), gb, None

    def poisoned(a, b, offs):
        return Poisoned.apply(a, b, offs)

    def grads(fn):
        monkeypatch.setattr(torch, "_grouped_mm", fn)
        q = {k: v.clone().requires_grad_() for k, v in share.items()}
        xx = x.clone().requires_grad_()
        out = moe.moe_dropless(q, xx, expert_offset=0, k_top=2,
                               expert_bias=torch.zeros(8),
                               compute_dtype=torch.float32)
        out.pow(2).sum().backward()
        return [out] + [t.grad for t in (xx, *q.values())]

    for a, b in zip(grads(poisoned), grads(plain)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ the blocks
def test_the_conv_mixer_is_causal():
    params = _port_params(51)
    blk = params["blocks"][0]
    a = torch.randn(1, T, 64, generator=torch.Generator().manual_seed(52))
    b = a.clone()
    t = 17
    b[:, t] += 1.0
    ya = tfm._lfm2_conv(a, blk, torch.float32)
    yb = tfm._lfm2_conv(b, blk, torch.float32)
    assert torch.equal(ya[:, :t], yb[:, :t])
    assert not torch.equal(ya[:, t], yb[:, t])
    # width 3: the change reaches t, t + 1 and t + 2 and no further
    assert torch.equal(ya[:, t + 3:], yb[:, t + 3:])
    toks = _tokens(53)[:, :-1]
    toks2 = toks.clone()
    toks2[:, t] = (toks2[:, t] + 1) % TINY["vocab_size"]
    la = tfm.lfm2_apply(params, toks, compute_dtype=torch.float32, **_kw())
    lb = tfm.lfm2_apply(params, toks2, compute_dtype=torch.float32, **_kw())
    assert torch.equal(la[:, :t], lb[:, :t])


@pytest.mark.parametrize("remat", [True, "attn", "dots", "hybrid",
                                   "hybrid_qkv"])
def test_remat_modes_give_the_gradients_of_remat_off(remat):
    params, batch = _port_params(61), {"tokens": _tokens(62)}

    def grads(mode):
        return tfm.lfm2_grad_fn(params, batch, compute_dtype=torch.float32,
                                attn_impl="flash", remat=mode, head_chunk=16,
                                **_kw())

    l0, g0 = grads(False)
    l1, g1 = grads(remat)
    assert torch.equal(l0, l1)
    for (k, a), b in zip(compare.flat(g0).items(), compare.flat(g1).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def test_spans_and_counters_record_under_a_profiler_only():
    lm = build_lm(2, T, device=CPU, seed=71, head_chunk=16, remat="dots",
                  config=TINY)
    profiling.reset()
    lm.table.step_inplace(lm.step, lm.batches[0])
    assert not profiling.span_names() and not profiling.Annotation.counters
    n_moe = len(TINY["layer_types"]) - TINY["num_dense_layers"]
    n_conv = TINY["layer_types"].count("conv")
    with profile():
        lm.table.step_inplace(lm.step, lm.batches[1])
    names = set(profiling.span_names())
    assert {"moe", "moe.route", "moe.dispatch", "moe.experts",
            "moe.combine", "conv"} <= names
    # the forward and the remat recompute record spans; the counters
    # count once a layer a step
    assert len(profiling.span_ms("moe")) == 2 * n_moe
    assert len(profiling.span_ms("conv")) == 2 * n_conv
    routes = list(profiling.Annotation.counters["moe.routes"])
    assert len(routes) == n_moe
    assert len(profiling.Annotation.counters["moe.max_load"]) == n_moe
    held = sum(int(r) for r in routes)
    assert 0 < held <= n_moe * 2 * T * TINY["num_experts_per_tok"]
    assert held / 4 <= profiling.counter_sum("moe.max_load") <= held
    profiling.reset()


# ------------------------------------------------------------ the update
def test_the_donated_adam_update_is_the_pure_one_bit_for_bit():
    gen = torch.Generator().manual_seed(81)
    template = {"w": torch.randn(40, 7, generator=gen),
                "b": torch.randn(7, generator=gen)}
    x = torch.randn(16, 40, generator=gen)

    def grad_fn(p, batch):
        def f(p):
            return ((batch["x"] @ p["w"] + p["b"]).tanh() ** 2).mean()
        from minips_tpu_torch.utils.tree import value_and_grad
        return value_and_grad(f, p)

    pure, donated = (DenseTable(template, updater="adam", lr=1e-2, device=CPU)
                     for _ in range(2))
    assert pure.tx.update_ is not None
    assert make_updater("adagrad", 0.1).update_ is None
    step = pure.make_step(grad_fn)
    for i in range(5):
        batch = {"x": x * (i + 1)}
        before = [pure.params.clone()] + [s.clone() for s in pure.opt_state]
        params, opt, _ = step(pure.params, pure.opt_state, batch)
        # without donation the inputs are left as they were
        assert torch.equal(pure.params, before[0])
        assert all(torch.equal(a, b) for a, b in
                   zip(pure.opt_state, before[1:]))
        pure.params, pure.opt_state = params, opt
        donated.step_inplace(step, batch)
        assert torch.equal(donated.params, pure.params)
        assert all(torch.equal(a, b) for a, b in
                   zip(donated.opt_state, pure.opt_state))


# ------------------------------------------------------- the captured step
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures CUDA work")
    return torch.device("cuda")


def test_capture_step_refuses_a_table_off_the_card():
    table = DenseTable({"w": torch.zeros(3)}, updater="adam", device=CPU)
    with pytest.raises(ValueError, match="CUDA table"):
        table.capture_step(None, {"x": torch.zeros(1)})


@pytest.mark.cuda
def test_the_captured_step_replays_the_eager_steps(cuda_device):
    """Five steps of the tiny LFM2: eager, and as the captured step (the
    capture's own step, then four replays) from the same seed, on the
    same batches. Adam's count, which the update returns anew, advances
    with each replay."""
    eager, graphed = (build_lm(2, T, device=cuda_device, seed=91,
                               head_chunk=16, remat="dots", config=TINY)
                      for _ in range(2))
    batches = eager.batches
    want = [float(eager.table.step_inplace(eager.step, batches[i % 2]))
            for i in range(5)]
    replay, loss = graphed.table.capture_step(graphed.step, batches[0])
    got = [float(loss)] + [float(replay(batches[i % 2]))
                           for i in range(1, 5)]
    # the MoE's scatter-add sums in no fixed order on the card
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(graphed.table.params, eager.table.params,
                               rtol=1e-4, atol=1e-6)
    assert int(graphed.table.opt_state[0]) == int(eager.table.opt_state[0])
    replay.release()


# ------------------------------------------------------ the benchmark cell
@pytest.fixture(scope="module")
def tiny_cell_runs(tmp_path_factory):
    """The new cell of a tiny copy of the benchmark (its configuration cut
    to ``TINY``), run through ``tinytree.py`` as is and under each fault,
    the three at once. The tiny cell computes in float32: the cell's
    limits are set at its own size, and at dim 64 bf16's rounding alone
    reads over the ``delta_gap`` limit (0.013 against 0.006); the bf16
    path is held to the reference above."""
    root = tinytree.make(str(tmp_path_factory.mktemp("tiny_lfm2")))
    path = os.path.join(root, "benchmark", "configs", "lfm2-8b-a1b.json")
    with open(path, "w") as f:
        json.dump(dict(TINY, compute_dtype="float32"), f)
    procs = {}
    env = dict(os.environ, OMP_NUM_THREADS="2")  # three at once
    for fault in (None, "state_unchanged", "half_batch"):
        cmd = [sys.executable, os.path.join(REPO, "benchmark", "tinytree.py"),
               "--root", root, "--workload", CELL, "--seconds", "0.5"]
        procs[fault] = subprocess.Popen(
            cmd + (["--fault", fault] if fault else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    out = {}
    for fault, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[fault] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_the_tiny_cell_is_correct_and_a_broken_step_is_not(tiny_cell_runs,
                                                          fault):
    result = tiny_cell_runs[fault]
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
