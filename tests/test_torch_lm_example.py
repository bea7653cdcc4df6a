"""The port's LM app (``apps/lm_example.py``, ``--layout dp``) against the
JAX package's ``lm_example.run``.

Both start from the JAX ``init``'s weights (the port's ``_init_params``
hook returns them) and train on the same synthetic Markov windows (or the
same file's bytes) in the same batch order, the JAX app on a one-device
mesh. Both models' ``grad_fn`` are swapped for one at float32 compute (the
app's own leaves the matmuls at bf16, where the two frameworks round in
other places): 5 steps of each flag set give the same losses to
``rtol`` 1e-4, only the summation order differing. Greedy ``--generate``
tokens are equal. A resumed run reproduces the uninterrupted run's losses
exactly, a completed run resumed again takes no step, and every flag the
JAX app refuses is refused.

The layouts through a process group: ``--layout dp`` (the table sharded,
each rank on its rows), ``sp`` with each ``--attn`` (ring reference, ring
flash, a2a, a2a_flash), ``tp``, ``pp`` and ``ep`` run on gloo ranks on
the CPU (``run_ranks``; the rank body is ``torch_parallel_ranks.py``'s
``lm_run``), 2 ranks for dp, sp and ep, 2 x 2 for tp and pp, against ``minips_tpu.apps.lm_example.run`` on the 8 host
devices, both from the JAX app's initial weights with every layout's
model at float32 compute: 3 steps give the same losses to ``rtol`` 1e-4
(the losses do not depend on the rank count; ep's capacity of 128 slots
per expert per source holds every route on both sides, whose per-source
token counts differ).
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minips_tpu.apps import lm_example as jlmx
from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.metrics import MetricsLogger as JMetrics
from minips_tpu_torch import interop
from minips_tpu_torch.apps import lm_example as tlmx
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.utils.metrics import MetricsLogger

STEPS = 5
BATCH, SEQ = 8, 32
RTOL = 1e-4


def _cfgs(iters=STEPS, updater="adam", **train):
    from minips_tpu.core import config as jcfg

    out = []
    for m in (jcfg, tcfg):
        t = dict(vars(copy.deepcopy(tlmx.DEFAULT.train)), num_iters=iters,
                 batch_size=BATCH, log_every=0)
        t.update(train)
        table = dict(vars(copy.deepcopy(tlmx.DEFAULT.table)),
                     updater=updater)
        out.append(m.Config(table=m.TableConfig(**table),
                            train=m.TrainConfig(**t)))
    return out


def _args(**kw):
    return dict(dict(seq_len=SEQ), **kw)


def _jgrad_f32(params, batch, *, heads=4, attn_impl="reference",
               remat=False, head_chunk=0, dropout=0.0):
    """The JAX package's ``grad_fn`` at float32 compute."""
    return jax.value_and_grad(lambda p: jtfm.loss(
        p, batch, heads=heads, compute_dtype=jnp.float32,
        attn_impl=attn_impl, remat=remat, head_chunk=head_chunk,
        dropout=dropout))(params)


@pytest.fixture
def f32_models(monkeypatch):
    """Both packages' grad_fn at float32 compute, the JAX app on one
    device, the port's initial weights the JAX app's."""
    jgrad = _jgrad_f32

    def tgrad(params, batch, *, heads=4, attn_impl="reference",
              remat=False, head_chunk=0, dropout=0.0):
        return ttfm.value_and_grad(lambda p: ttfm.loss(
            p, batch, heads=heads, compute_dtype=torch.float32,
            attn_impl=attn_impl, remat=remat, head_chunk=head_chunk,
            dropout=dropout), params)

    def init_params(seed, model, device):
        jp = jtfm.init(jax.random.PRNGKey(seed), **model)
        return interop.tree_from_numpy(jax.tree.map(np.asarray, jp), device)

    monkeypatch.setattr(jtfm, "grad_fn", jgrad)
    monkeypatch.setattr(ttfm, "grad_fn", tgrad)
    monkeypatch.setattr(jlmx, "make_mesh", lambda *a, **k: make_mesh(1))
    monkeypatch.setattr(tlmx, "_init_params", init_params)


def _runs(args, **cfg_kw):
    jc, tc = _cfgs(**cfg_kw)
    want = jlmx.run(jc, argparse.Namespace(**args),
                    JMetrics(None, verbose=False))
    got = tlmx.run(tc, argparse.Namespace(device="cpu", **args),
                   MetricsLogger(None, verbose=False))
    return got, want


CASES = {
    "plain": ({}, {}),
    "flash": (dict(attn="flash"), {}),
    "accum2": (dict(accum=2), {}),
    "comm_int8": (dict(comm="int8"), {}),
    "adamw_warmup_clip": (dict(warmup_steps=3, clip_norm=1.0),
                          dict(updater="adamw")),
    "head_chunk": (dict(head_chunk=8), {}),
    "remat_hybrid": (dict(remat=True, remat_mode="hybrid", attn="flash"),
                     {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_jax(case, f32_models):
    flags, cfg_kw = CASES[case]
    got, want = _runs(_args(**flags), **cfg_kw)
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)


def test_generate_matches_jax(f32_models):
    got, want = _runs(_args(generate=8, kv_heads=2, rope=True))
    assert len(got["generated"]) == 8
    assert got["generated"] == want["generated"]


def test_data_file_matches_jax(f32_models, tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(np.random.default_rng(0).integers(
        32, 127, size=20_000).astype(np.uint8)))
    got, want = _runs(_args(data_file=str(path)), iters=3)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)


def _port(tc, **args):
    return tlmx.run(tc, argparse.Namespace(device="cpu", **_args(**args)),
                    MetricsLogger(None, verbose=False))


def test_checkpoint_resume_and_completed_run(tmp_path):
    _, tc = _cfgs(iters=6)
    whole = _port(tc, dropout=0.1)["losses"]
    ck = str(tmp_path / "ck")
    _, first = _cfgs(iters=4, checkpoint_dir=ck, checkpoint_every=2)
    assert _port(first, dropout=0.1)["losses"] == whole[:4]
    _, again = _cfgs(iters=6, checkpoint_dir=ck, checkpoint_every=2)
    resumed = _port(again, dropout=0.1, resume=True)
    assert resumed["start_step"] == 4
    # the same batches and dropout keys from step 4 on, the restored state
    # bit for bit
    assert resumed["losses"] == whole[4:]
    assert sorted(os.listdir(ck))[-1].endswith("6")
    done = _port(again, dropout=0.1, resume=True)
    assert done["start_step"] == 6 and done["losses"] == []


def test_dropout_and_remat_dots_train_on_cpu():
    _, tc = _cfgs(iters=8)
    out = _port(tc, dropout=0.1, remat=True, remat_mode="dots",
                attn="flash", dtype="bfloat16", head_chunk=8, generate=4,
                temperature=0.8)
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["generated"]) == 4
    assert all(0 <= t < 256 for t in out["generated"])


# flags the JAX app refuses, with the layout each is refused on
REFUSED = [
    dict(attn="a2a"),
    dict(layout="tp", attn="flash"),
    dict(layout="pp", accum=2),
    dict(layout="tp", dtype="bfloat16"),
    dict(layout="ep", comm="int8"),
    dict(layout="pp", clip_norm=1.0),
    dict(layout="tp", warmup_steps=2),
    dict(layout="ep", generate=4),
    dict(layout="sp", remat=True),
    dict(layout="sp", head_chunk=8),
    dict(layout="sp", dropout=0.1),
    dict(dropout=0.1, accum=2),
    dict(weight_decay=0.1),
    dict(dim=30),
    dict(kv_heads=3),
    dict(dim=20, heads=4, rope=True),
]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: "-".join(
    f"{k}={v}" for k, v in f.items()))
def test_refusals_match_jax(flags):
    jc, tc = _cfgs(iters=1)
    with pytest.raises(SystemExit):
        jlmx.run(jc, argparse.Namespace(**_args(**flags)),
                 JMetrics(None, verbose=False))
    with pytest.raises(SystemExit):
        _port(tc, **flags)
    jc, tc = _cfgs(iters=1, updater="adamw")
    if flags.get("layout") in ("tp", "pp", "ep"):
        with pytest.raises(SystemExit, match="adamw"):
            _port(tc, layout=flags["layout"])


# --layout runs: (flags, ranks); sp's 8 heads split over JAX's 8 devices
LAYOUTS = {
    "dp": (dict(layout="dp", attn="flash"), 2),
    "sp-reference": (dict(layout="sp", heads=8), 2),
    "sp-flash": (dict(layout="sp", attn="flash", heads=8), 2),
    "sp-a2a": (dict(layout="sp", attn="a2a", heads=8), 2),
    "sp-a2a_flash": (dict(layout="sp", attn="a2a_flash", heads=8,
                          kv_heads=2, rope=True), 2),
    "tp": (dict(layout="tp", tp=2, kv_heads=2), 4),
    "pp": (dict(layout="pp", tp=2, microbatches=2, rope=True), 4),
    "ep": (dict(layout="ep", experts=8, capacity=128, kv_heads=2), 2),
}
LAYOUT_STEPS = 3


def _jax_weights(jc, flags):
    model = jlmx._model_cfg(argparse.Namespace(**flags), SEQ)
    key = jax.random.PRNGKey(jc.train.seed)
    if flags["layout"] == "ep":
        params = jtfm.init_moe_lm(
            key, vocab=model["vocab"], dim=model["dim"],
            heads=model["heads"], depth=model["depth"],
            max_len=model["max_len"], num_experts=flags["experts"],
            kv_heads=model.get("kv_heads"), rope=model.get("rope", False))
    else:
        params = jtfm.init(key, **model)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def layout_runs():
    """Each layout's port losses, every case run by one spawn per rank
    count."""
    jc, tc = _cfgs(iters=LAYOUT_STEPS)
    cases = {n: [] for _, n in LAYOUTS.values()}
    for name, (flags, n) in LAYOUTS.items():
        cases[n].append((name, "lm_run", dict(
            args=_args(**flags), params=_jax_weights(jc, _args(**flags)),
            table=vars(tc.table), train=vars(tc.train))))
    return {n: run_ranks(ranks.run_cases, n, c, device="cpu")
            for n, c in cases.items()}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_matches_jax(name, layout_runs, monkeypatch):
    flags, n = LAYOUTS[name]
    for fn in ("loss_sp", "apply_tp", "apply_pp", "apply_ep"):
        monkeypatch.setattr(jtfm, fn, functools.partial(
            getattr(jtfm, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(jtfm, "grad_fn", _jgrad_f32)
    jc, _ = _cfgs(iters=LAYOUT_STEPS)
    want = jlmx.run(jc, argparse.Namespace(**_args(**flags)),
                    JMetrics(None, verbose=False))["losses"]
    assert len(want) == LAYOUT_STEPS
    for r in range(n):
        got = layout_runs[n][r][name]["losses"]
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("lr,warmup,iters", [(3e-3, 3, 5), (3e-3, 5, 200),
                                             (1e-3, 10, 4), (0.1, 1, 50)])
def test_warmup_cosine_schedule_matches_optax(lr, warmup, iters):
    """The schedule ``--warmup_steps`` builds, against optax's at every
    count of the run and past its end: the same float32 operations, to
    2 ulp (XLA's and PyTorch's float32 cosines differ by up to one)."""
    import optax

    jc, tc = _cfgs(iters=iters)
    jc.table.lr = tc.table.lr = lr
    args = argparse.Namespace(warmup_steps=warmup)
    want = jlmx._lr_schedule(jc, args)
    got = tlmx._lr_schedule(tc, args)
    total = max(iters, warmup + 1)
    assert isinstance(want, type(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, total)))
    counts = range(total + 3)
    np.testing.assert_allclose(
        [float(got(torch.tensor(c, dtype=torch.int32))) for c in counts],
        [float(want(jnp.int32(c))) for c in counts], rtol=2.5e-7, atol=0)


def test_cli_runs_a_layout_on_spawned_ranks(tmp_path):
    """The CLI's path for a parallel layout: ``--ranks 2`` gloo ranks
    spawned by ``run_ranks``, rank 0's losses returned and its metrics
    written, and the same losses as the same run in this process on the
    one-device group (``run(..., group=None)``): the ring of two gives the
    ring of one's attention at float32, the layers' per-token matmuls run
    at bf16 on both."""
    _, tc = _cfgs(iters=3, metrics_path=str(tmp_path / "m.jsonl"))
    args = argparse.Namespace(device="cpu", ranks=2, **_args(layout="sp"))
    got = tlmx._run_cli(tc, args, MetricsLogger(None, verbose=False))
    assert len(got["losses"]) == 3 and np.all(np.isfinite(got["losses"]))
    logged = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert logged[-1]["final_loss"] == got["losses"][-1]
    assert logged[-1]["layout"] == "sp"
    _, tc = _cfgs(iters=3)
    one = tlmx.run(tc, argparse.Namespace(device="cpu", **_args(layout="sp")),
                   MetricsLogger(None, verbose=False))
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
