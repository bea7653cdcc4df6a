"""``--exec multiproc`` of the port's Wide&Deep, MF and word2vec apps, and
``sharded_ps_example``: launched jobs on the port's launcher, every rank
pinned to the CPU (``MINIPS_FORCE_CPU``), held to the JAX package's
multiproc contracts (``tests/test_distributed_smoke.py``): no frame
dropped, falling loss, the SSP skew bound, replica agreement after
finalize (fingerprints within 1e-4) and 1/N memory per process.

Each app is also held to the JAX package's job with the same flags: each
rank's first loss within 1e-6, and for Wide&Deep and ``sharded_ps_example``
its later loss and parameter sum. Both packages seed the tables and the
batches alike (Wide&Deep's deep tower excepted: its JAX weights are
carried across by ``torch_wd_multiproc.py``), but a rank's first pull
races its peers' first pushes (a peer's push to its own shard lands at
once), so those jobs run with a fixed 400 ms tax on every frame between
the ranks (``MINIPS_CHAOS`` ``slow#0-1``). An owner's own first push then
waits for its remote pulls, two taxed hops, while a peer's pull reaches
it in one hop plus the ranks' skew out of the handshake (near zero: the
handshake's last round is symmetric); and each owner applies its own
push before its peer's, in either package. What is left of the tax is
the margin for a rank that the host does not schedule: 200 ms was once
too little on a loaded 8-core host (a port rank's first pull of
word2vec's zero-initialized context table saw its peer's first push).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from minips_tpu import launch as jlaunch
from minips_tpu_torch import launch

CPU = {"MINIPS_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu"}
# the port's CPU ranks: one intra-op thread each (their steps are small,
# and the test run shares the host with other jobs)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
TAX = {"MINIPS_CHAOS": "1:slow#0-1=400"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WD_RANK = os.path.join(ROOT, "tests", "torch_wd_multiproc.py")


def _run(n, argv, *, port=True, env=None):
    return (launch if port else jlaunch).run_local_job(
        n, argv,
        env_extra=dict(CPU, **(ONE_THREAD if port else {}), **(env or {})),
        timeout=240.0)


def _app(app, pkg="minips_tpu_torch"):
    multiproc = [] if app == "sharded_ps_example" else ["--exec",
                                                         "multiproc"]
    return [sys.executable, "-m", f"{pkg}.apps.{app}"] + multiproc


def _job(app, n, flags, *, env=None):
    return _run(n, _app(app) + flags, env=env)


def _agree(res, tol=1e-4):
    fps = [r["param_fingerprint"] for r in res]
    assert max(fps) - min(fps) < tol, fps


def test_wide_deep_ssp_straggler_three_processes():
    slots = 1 << 18
    res = _job("wide_deep_example", 3, [
        "--consistency", "ssp", "--staleness", "4", "--num_slots",
        str(slots), "--num_iters", "40", "--batch_size", "256",
        "--slow-rank", "1", "--slow-ms", "25"])
    for r in res:
        assert r["event"] == "done" and r["device"] == "cpu"
        assert r["frames_dropped"] == 0, r
        assert r["wire_frames_malformed"] == 0, r
        assert r["loss_last"] < r["loss_first"], r
        assert r["auc"] > 0.65, r["auc"]
        assert r["max_skew_seen"] <= 5  # s + 1
        assert r["local_bytes"] * 3 <= r["table_bytes"] * 1.01 + 64
        # row-sparse wire: never a table-sized relay per step
        full_relay = r["clock"] * slots * 9 * 4 * 2
        assert r["sparse_bytes_pushed"] < full_relay / 20
    assert any(r["gate_waits"] > 0 for r in res if r["rank"] != 1)
    _agree(res)


def test_wide_deep_int8_push_wire():
    """The compressed push wire: the same key streams, so the emb table's
    wire bytes land at the codec's ratio, (8 + 4 + 8) / (8 + 32) per
    remote row at dim 8, while training converges with a live AUC and the
    replicas agree."""
    flags = ["--consistency", "ssp", "--staleness", "2", "--num_slots",
             "16384", "--num_iters", "30", "--batch_size", "256"]
    f32 = _job("wide_deep_example", 2, flags + ["--push-comm", "float32"])
    q8 = _job("wide_deep_example", 2, flags + ["--push-comm", "int8"])
    for r in q8:
        assert r["event"] == "done" and r["push_comm"] == "int8"
        assert r["frames_dropped"] == 0, r
        assert r["loss_last"] < r["loss_first"], r
        assert r["auc"] > 0.6, r["auc"]
        assert r["max_skew_seen"] <= 3
    _agree(q8)
    for rf, rq in zip(f32, q8):
        assert abs(rq["emb_bytes_pushed"] / rf["emb_bytes_pushed"] - 0.5) \
            < 0.02
    assert (max(r["loss_last"] for r in q8)
            < max(r["loss_last"] for r in f32) + 0.05)


def _matches_jax(app, flags, *, port_argv=None, last_tol=None,
                 sum_tol=None):
    """The port's 2-process job against the JAX app's with the same flags,
    under the tax (the two jobs side by side: they spend it waiting):
    each rank's first loss within 1e-6, its last loss within ``last_tol``
    and its parameter sum (or fingerprint) within ``sum_tol`` where
    given."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        # a script's rank finds the package through PYTHONPATH
        got = pool.submit(_run, 2, (port_argv or _app(app)) + flags,
                          env=dict(TAX, PYTHONPATH=ROOT))
        want = pool.submit(_run, 2, _app(app, "minips_tpu") + flags,
                           port=False, env=TAX)
        got, want = got.result(), want.result()
    by_rank = {r["rank"]: r for r in want}
    assert sorted(by_rank) == [0, 1], want
    for r in got:
        w = by_rank[r["rank"]]
        assert abs(r["loss_first"] - w["loss_first"]) < 1e-6, (got, want)
        if last_tol is not None:
            assert abs(r["loss_last"] - w["loss_last"]) < last_tol, (got,
                                                                     want)
        if sum_tol is not None:
            key = "param_sum" if "param_sum" in r else "param_fingerprint"
            assert abs(r[key] - w[key]) < sum_tol, (got, want)
    return got


def test_wide_deep_bsp_matches_the_jax_job(tmp_path):
    """The deep tower starts from the JAX app's ``PRNGKey(seed + 2)`` draw
    (saved here, loaded by every rank of ``torch_wd_multiproc.py``); the
    wide and emb tables' seeded init, each rank's synthetic data and
    batches, the deep table's layout and its delta from the shared vector
    must then agree for the first losses to. Under the tax each owner
    applies its own push before its peer's, in either package, so the
    third step's loss and the fingerprint after finalize are held too,
    within 1e-4 and 1e-2: the deep tower runs in bfloat16 and the two
    frameworks sum in other orders (4e-6 and 7e-4 seen). The wide and emb
    tables run sgd at lr 0.5: adagrad, the default, is blind to a push's
    scale, and at lr 0.05 a push to the wide table moves the fingerprint
    by less than that noise."""
    import jax

    from minips_tpu.core.config import TrainConfig
    from minips_tpu.models import wide_deep as jwd_model

    deep0 = jwd_model.init_deep(jax.random.PRNGKey(TrainConfig().seed + 2),
                                26, 8, 13)
    path = tmp_path / "deep0.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in deep0.items()})
    flags = ["--consistency", "bsp", "--num_slots", "16384", "--num_iters",
             "3", "--batch_size", "256", "--updater", "sgd", "--lr", "0.5"]
    res = _matches_jax("wide_deep_example", flags, last_tol=1e-4,
                       sum_tol=1e-2,
                       port_argv=[sys.executable, WD_RANK, str(path),
                                  "--exec", "multiproc"])
    for r in res:
        assert r["event"] == "done" and r["frames_dropped"] == 0, r


@pytest.mark.parametrize("flags", [
    ["--model", "dense", "--mode", "bsp", "--dim", "96"],
    ["--model", "sparse", "--mode", "ssp", "--staleness", "2"]],
    ids=["dense_bsp", "sparse_ssp"])
def test_sharded_ps_example_matches_the_jax_job(flags):
    """Logistic regression from zero weights, so the first loss is log 2
    in both packages; under the tax the owners apply the same pushes in
    the same order, so the third step's loss (within 1e-6) and the
    parameter sum after finalize (within 1e-5) are held too: float32
    throughout. The app's sgd, unlike adam, sees a push's scale."""
    res = _matches_jax("sharded_ps_example", flags + ["--iters", "3"],
                       last_tol=1e-6, sum_tol=1e-5)
    for r in res:
        assert r["event"] == "done" and r["frames_dropped"] == 0, r


def test_mf_asp_matches_the_jax_job_and_holds_the_contracts():
    _matches_jax("mf_example", ["--consistency", "asp", "--num_iters", "3",
                                 "--batch_size", "256"])
    res = _job("mf_example", 3, ["--consistency", "asp", "--num_iters",
                                 "80", "--batch_size", "256"])
    for r in res:
        assert r["event"] == "done"
        assert r["frames_dropped"] == 0, r
        assert r["gate_waits"] == 0  # ASP never blocks
        assert r["loss_last"] < r["loss_first"], r
        assert r["rmse"] is not None and r["rmse"] < 1.5, r["rmse"]
        assert r["local_bytes"] * 3 <= r["table_bytes"] * 1.01 + 6 * 9 * 4
    _agree(res)


def test_word2vec_ssp_matches_the_jax_job_and_holds_the_contracts():
    _matches_jax("word2vec_example", ["--consistency", "ssp",
                                       "--staleness", "2", "--num_iters",
                                       "3", "--batch_size", "128"])
    res = _job("word2vec_example", 3, [
        "--consistency", "ssp", "--staleness", "2", "--num_iters", "50",
        "--batch_size", "128", "--slow-rank", "1", "--slow-ms", "25"])
    for r in res:
        assert r["event"] == "done"
        assert r["frames_dropped"] == 0, r
        assert r["loss_last"] < r["loss_first"], r
        assert r["max_skew_seen"] <= 3  # s + 1
        assert r["local_bytes"] * 3 <= r["table_bytes"] * 1.01 + 6 * 64 * 4
    assert any(r["gate_waits"] > 0 for r in res), res
    _agree(res)


@pytest.mark.parametrize("app", ["mf_example", "word2vec_example",
                                 "wide_deep_example"])
def test_multiproc_without_the_launcher_exits_2(app, capsys):
    """Outside a launched job (no peers) the bootstrap prints the
    protocol's error line and exits 2, as the JAX package's does."""
    import argparse
    import importlib

    from minips_tpu_torch.core.config import Config
    from minips_tpu_torch.utils.metrics import MetricsLogger

    mod = importlib.import_module(f"minips_tpu_torch.apps.{app}")
    cfg = Config(table=mod.DEFAULT.table, train=mod.DEFAULT.train)
    threads = torch.get_num_threads()  # the CPU rank sets its share
    try:
        with pytest.raises(SystemExit) as e:
            mod.run(cfg, argparse.Namespace(exec_mode="multiproc",
                                            device="cpu"),
                    MetricsLogger(None, verbose=False))
    finally:
        torch.set_num_threads(threads)
    assert e.value.code == 2
    assert "needs the launcher" in capsys.readouterr().out
