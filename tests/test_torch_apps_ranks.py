"""The apps over a process group against the JAX apps on ``make_mesh(n)``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``parallel/mesh.py:run_ranks``; the rank bodies are in
``torch_app_ranks.py``, which imports no JAX), and every app's ``run(cfg,
args, metrics, group)`` runs there in turn. Here the JAX app runs with its
module-level ``make_mesh`` (and the JAX Engine's) giving an n-device mesh
of the 8 host devices, so the JAX tables shard n ways as the port's do
and the dense tables pad to n shards on both sides. Both start from the
JAX app's initial weights (built on that mesh and carried across as
numpy; LR starts from zeros in both).

- spmd, every app (Wide&Deep and DeepFM, LR dense and sparse, the MLP,
  MF, word2vec): every rank draws the same global batch and steps on its
  rows of it; the JAX step takes the whole batch over its mesh. The first
  loss agrees to 1e-6 at float32, the rest within each app's tolerance of
  its one-device parity test (``test_torch_wide_deep.py``'s LOSS_TOL
  2e-4 and AUC_TOL 1e-3; ``test_torch_lr_mlp_apps.py``'s 1e-5 for LR and
  the MLP at float32 compute, AUC and accuracy 1e-5;
  ``test_torch_mf_w2v.py``'s 1e-5 for MF and word2vec, RMSE 1e-5).
- threaded, Wide&Deep and LR at one worker against the JAX Engine at one
  worker on ``make_mesh(n)``: rank 0 drives the worker, the other ranks
  serve their shards. Both are deterministic: the same tolerances.
- threaded Wide&Deep at 4 workers under SSP s = 2 on 2 ranks: no pull is
  admitted more than 2 clocks ahead of the slowest worker, and the loss
  falls (as ``test_torch_wide_deep.py`` holds one device).
"""

from __future__ import annotations

import argparse
import copy

import jax
import numpy as np
import pytest

import torch_app_ranks as ranks
from minips_tpu.apps import lr_example as jlrx
from minips_tpu.apps import mf_example as jmfx
from minips_tpu.apps import mlp_example as jmlpx
from minips_tpu.apps import wide_deep_example as jwd
from minips_tpu.apps import word2vec_example as jw2vx
from minips_tpu.core import engine as jengine
from minips_tpu.models import mlp as jmlp
from minips_tpu.parallel import mesh as jmesh
from minips_tpu.utils.metrics import MetricsLogger as JMetrics
from minips_tpu_torch.apps import lr_example as tlrx
from minips_tpu_torch.apps import mf_example as tmfx
from minips_tpu_torch.apps import mlp_example as tmlpx
from minips_tpu_torch.apps import wide_deep_example as twd
from minips_tpu_torch.apps import word2vec_example as tw2vx
from minips_tpu_torch.parallel.mesh import run_ranks

WORLD_SIZES = (2, 4)
SPAWN_TIMEOUT = 600.0
FIRST_TOL = 1e-6
# (loss, holdout metric) tolerances of each app's one-device parity test
WD_TOL, WD_AUC_TOL = 2e-4, 1e-3
F32_TOL = 1e-5

JAPPS = {"wide_deep": jwd, "lr": jlrx, "mlp": jmlpx, "mf": jmfx,
         "word2vec": jw2vx}
TAPPS = {"wide_deep": twd, "lr": tlrx, "mlp": tmlpx, "mf": tmfx,
         "word2vec": tw2vx}


def _wd(mode, model, **train):
    return dict(app="wide_deep", tol=(WD_TOL, WD_AUC_TOL),
                table=dict(name="ctr", kind="sparse", consistency="bsp",
                           staleness=0, updater="adagrad", lr=0.05, dim=8,
                           num_slots=1 << 12),
                train=dict(dict(batch_size=256, num_iters=5, num_workers=1,
                                log_every=0), **train),
                args=dict(exec_mode=mode, model=model, data_file=None,
                          stream=False, eval_frac=0.2, dtype="float32"))


def _default(app, iters, args, **train):
    d = TAPPS[app].DEFAULT
    return dict(app=app, tol=(F32_TOL, F32_TOL),
                table=vars(copy.deepcopy(d.table)),
                train=dict(vars(copy.deepcopy(d.train)), num_iters=iters,
                           log_every=0, num_workers=1, **train),
                args=args)


def _lr(mode, data):
    return _default("lr", 8, dict(exec_mode=mode, data=data, dim=123,
                                  data_file=None, eval_frac=0.2))


CASES = {
    "wd_spmd_widedeep": _wd("spmd", "widedeep"),
    "wd_spmd_deepfm": _wd("spmd", "deepfm"),
    "wd_threaded": _wd("threaded", "widedeep"),
    "lr_spmd_dense": _lr("spmd", "dense"),
    "lr_spmd_sparse": _lr("spmd", "sparse"),
    "lr_threaded": _lr("threaded", "dense"),
    "mlp_spmd": _default("mlp", 8, dict(exec_mode="spmd", images=None,
                                        labels=None)),
    "mf_spmd": _default("mf", 10, dict(exec_mode="spmd", data_file=None,
                                       eval_frac=0.1), batch_size=512),
    "w2v_spmd": _default("word2vec", 10, dict(exec_mode="spmd",
                                              data_file=None, subsample=0.0),
                         batch_size=256),
}
SSP_CASE = dict(_wd("threaded", "widedeep", num_workers=4),
                record_gaps=True)
SSP_CASE["table"] = dict(SSP_CASE["table"], consistency="ssp", staleness=2)
SSP_CASE["train"] = dict(SSP_CASE["train"], num_iters=12)
# a global batch of 255 rows does not split over 2 ranks
REFUSED = {f"refuse_{k}": dict(
    {f: v for f, v in CASES[k].items() if f != "tol"}, raises=True,
    train=dict(CASES[k]["train"], batch_size=255))
    for k in ("wd_spmd_widedeep", "lr_spmd_dense", "lr_spmd_sparse",
              "mlp_spmd", "mf_spmd", "w2v_spmd")}


def _jax_cfg(spec):
    from minips_tpu.core import config as jcfg

    return jcfg.Config(table=jcfg.TableConfig(**spec["table"]),
                       train=jcfg.TrainConfig(**spec["train"]))


def _mesh_patches(mp, n):
    """Every JAX app and the JAX Engine build their tables on an n-device
    mesh of the host's devices."""
    def mesh(*_args, **_kw):
        return jmesh.make_mesh(n)

    for m in list(JAPPS.values()) + [jengine]:
        mp.setattr(m, "make_mesh", mesh)


def _jax_weights(name, spec, n):
    """The JAX app's initial weights on ``make_mesh(n)``, as numpy."""
    jc, app = _jax_cfg(spec), spec["app"]
    if app == "wide_deep":
        _, (w, e, d) = jwd.build(jc, use_fm=spec["args"]["model"] == "deepfm",
                                 seed=jc.train.seed)
        return {"wide": w.state_dict(), "emb": e.state_dict(),
                "deep": (np.asarray(d.params),
                         [np.asarray(x) for x in
                          jax.tree.leaves(d.opt_state)])}
    if app == "mlp":
        return jax.tree.map(np.asarray, jmlp.init(
            jax.random.PRNGKey(jc.train.seed), tmlpx.SIZES))
    if app == "mf":
        data = jmfx.synthetic.movielens_like(seed=jc.train.seed)
        u, i = jmfx._make_tables(jc, jmesh.make_mesh(n),
                                 int(data["user"].max()) + 1,
                                 int(data["item"].max()) + 1)
        return {"user": u.state_dict(), "item": i.state_dict()}
    if app == "word2vec":
        t = jw2vx.SparseTable(jc.table.num_slots, jc.table.dim,
                              jmesh.make_mesh(n), name="in",
                              updater=jc.table.updater, lr=jc.table.lr,
                              init_scale=0.01, seed=1)
        return {"in": t.state_dict()}
    return None


@pytest.fixture(scope="module")
def runs():
    """Every case's results on every rank, by world size: one spawn of n
    ranks per n."""
    out = {}
    for n in WORLD_SIZES:
        cases = []
        with pytest.MonkeyPatch.context() as mp:
            _mesh_patches(mp, n)
            for name, spec in CASES.items():
                spec = dict(spec, weights=_jax_weights(name, spec, n))
                spec.pop("tol")
                cases.append((name, "app", spec))
        if n == 2:
            cases.append(("wd_ssp4", "app", {k: v for k, v in
                                              SSP_CASE.items()
                                              if k != "tol"}))
            cases += [(k, "app", v) for k, v in REFUSED.items()]
        out[n] = run_ranks(ranks.run_cases, n, cases, device="cpu",
                           timeout=SPAWN_TIMEOUT)
    return out


def _f32_mlp(mp):
    """The JAX MLP's ``grad_fn`` at float32 compute, as the ranks'."""
    import functools

    import jax.numpy as jnp

    mp.setattr(jmlp, "grad_fn", lambda params, batch: jax.value_and_grad(
        functools.partial(jmlp.loss, compute_dtype=jnp.float32))(params,
                                                                batch))


def _jax_run(name, spec, n, monkeypatch):
    _mesh_patches(monkeypatch, n)
    if spec["app"] == "mlp":
        _f32_mlp(monkeypatch)
    return JAPPS[spec["app"]].run(_jax_cfg(spec),
                                  argparse.Namespace(**spec["args"]),
                                  JMetrics(None, verbose=False))


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_app_over_a_group_matches_jax(runs, monkeypatch, name, n):
    spec = CASES[name]
    want = _jax_run(name, spec, n, monkeypatch)
    loss_tol, metric_tol = spec["tol"]
    iters = spec["train"]["num_iters"]
    for r in range(n):
        got = runs[n][r][name]
        assert len(got["losses"]) == len(want["losses"]) == iters
        assert abs(got["losses"][0] - want["losses"][0]) <= FIRST_TOL
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=loss_tol)
        for metric in ("auc", "rmse", "accuracy"):
            if metric in want:
                assert abs(got[metric] - want[metric]) <= metric_tol, metric
        assert got["losses"][-1] < got["losses"][0]
    assert runs[n][0][name]["samples_per_sec"] > 0


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ranks_hand_back_the_same_results(runs, n):
    """Every rank returns the same losses and holdout metrics: the spmd
    losses are means over the ranks, the threaded results rank 0's."""
    for name in CASES:
        first = runs[n][0][name]
        for r in range(1, n):
            for k in ("losses", "auc", "rmse", "accuracy"):
                assert runs[n][r][name].get(k) == first.get(k), (name, k)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ranks_import_no_jax(runs, n):
    assert all(runs[n][r]["_jax"] == [] for r in range(n))


def test_threaded_ssp_four_workers_over_two_ranks_bounds_the_clock_gap(runs):
    """Rank 0 drives 4 workers under SSP s = 2 while rank 1 serves: no
    pull is admitted more than 2 clocks ahead of the slowest worker, and
    the loss falls."""
    out = runs[2][0]["wd_ssp4"]
    losses, gaps = out["losses"], out["gaps"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # three tables, four workers, twelve steps: every pull was recorded,
    # on rank 0, where the gate lives
    assert len(gaps) == 3 * 4 * 12
    assert 0 <= min(gaps) and max(gaps) <= 2
    assert runs[2][1]["wd_ssp4"]["gaps"] == []
    assert out["auc"] > 0.6


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_spmd_batch_must_divide_by_the_group(runs, name):
    """A global batch that does not split evenly over the ranks is
    refused on every rank, before the first step."""
    for r in range(2):
        assert "must divide by the 2-way group" in runs[2][r][name]["raised"]
