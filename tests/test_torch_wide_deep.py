"""The Wide&Deep / DeepFM app (``apps/wide_deep_example.py``) against the
JAX package's, from the JAX ``build``'s weights carried across.

Small: tables of 2^12 slots at dim 8, batch 256, 5 iterations, the app's
own ``criteo_like(16384)`` data with a 0.2 holdout. Both packages run the
same batches in float32 and agree on the first loss to 1e-6. After that
the deep tower's Adam moves each weight by about lr = 1e-3 whatever the
size of its gradient, so a gradient near zero whose sign the two
frameworks' summation orders flip moves that weight by up to 2 lr a step
(the JAX package's own spmd and threaded runs differ by 2e-5 this way).
Hence LOSS_TOL = 2e-4 on every loss and AUC_TOL = 1e-3 on the holdout AUC.
With both towers at float32 (the Criteo-file test) the losses agree within
F32_LOSS_TOL = 1e-5.
"""

from __future__ import annotations

import argparse

import jax
import numpy as np
import pytest

from minips_tpu.apps import wide_deep_example as jwd
from minips_tpu.utils.metrics import MetricsLogger as JMetrics
from minips_tpu_torch import interop
from minips_tpu_torch.apps import common as tcommon
from minips_tpu_torch.apps import wide_deep_example as twd
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.utils.metrics import MetricsLogger

LOSS_TOL = 2e-4
AUC_TOL = 1e-3
F32_LOSS_TOL = 1e-5


def _cfgs(consistency="bsp", staleness=0, workers=1, iters=5):
    from minips_tpu.core import config as jcfg

    out = []
    for m in (jcfg, tcfg):
        out.append(m.Config(
            table=m.TableConfig(name="ctr", kind="sparse",
                                consistency=consistency, staleness=staleness,
                                updater="adagrad", lr=0.05, dim=8,
                                num_slots=1 << 12),
            train=m.TrainConfig(batch_size=256, num_iters=iters,
                                num_workers=workers, log_every=0)))
    return out


def _args(mode, model, **kw):
    return argparse.Namespace(exec_mode=mode, model=model, data_file=None,
                              stream=False, eval_frac=0.2, dtype="float32",
                              device="cpu", **kw)


def _load_jax_weights(monkeypatch, jcfg_, use_fm):
    """Make the port's ``build`` start from the JAX ``build``'s weights
    (the same seeds as the JAX app's run). The JAX dense table pads to its
    8-device mesh; the port's to 1: the rows past the params are zeros."""
    _, (jw, je, jd) = jwd.build(jcfg_, use_fm=use_fm, seed=jcfg_.train.seed)
    orig = twd.build

    def build(cfg, **kw):
        ps, (w, e, d) = orig(cfg, **kw)
        interop.load_sparse(w, jw.state_dict())
        interop.load_sparse(e, je.state_dict())
        n = d.num_keys
        leaves = [np.asarray(x)[:d.padded] if np.ndim(x) == 1 else
                  np.asarray(x) for x in jax.tree.leaves(jd.opt_state)]
        interop.load_dense(d, np.asarray(jd.params)[:n], leaves)
        return ps, (w, e, d)

    monkeypatch.setattr(twd, "build", build)


@pytest.mark.parametrize("mode", ["spmd", "threaded"])
@pytest.mark.parametrize("model", ["widedeep", "deepfm"])
def test_app_matches_jax_from_the_same_weights(monkeypatch, mode, model):
    jc, tc = _cfgs()
    _load_jax_weights(monkeypatch, jc, model == "deepfm")
    want = jwd.run(jc, _args(mode, model), JMetrics(None, verbose=False))
    got = twd.run(tc, _args(mode, model), MetricsLogger(None, verbose=False))
    assert len(got["losses"]) == len(want["losses"]) == 5
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert abs(got["auc"] - want["auc"]) <= AUC_TOL
    assert got["samples_per_sec"] > 0


def test_threaded_ssp_four_workers_bounds_the_clock_gap(monkeypatch):
    """4 workers under SSP s = 2: no pull is admitted more than 2 clocks
    ahead of the slowest worker, and the loss falls."""
    from minips_tpu_torch import consistency

    gaps = []

    class Recording(consistency.SSP):
        def wait_until_admitted(self, worker, timeout=None):
            ok = super().wait_until_admitted(worker, timeout)
            with self._cond:
                gaps.append(self.tracker.clock_of(worker)
                            - self.tracker.min_clock)
            return ok

    monkeypatch.setattr(consistency, "make_controller",
                        lambda kind, n, staleness, sync_every:
                        Recording(n, staleness=staleness))
    _, tc = _cfgs("ssp", 2, workers=4, iters=12)
    out = twd.run(tc, _args("threaded", "widedeep"),
                  MetricsLogger(None, verbose=False))
    losses = out["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # three tables, four workers, twelve steps: every pull was recorded
    assert len(gaps) == 3 * 4 * 12
    assert 0 <= min(gaps) and max(gaps) <= 2
    assert out["auc"] > 0.6


@pytest.mark.parametrize("kw,match", [
    # the readers are ported: --stream needs a file, resident rows for a
    # holdout, and the spmd path
    ({"stream": True}, "needs --data_file"),
    ({"data_file": "criteo.tsv", "stream": True}, "--eval_frac"),
    ({"exec_mode": "threaded", "data_file": "criteo.tsv", "stream": True},
     "only wired into --exec spmd"),
    ({"exec_mode": "threaded", "dtype": "bfloat16"}, "--dtype"),
])
def test_unported_modes_raise(kw, match):
    _, tc = _cfgs()
    args = vars(_args("spmd", "widedeep"))
    args.update(kw)
    with pytest.raises(SystemExit, match=match):
        twd.run(tc, argparse.Namespace(**args),
                MetricsLogger(None, verbose=False))


def test_spmd_bf16_trains():
    _, tc = _cfgs(iters=8)
    args = _args("spmd", "deepfm")
    args.dtype = "bfloat16"
    out = twd.run(tc, args, MetricsLogger(None, verbose=False))
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("starts, sizes, end, want", [
    # one worker: steps 3 and 4 over the time since step 2 began, as the
    # spmd path's StepTimer counts them
    ([[0.0, 1.0, 2.0, 3.0]], [10], 4.0, 20 / 2.0),
    # the clock starts when the slowest worker ends its warm-up (2.5); a
    # step counts if it began since
    ([[0.0, 1.0, 2.0, 3.0, 4.0], [0.0, 1.5, 2.5, 3.5]], [10, 8], 5.0,
     (2 * 10 + 2 * 8) / 2.5),
    # a worker that never got past its warm-up: no rate
    ([[0.0, 1.0, 2.0], [0.0, 1.0]], [10, 10], 3.0, 0.0),
])
def test_threaded_rate_leaves_out_the_warm_up(starts, sizes, end, want):
    assert tcommon.steady_rate(starts, sizes, end) == pytest.approx(want)


@pytest.mark.parametrize("stream", [False, True])
def test_data_file_matches_jax(monkeypatch, tmp_path, stream):
    """``--data_file`` (resident, with a holdout) and ``--stream`` (a
    producer thread parsing the file in chunks) through both packages'
    readers, from the same weights. The log-transformed Criteo counts
    reach the tower at up to ~5, where the bf16 roundings of the two
    frameworks differ more than on the synthetic rows: both towers compute
    in float32 here, and every loss agrees within F32_LOSS_TOL."""
    import functools

    import jax.numpy as jnp
    import torch

    from minips_tpu.data.criteo import write_criteo
    from minips_tpu.models import mlp as jmlp
    from minips_tpu_torch.models import mlp as tmlp

    monkeypatch.setattr(jmlp, "apply", functools.partial(
        jmlp.apply, compute_dtype=jnp.float32))
    monkeypatch.setattr(tmlp, "apply", functools.partial(
        tmlp.apply, compute_dtype=torch.float32))

    d = jwd.synthetic.criteo_like(2048, seed=5)
    path = str(tmp_path / "day_0.tsv")
    write_criteo(path, d["y"], np.abs(d["dense"] * 10).astype(np.int64),
                 d["cat"])
    jc, tc = _cfgs()
    _load_jax_weights(monkeypatch, jc, False)
    args = _args("spmd", "widedeep")
    args.data_file, args.stream = path, stream
    args.eval_frac = None if stream else 0.2
    jargs = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                  if k != "device"})
    want = jwd.run(jc, jargs, JMetrics(None, verbose=False))
    got = twd.run(tc, args, MetricsLogger(None, verbose=False))
    assert len(got["losses"]) == len(want["losses"]) == 5
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=F32_LOSS_TOL)
    if not stream:
        assert abs(got["auc"] - want["auc"]) <= AUC_TOL
