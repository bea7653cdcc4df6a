"""The port's LR and MLP apps (``lr_example``, ``mlp_example``) against
the JAX package's, at the apps' own data with few steps.

LR (dense, sparse, threaded) starts from zero weights in both packages and
runs float32 Adagrad: the first loss agrees to 1e-6 and every loss within
LR_LOSS_TOL = 1e-5 (summation order only), the holdout AUC within 1e-5.

The MLP starts from the JAX ``init``'s weights carried across. At float32
compute (both packages' ``grad_fn`` swapped for one at float32) the same
rule holds: every loss within 1e-5, the accuracy on the first 2048 rows
within 1e-5. At the app's own bf16 compute each framework rounds every
product and bias add to 8 bits of mantissa, in places XLA and PyTorch
choose differently, and Adagrad at lr 0.05 amplifies a difference from
step to step (the loss jumps between 1.7 and 2.7 in these first steps):
the first MLP_BF16_STEPS = 3 losses agree within MLP_BF16_TOL = 1e-2, a
few bf16 steps of an O(1) mean cross-entropy.

A resumed LR dense run (checkpoint every 4 of 8 steps, stopped at 4,
started again) gives the uninterrupted run's losses from step 4 on,
exactly: the restored state is bit for bit, the data stream fast-forwards,
and the CPU repeats its arithmetic.
"""

from __future__ import annotations

import argparse
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.apps import lr_example as jlrx
from minips_tpu.apps import mlp_example as jmlpx
from minips_tpu.models import mlp as jmlp
from minips_tpu.utils.metrics import MetricsLogger as JMetrics
from minips_tpu_torch import interop
from minips_tpu_torch.apps import lr_example as tlrx
from minips_tpu_torch.apps import mlp_example as tmlpx
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.models import mlp as tmlp
from minips_tpu_torch.utils.metrics import MetricsLogger
from minips_tpu_torch.utils.tree import value_and_grad

LR_LOSS_TOL = 1e-5
AUC_TOL = 1e-5
F32_TOL = 1e-5
MLP_BF16_STEPS = 3
MLP_BF16_TOL = 1e-2
ITERS = 8


def _cfgs(app_default, iters=ITERS, **train):
    from minips_tpu.core import config as jcfg

    out = []
    for m in (jcfg, tcfg):
        t = dict(vars(copy.deepcopy(app_default.train)), num_iters=iters,
                 log_every=0, num_workers=1)
        t.update(train)
        out.append(m.Config(
            table=m.TableConfig(**vars(copy.deepcopy(app_default.table))),
            train=m.TrainConfig(**t)))
    return out


def _runs(japp, tapp, jc, tc, **args):
    want = japp.run(jc, argparse.Namespace(**args),
                    JMetrics(None, verbose=False))
    got = tapp.run(tc, argparse.Namespace(device="cpu", **args),
                   MetricsLogger(None, verbose=False))
    return got, want


def _lr_args(mode, data, **kw):
    return dict(dict(exec_mode=mode, data=data, dim=123, data_file=None,
                     eval_frac=0.2), **kw)


@pytest.mark.parametrize("mode, data", [("spmd", "dense"),
                                        ("threaded", "dense"),
                                        ("spmd", "sparse")])
def test_lr_app_matches_jax(mode, data):
    jc, tc = _cfgs(jlrx.DEFAULT)
    got, want = _runs(jlrx, tlrx, jc, tc, **_lr_args(mode, data))
    assert len(got["losses"]) == len(want["losses"]) == ITERS
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LR_LOSS_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert abs(got["auc"] - want["auc"]) <= AUC_TOL
    assert got["samples_per_sec"] > 0
    if data == "sparse":
        assert got["table"].num_slots == 1 << 16 and got["table"].dim == 1


@pytest.mark.parametrize("data", ["dense", "sparse"])
def test_lr_app_reads_a_libsvm_file_as_jax_does(tmp_path, data):
    """``--data_file``: a 1-based libsvm file written by the JAX writer,
    read and trained on by both packages."""
    from minips_tpu.data.libsvm import write_libsvm
    from minips_tpu_torch.data import synthetic

    d = synthetic.classification_sparse(600, dim=120, seed=3)
    path = str(tmp_path / "a9a.libsvm")
    write_libsvm(path, 2 * d["y"] - 1, d["idx"] + 1, d["val"], d["mask"])
    jc, tc = _cfgs(jlrx.DEFAULT, batch_size=128)
    got, want = _runs(jlrx, tlrx, jc, tc,
                      **_lr_args("spmd", data, data_file=path))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LR_LOSS_TOL)
    assert abs(got["auc"] - want["auc"]) <= AUC_TOL


def test_lr_dense_resume_matches_the_uninterrupted_run(tmp_path):
    _, tc = _cfgs(jlrx.DEFAULT)
    args = argparse.Namespace(device="cpu", **_lr_args("spmd", "dense"))
    whole = tlrx.run(tc, args, MetricsLogger(None, verbose=False))
    ck = copy.deepcopy(tc)
    ck.train.checkpoint_dir = str(tmp_path / "ck")
    ck.train.checkpoint_every = ITERS // 2
    first = copy.deepcopy(ck)
    first.train.num_iters = ITERS // 2
    part = tlrx.run(first, args, MetricsLogger(None, verbose=False))
    assert part["losses"] == whole["losses"][:ITERS // 2]
    resumed = tlrx.run(ck, args, MetricsLogger(None, verbose=False))
    assert resumed["losses"] == whole["losses"][ITERS // 2:]
    assert resumed["auc"] == whole["auc"]
    # the resumed run saved the last step
    from minips_tpu_torch.ckpt import make_checkpointer
    assert make_checkpointer(ck.train.checkpoint_dir, {}).list_steps() == [
        ITERS // 2, ITERS]


def _jax_mlp_init(monkeypatch, seed):
    """The port's ``mlp.init`` gives the JAX ``init``'s weights (the same
    seed as the JAX app's ``PRNGKey(seed)``)."""
    params = jax.tree.map(np.asarray,
                          jmlp.init(jax.random.PRNGKey(seed), tmlpx.SIZES))
    monkeypatch.setattr(tmlpx.mlp_model, "init",
                        lambda gen, sizes, device=None:
                        interop.tree_from_numpy(params, device))


def _f32_grad_fns(monkeypatch):
    """Both packages' MLP ``grad_fn`` at float32 compute. New function
    objects, so no JAX trace of the bf16 one is reused."""
    def jgrad(params, batch):
        return jax.value_and_grad(functools.partial(
            jmlp.loss, compute_dtype=jnp.float32))(params, batch)

    def tgrad(params, batch):
        return value_and_grad(lambda p: tmlp.loss(
            p, batch, compute_dtype=torch.float32), params)

    monkeypatch.setattr(jmlp, "grad_fn", jgrad)
    monkeypatch.setattr(tmlp, "grad_fn", tgrad)


@pytest.mark.parametrize("mode", ["spmd", "threaded"])
def test_mlp_app_matches_jax_from_the_same_weights(monkeypatch, mode):
    jc, tc = _cfgs(jmlpx.DEFAULT)
    _jax_mlp_init(monkeypatch, tc.train.seed)
    _f32_grad_fns(monkeypatch)
    got, want = _runs(jmlpx, tmlpx, jc, tc, exec_mode=mode, images=None,
                      labels=None)
    assert len(got["losses"]) == len(want["losses"]) == ITERS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=F32_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert abs(got["accuracy"] - want["accuracy"]) <= F32_TOL
    assert got["samples_per_sec"] > 0


@pytest.mark.parametrize("mode", ["spmd", "threaded"])
def test_mlp_app_bf16_first_steps_match_jax(monkeypatch, mode):
    jc, tc = _cfgs(jmlpx.DEFAULT, iters=MLP_BF16_STEPS)
    _jax_mlp_init(monkeypatch, tc.train.seed)
    got, want = _runs(jmlpx, tmlpx, jc, tc, exec_mode=mode, images=None,
                      labels=None)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=MLP_BF16_TOL)
    assert np.isfinite(got["losses"]).all()


def test_mlp_app_reads_mnist_files_as_jax_does(monkeypatch, tmp_path):
    from minips_tpu.data.mnist import write_idx

    rng = np.random.default_rng(5)
    images = str(tmp_path / "images-idx3-ubyte.gz")
    labels = str(tmp_path / "labels-idx1-ubyte")
    write_idx(images, rng.integers(0, 256, (512, 28, 28)).astype(np.uint8))
    write_idx(labels, rng.integers(0, 10, 512).astype(np.uint8))
    jc, tc = _cfgs(jmlpx.DEFAULT, iters=4)
    _jax_mlp_init(monkeypatch, tc.train.seed)
    _f32_grad_fns(monkeypatch)
    got, want = _runs(jmlpx, tmlpx, jc, tc, exec_mode="spmd", images=images,
                      labels=labels)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=F32_TOL)
    assert abs(got["accuracy"] - want["accuracy"]) <= F32_TOL
    for kw, match in (({"images": images, "labels": None}, "--labels is"),
                      ({"images": None, "labels": labels}, "pass both")):
        with pytest.raises(SystemExit, match=match):
            tmlpx.run(tc, argparse.Namespace(device="cpu", exec_mode="spmd",
                                             **kw),
                      MetricsLogger(None, verbose=False))
