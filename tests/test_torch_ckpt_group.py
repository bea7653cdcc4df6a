"""Checkpoints under a process group, and the apps' ``--ranks`` CLI.

A 2-rank gloo run of ``lr_example`` (dense) and one of ``lm_example``
(``--layout dp``), each saved halfway, stopped and resumed, give the
uninterrupted 2-rank run's losses from the halfway step on exactly, as
``test_lr_dense_resume_matches_the_uninterrupted_run`` holds one device:
every rank restores the state rank 0 wrote, bit for bit, and the data
stream fast-forwards. Only rank 0 writes: each save leaves one
``step_K`` directory and no ``.tmp`` one.

The CLI: ``--ranks 2 --device cpu`` spawns two gloo ranks through
``run_ranks``, rank 0 writes the metrics, and the losses agree with the
same run in this process on one device within the LR parity tests'
1e-5 (the 2-rank step sums its shards' gradients in another order).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import pytest

import torch_app_ranks as ranks
from minips_tpu_torch.apps import lm_example as tlmx
from minips_tpu_torch.apps import lr_example as tlrx
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.utils.metrics import MetricsLogger

SPAWN_TIMEOUT = 300.0
LR_LOSS_TOL = 1e-5
ITERS = 8


def _train(app, **kw):
    d = app.DEFAULT.train
    return dict(vars(copy.deepcopy(d)), num_iters=ITERS, log_every=0, **kw)


RESUMES = {
    "lr_dense": dict(app="lr", table=vars(copy.deepcopy(tlrx.DEFAULT.table)),
                     train=_train(tlrx),
                     args=dict(exec_mode="spmd", data="dense", dim=123,
                               data_file=None, eval_frac=0.2)),
    "lm_dp": dict(app="lm", table=vars(copy.deepcopy(tlmx.DEFAULT.table)),
                  train=_train(tlmx, batch_size=8),
                  args=dict(layout="dp", seq_len=32, attn="flash")),
}


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    cases = [(name, "resume", dict(spec, dir=str(
        tmp_path_factory.mktemp("ck") / name)))
        for name, spec in RESUMES.items()]
    return run_ranks(ranks.run_cases, 2, cases, device="cpu",
                     timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_resume_under_a_group_matches_the_uninterrupted_run(resumes, name):
    half = ITERS // 2
    for r in range(2):
        got = resumes[r][name]
        whole = got["whole"]["losses"]
        assert len(whole) == ITERS and np.isfinite(whole).all()
        assert got["part"]["losses"] == whole[:half]
        assert got["resumed"]["losses"] == whole[half:]
        if "auc" in got["whole"]:
            assert got["resumed"]["auc"] == got["whole"]["auc"]
    assert resumes[0][name]["resumed"]["losses"] == \
        resumes[1][name]["resumed"]["losses"]


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_one_step_directory_per_save(resumes, name):
    """Rank 0 alone publishes: after the first run one step directory,
    after the resumed run two (the halfway step and the last), none left
    half-written."""
    got = resumes[0][name]
    assert got["after_part"] == ["step_0000000004"]
    assert got["after_resume"] == ["step_0000000004", "step_0000000008"]


def test_lm_example_no_longer_refuses_a_checkpoint_dir_over_ranks(resumes):
    assert resumes[0]["lm_dp"]["resumed"]["start_step"] == ITERS // 2


def test_cli_ranks_runs_an_app_on_spawned_ranks(tmp_path, monkeypatch):
    metrics = tmp_path / "m.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "lr_example", "--device", "cpu", "--ranks", "2", "--num_iters",
        str(ITERS), "--metrics_path", str(metrics), "--eval_frac", "0.2",
        "--log_every", "0"])
    got = tlrx.main()
    assert set(got) >= {"losses", "samples_per_sec", "auc"}
    logged = [json.loads(line) for line in open(metrics)]
    assert logged[-1]["holdout_auc"] == got["auc"]
    cfg = copy.deepcopy(tlrx.DEFAULT)
    cfg.train.num_iters, cfg.train.log_every = ITERS, 0
    one = tlrx.run(cfg, argparse.Namespace(
        device="cpu", exec_mode="spmd", data="dense", dim=123,
        data_file=None, eval_frac=0.2), MetricsLogger(None, verbose=False))
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=0,
                               atol=LR_LOSS_TOL)
    assert abs(got["auc"] - one["auc"]) <= LR_LOSS_TOL
