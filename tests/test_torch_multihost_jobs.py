"""``apps/multihost_example.py``'s Wide&Deep and LM paths of the port
against the JAX package's, as launched 2-process jobs on the CPU.

``--model wd --mode bsp`` (CollectiveSSPPS: the row-sparse union merge of
the hashed tables, the dense merge of the deep tower) and ``--model lm
--mode bsp`` (CollectiveSSP over the transformer) run on 2 port
processes (a gloo group) and on 2 JAX processes (one device each,
``MINIPS_MH_LOCAL_DEVICES=1``) under the same flags. The port's ranks
start from the JAX package's initial state (``tests/torch_cssp_rank.py``
carries it in; torch cannot replay ``jax.random``) and both packages
compute the deep tower and the LM's loss in float32
(``MINIPS_TEST_F32``): each rank's losses agree within ``LOSS_TOL`` and
the final fingerprints within ``FP_RTOL``; within each package the two
replicas' fingerprints are equal.
"""

from __future__ import annotations

import os
import pickle
import sys

import jax
import numpy as np

from minips_tpu import launch as jlaunch
from minips_tpu_torch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"MINIPS_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT,
       "MINIPS_TEST_F32": "1"}
LOSS_TOL = 1e-5
FP_RTOL = 1e-6


def _jobs(init: dict, flags: list, tmp_path) -> tuple[list, list]:
    path = str(tmp_path / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(init, f)
    port = launch.run_local_job(
        2, [sys.executable, os.path.join(ROOT, "tests",
                                         "torch_cssp_rank.py"), path]
        + flags, env_extra=dict(CPU, OMP_NUM_THREADS="1"), timeout=240.0)
    ref = jlaunch.run_local_job(
        2, [sys.executable, os.path.join(ROOT, "tests", "jax_cssp_rank.py")]
        + flags, base_port=None,
        env_extra=dict(CPU, MINIPS_MH_LOCAL_DEVICES="1"), timeout=240.0)
    port = sorted(port, key=lambda r: r["rank"])
    ref = sorted(ref, key=lambda r: r["rank"])
    for p, j in zip(port, ref):
        assert p["event"] == j["event"] == "done"
        assert p["sync_backend"] == "gloo" and p["sync_rounds"] \
            == j["sync_rounds"]
        assert p["max_skew_seen"] <= 1 and j["max_skew_seen"] <= 1
        np.testing.assert_allclose(p["losses"], j["losses"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(p["param_fingerprint"],
                                   j["param_fingerprint"], rtol=FP_RTOL)
    for res in (port, ref):
        assert res[0]["param_fingerprint"] == res[1]["param_fingerprint"]
    return port, ref


def test_wd_bsp_two_processes_match_the_jax_job(tmp_path):
    from minips_tpu.apps.wide_deep_example import build
    from minips_tpu.core.config import Config, TableConfig, TrainConfig
    from minips_tpu.parallel.mesh import make_mesh

    cfg = Config(table=TableConfig(name="ctr", kind="sparse",
                                   updater="adagrad", lr=0.05, dim=8,
                                   num_slots=1 << 14),
                 train=TrainConfig(batch_size=32, num_iters=6))
    _, (wide, emb, deep) = build(cfg, use_fm=True, mesh=make_mesh(1),
                                 seed=0)
    init = {"wd": {
        "wide": {k: np.asarray(v) for k, v in wide.state_dict().items()},
        "emb": {k: np.asarray(v) for k, v in emb.state_dict().items()},
        "deep": (np.asarray(deep.params),
                 [np.asarray(x) for x in jax.tree.leaves(deep.opt_state)])}}
    port, ref = _jobs(init, ["--model", "wd", "--mode", "bsp", "--iters",
                             "6", "--batch", "64"], tmp_path)
    for p, j in zip(port, ref):
        assert p["sync_rows_max"] == j["sync_rows_max"]
        assert p["union_wire_bytes"] == j["union_wire_bytes"]
        assert p["sync_record"][0]["op"] == "all_reduce"
        assert j["sync_hlo_has_all_reduce"]


def test_lm_bsp_two_processes_match_the_jax_job(tmp_path):
    from minips_tpu.models import transformer as jtfm

    T = 16
    params = jtfm.init(jax.random.PRNGKey(0), vocab=64, dim=32, heads=2,
                       depth=2, max_len=T)
    init = {"lm": jax.tree.map(np.asarray, params)}
    _jobs(init, ["--model", "lm", "--mode", "bsp", "--iters", "4",
                 "--batch", "8", "--seq-len", str(T)], tmp_path)
