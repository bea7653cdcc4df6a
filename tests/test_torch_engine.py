"""The port's threaded Engine path and the modules it stands on, against the
JAX package where both decide the same thing.

- ``tests/test_engine.py``'s seven cases, run against the port.
- Consistency: the port's and the JAX package's controllers on the same
  scripted clock sequences give the same admit/block decisions, the same
  changed min clocks, skews and sync hints (exact: integer bookkeeping).
- A pull is a snapshot: later pushes never change what it returned.
- The copied modules (config, the log2 histogram, the step timer) and the
  ported loop give the JAX package's results exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading

import numpy as np
import pytest
import torch

from minips_tpu.consistency import controllers as jctl
from minips_tpu_torch.consistency import controllers as tctl
from minips_tpu_torch.core.config import (Config, TableConfig, TrainConfig,
                                          add_config_flags, config_from_args)
from minips_tpu_torch.core.engine import Engine, MLTask


def make_engine(n=4, **table_kw):
    e = Engine(num_workers=n, device="cpu").start_everything()
    cfg = TableConfig(name="t", kind="dense", lr=0.5, **table_kw)
    e.create_table(cfg, template={"w": torch.zeros(8)})
    return e


# ------------------------------------------- tests/test_engine.py's seven
def test_default_task_uses_engine_workers():
    e = make_engine(3)
    seen = []
    e.run(MLTask(fn=lambda info: seen.append(info.worker_id)))
    assert sorted(seen) == [0, 1, 2]
    e.stop_everything()


def test_udf_error_surfaces_root_cause():
    e = make_engine(2, consistency="bsp")

    def udf(info):
        tbl = info.table("t")
        if info.worker_id == 1:
            raise RuntimeError("worker 1 exploded")
        tbl.pull()
        tbl.push({"w": torch.ones(8)})
        tbl.clock()
        tbl.pull(timeout=30.0)  # parked; unblocked by the stop cascade

    with pytest.raises(RuntimeError, match="worker 1 exploded"):
        e.run(MLTask(fn=udf))
    e.stop_everything()


def test_engine_reusable_after_failed_run():
    e = make_engine(2, consistency="bsp")
    with pytest.raises(RuntimeError):
        e.run(MLTask(fn=lambda info: (_ for _ in ()).throw(
            RuntimeError("boom"))))
    done = []
    e.run(MLTask(fn=lambda info: done.append(info.worker_id)))
    assert sorted(done) == [0, 1]
    e.stop_everything()


def test_threaded_lr_converges_bsp():
    rng = np.random.default_rng(0)
    true_w = rng.normal(size=8).astype(np.float32)
    X = rng.normal(size=(512, 8)).astype(np.float32)
    y = (X @ true_w > 0).astype(np.float32)
    e = make_engine(4, consistency="bsp", updater="adagrad")
    losses = {w: [] for w in range(4)}

    def udf(info):
        tbl = info.table("t")
        shard = np.array_split(np.arange(len(X)), 4)[info.worker_id]
        xb, yb = torch.from_numpy(X[shard]), torch.from_numpy(y[shard])
        for _ in range(15):
            w = tbl.pull()["w"].detach().requires_grad_()
            logits = xb @ w
            loss = torch.mean(torch.logaddexp(torch.zeros_like(logits),
                                              logits) - yb * logits)
            (g,) = torch.autograd.grad(loss, [w])
            tbl.push({"w": g / info.num_workers})
            tbl.clock()
            losses[info.worker_id].append(float(loss.detach()))

    e.run(MLTask(fn=udf))
    e.stop_everything()
    for w in range(4):
        assert losses[w][-1] < losses[w][0] * 0.9


def test_sparse_table_via_engine():
    e = Engine(num_workers=2, device="cpu").start_everything()
    e.create_table(TableConfig(name="emb", kind="sparse", num_slots=64,
                               dim=4, lr=1.0, consistency="asp",
                               init_scale=0.0))

    def udf(info):
        tbl = info.table("emb")
        keys = np.array([3, 9]) if info.worker_id == 0 else np.array([9, 17])
        tbl.push(torch.ones((2, 4)), keys=keys)
        tbl.clock()

    e.run(MLTask(fn=udf))
    tbl = e.tables["emb"]
    rows = tbl.pull(np.array([3, 9, 17])).numpy()
    e.stop_everything()
    # SGD pushes add and ASP orders nothing: key 9 was pushed by both
    # workers, keys 3 and 17 once each, and the three keys take three slots
    slots = tbl.slots_of(np.array([3, 9, 17])).numpy()
    assert len(set(slots.tolist())) == 3
    np.testing.assert_allclose(rows[1], 2 * rows[0], rtol=1e-6)
    np.testing.assert_allclose(rows[0], rows[2], rtol=1e-6)


def test_mltask_chained_setters():
    eng = make_engine(2, consistency="bsp")
    seen = []
    task = MLTask().set_lambda(
        lambda info: seen.append(info.worker_id)).set_worker_alloc(2)
    eng.run(task)
    eng.stop_everything()
    assert sorted(seen) == [0, 1]


def test_config_json_roundtrip(tmp_path):
    cfg = Config(table=TableConfig(name="x", kind="sparse", staleness=3,
                                   updater="adagrad", lr=0.25, dim=7),
                 train=TrainConfig(batch_size=96, num_iters=5),
                 app={"extra": 1})
    assert Config.from_json(cfg.to_json()) == cfg
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    args = parser.parse_args(["--config_file", str(path)])
    assert config_from_args(args) == cfg
    # the same JSON as the JAX package's, and it reads the port's back
    from minips_tpu.core import config as jcfg

    jc = jcfg.Config(table=jcfg.TableConfig(**dataclasses.asdict(cfg.table)),
                     train=jcfg.TrainConfig(**dataclasses.asdict(cfg.train)),
                     app={"extra": 1})
    assert jc.to_json() == cfg.to_json()
    assert dataclasses.asdict(jcfg.Config.from_json(cfg.to_json())) == \
        dataclasses.asdict(cfg)


# ----------------------------------------------------------- port-specific
def test_pull_is_a_snapshot_under_later_pushes():
    """A pulled dense tree and pulled sparse rows keep their values after
    pushes from another worker thread (the port returns device tensors,
    not host copies)."""
    e = Engine(num_workers=2, device="cpu").start_everything()
    e.create_table(TableConfig(name="d", kind="dense", lr=0.5,
                               consistency="asp"),
                   template={"w": torch.arange(8.0)})
    e.create_table(TableConfig(name="s", kind="sparse", num_slots=64, dim=4,
                               lr=1.0, consistency="asp", init_scale=0.1,
                               updater="adagrad"))
    keys = np.array([[3, 9], [9, 17]])
    pulled, ready, pushed = {}, threading.Event(), threading.Event()

    def udf(info):
        d, s = info.table("d"), info.table("s")
        if info.worker_id == 0:
            pulled["d"], pulled["s"] = d.pull(), s.pull(keys)
            pulled["d0"] = pulled["d"]["w"].clone()
            pulled["s0"] = pulled["s"].clone()
            ready.set()
            assert pushed.wait(30)
        else:
            assert ready.wait(30)
            for _ in range(3):
                d.push({"w": torch.ones(8)})
                s.push(torch.ones((2, 2, 4)), keys=keys)
            pushed.set()

    e.run(MLTask(fn=udf))
    assert torch.equal(pulled["d"]["w"], pulled["d0"])
    assert torch.equal(pulled["s"], pulled["s0"])
    # and the tables did move
    assert not torch.equal(e.tables["d"].pull()["w"], pulled["d0"])
    assert not torch.equal(e.tables["s"].pull(keys), pulled["s0"])
    e.stop_everything()


def test_engine_defaults_and_unported_features(tmp_path):
    e = Engine(device="cpu").start_everything()
    assert e.num_workers == 1
    assert e.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown table kind"):
        e.create_table(TableConfig(kind="ragged"))
    # both checkpoint backends; the barrier of one process returns
    assert e.make_checkpointer(str(tmp_path)).list_steps() == []
    assert e.make_checkpointer(str(tmp_path / "dcp"),
                               backend="orbax").list_steps() == []
    e.barrier()
    with pytest.raises(RuntimeError, match="start_everything"):
        Engine(device="cpu").register_table("x", None, None)


# ------------------------------------------------------------- consistency
def _script(rng, n, length):
    """A random clock sequence: (worker, op) with op "clock" or "look"."""
    return [(int(rng.integers(n)), "clock" if rng.random() < 0.6 else "look")
            for _ in range(length)]


@pytest.mark.parametrize("kind,staleness", [("bsp", 0), ("ssp", 0),
                                            ("ssp", 1), ("ssp", 2),
                                            ("ssp", 3), ("asp", 0)])
def test_controllers_decide_as_the_jax_package(kind, staleness):
    rng = np.random.default_rng(staleness + 10 * (kind == "asp"))
    n = 4
    j = jctl.make_controller(kind, n, staleness=staleness, sync_every=3)
    t = tctl.make_controller(kind, n, staleness=staleness, sync_every=3)
    assert type(t).__name__ == type(j).__name__ and t.kind == j.kind
    blocked = 0
    for worker, op in _script(rng, n, 400):
        if op == "clock":
            assert t.clock(worker) == j.clock(worker)
        got = [(t.admit(w), t.should_sync(w)) for w in range(n)]
        assert got == [(j.admit(w), j.should_sync(w)) for w in range(n)]
        blocked += sum(not a for a, _ in got)
        assert (t.min_clock, t.skew) == (j.min_clock, j.skew)
    assert t.state_dict() == j.state_dict()
    # a blocked worker times out alike; stop releases it with False
    w = max(range(n), key=t.tracker.clock_of)
    assert t.wait_until_admitted(w, 0.01) == j.wait_until_admitted(w, 0.01)
    t.stop()
    assert t.wait_until_admitted(w, 5.0) is False
    t.reset_stop()
    if kind != "asp":
        assert blocked > 0   # the script did reach the bound


def test_blocked_pull_wakes_on_clock():
    c = tctl.BSP(2)
    c.clock(0)
    woke = []
    th = threading.Thread(target=lambda: woke.append(
        c.wait_until_admitted(0, 10.0)))
    th.start()
    c.clock(1)
    th.join(10.0)
    assert not th.is_alive() and woke == [True]


# ---------------------------------------------------------- copied modules
def test_log2_histogram_and_step_timer_are_copies():
    from minips_tpu.obs import hist as jhist
    from minips_tpu_torch.obs import hist as thist
    from minips_tpu_torch.utils.timing import CommTimers, StepTimer

    rng = np.random.default_rng(0)
    us = rng.lognormal(4, 2, 500)
    jh, th = jhist.Log2Histogram(), thist.Log2Histogram()
    for x in us:
        jh.record_us(x)
        th.record_us(x)
    assert th.snapshot() == jh.snapshot()
    assert th.summary() == jh.summary()
    assert thist.slo_check(th.snapshot(), 1.0) == \
        jhist.slo_check(jh.snapshot(), 1.0)
    ct = CommTimers()
    ct.record_pull(0.002, 0.001)
    assert ct.summary()["pull_overlap_fraction"] == 0.5
    st = StepTimer(warmup_steps=0)
    st.step(10)
    assert st.samples_per_sec >= 0.0


def test_train_loop_matches_the_jax_loop(tmp_path):
    from minips_tpu.data.loader import BatchIterator as JBatches
    from minips_tpu.train.loop import TrainLoop as JLoop
    from minips_tpu_torch.data.loader import BatchIterator as TBatches
    from minips_tpu_torch.train.loop import TrainLoop as TLoop
    from minips_tpu_torch.utils.metrics import MetricsLogger

    data = {"x": np.arange(40, dtype=np.float32).reshape(20, 2)}
    step = lambda b: float(np.asarray(b["x"]).sum())  # noqa: E731
    got = TLoop(step, TBatches(data, 4, seed=1), step_offset=7,
                metrics=MetricsLogger(verbose=False)).run(6)
    want = JLoop(step, JBatches(data, 4, seed=1), step_offset=7,
                 metrics=MetricsLogger(verbose=False)).run(6)
    assert got == want
    loop = TLoop(lambda b: torch.zeros(()), [{"x": torch.zeros(3, 2)}] * 2,
                 metrics=MetricsLogger(verbose=False))
    assert loop.run(5) == [0.0, 0.0]   # a finite source ends the loop
    # profile_dir traces the steps of profile_range (it refused until the
    # profiler tooling was ported) and leaves the losses alone
    from minips_tpu_torch.utils.trace_analysis import summarize

    prof = TLoop(step, TBatches(data, 4, seed=1), step_offset=7,
                 metrics=MetricsLogger(verbose=False),
                 profile_dir=str(tmp_path / "prof"), profile_range=(1, 3))
    assert prof.run(6) == want
    assert summarize(str(tmp_path / "prof"))["source"] == "host"
