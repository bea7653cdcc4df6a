"""``utils/profiling.py`` of the port against the reference's
``tests/test_profiling.py``: a step window writes a ``*.trace.json.gz``
holding exactly the window's steps, an early close is idempotent, and
annotations add up. Unlike the reference, a profiler that cannot write
its capture raises instead of passing silently."""

from __future__ import annotations

import glob
import os
import time

import jax.numpy as jnp
import pytest
import torch

from minips_tpu.utils.profiling import StepWindowProfiler as JWindow
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.utils import trace_analysis as ta
from minips_tpu_torch.utils.metrics import MetricsLogger
from minips_tpu_torch.utils.profiling import (Annotation,
                                              StepWindowProfiler,
                                              profile_trace)

CPU = torch.device("cpu")


def _traces(d) -> list:
    return glob.glob(os.path.join(d, "**", "*.trace.json.gz"),
                     recursive=True)


def test_step_window_profiler_writes_trace(tmp_path):
    """Both packages' windows write an artifact; the port's is one gzipped
    Chrome trace holding the window's two steps and no other."""
    d, jd = str(tmp_path / "trace"), str(tmp_path / "jtrace")
    p, jp = StepWindowProfiler(d, start=2, stop=4), JWindow(jd, 2, 4)
    x = torch.ones(32, 32)
    for i in range(6):
        p.on_step(i)
        jp.on_step(i)
        torch.mm(x, x)
        jnp.sum(jnp.ones(16)).block_until_ready()
    p.close()
    jp.close()
    assert [os.path.join(r, f) for r, _, fs in os.walk(jd) for f in fs]
    (path,) = _traces(d)
    assert path.endswith(".pt.trace.json.gz")
    events, pids = ta.load_events(path)
    assert sum(e["name"] == "aten::mm" for e in events) == 2
    assert p.profile is not None and p._ctx is None


def test_window_closed_even_if_run_ends_early(tmp_path):
    p = StepWindowProfiler(str(tmp_path / "t2"), start=0, stop=100)
    p.on_step(0)
    p.close()  # must not raise / leak an open trace
    p.close()  # idempotent
    assert len(_traces(str(tmp_path / "t2"))) == 1
    with pytest.raises(ValueError, match="non-empty"):
        StepWindowProfiler(str(tmp_path), start=3, stop=3)


def test_annotation_accumulates():
    Annotation.totals.clear()
    with Annotation("phase_x"):
        time.sleep(0.01)
    with Annotation("phase_x"):
        time.sleep(0.01)
    assert Annotation.totals["phase_x"] >= 0.02


def test_annotation_shows_in_the_trace(tmp_path):
    Annotation.totals.clear()
    with profile_trace(str(tmp_path), device="cpu"):
        with Annotation("load_batch"):
            torch.ones(8).sum()
    events, _ = ta.load_events(ta.latest_trace_file(str(tmp_path)))
    assert [e["name"] for e in events].count("load_batch") == 1
    assert Annotation.totals["load_batch"] > 0


def test_a_capture_that_cannot_be_written_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        with profile_trace(str(blocker / "sub"), device="cpu"):
            pass


def test_train_loop_profiles_its_window(tmp_path):
    """``TrainLoop(profile_dir=, profile_range=)`` traces the steps of the
    range, closes the window when the run ends inside it, and closes it
    when a step raises."""
    x = torch.ones(16, 16)

    def step(batch):
        return torch.mm(x, batch).sum()

    for rng, iters, want in (((1, 4), 6, 3), ((2, 10), 5, 3)):
        d = str(tmp_path / f"w{rng[0]}")
        loop = TrainLoop(step, [x] * 8, metrics=MetricsLogger(verbose=False),
                         profile_dir=d, profile_range=rng)
        assert len(loop.run(iters)) == iters
        out = ta.summarize(d)
        assert out["source"] == "host"
        mm = {o["name"]: o["count"] for o in ta.op_table(
            *ta.load_events(out["trace_file"]), top=100)["ops"]}
        assert mm["aten::mm"] == want

    def boom(batch):
        raise RuntimeError("step failed")

    d = str(tmp_path / "err")
    loop = TrainLoop(boom, [x] * 4, metrics=MetricsLogger(verbose=False),
                     profile_dir=d, profile_range=(0, 2))
    with pytest.raises(RuntimeError, match="step failed"):
        loop.run(3)
    assert len(_traces(d)) == 1 and loop.profiler._ctx is None
