"""Rank bodies of the apps' and the Engine's process-group tests
(``test_torch_apps_ranks.py``, ``test_torch_engine_group.py``,
``test_torch_ckpt_group.py``).

``minips_tpu_torch.parallel.mesh.run_ranks`` spawns fresh interpreters
that import this module by name, so it imports neither JAX nor the JAX
package. The JAX package's initial weights arrive as numpy arrays (the
JAX app's own, built on ``make_mesh(n)`` in the test process) and results
go back as plain values.

:func:`run_cases` takes ``(group, device, cases)``, ``cases`` a list of
``(name, kind, spec)``, runs every case in order on every rank (one
case's collectives must not interleave with another's) and returns each
rank's results by name, with ``"_jax"`` listing the JAX modules the rank
imported (none).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading

import numpy as np
import torch

from minips_tpu_torch import consistency, interop
from minips_tpu_torch.apps import lm_example as tlmx
from minips_tpu_torch.apps import lr_example as tlrx
from minips_tpu_torch.apps import mf_example as tmfx
from minips_tpu_torch.apps import mlp_example as tmlpx
from minips_tpu_torch.apps import wide_deep_example as twd
from minips_tpu_torch.apps import word2vec_example as tw2vx
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.core.engine import Engine, MLTask
from minips_tpu_torch.models import mlp as tmlp
from minips_tpu_torch.parallel.mesh import world
from minips_tpu_torch.utils.metrics import MetricsLogger
from minips_tpu_torch.utils.tree import value_and_grad

APPS = {"wide_deep": twd, "lr": tlrx, "mlp": tmlpx, "mf": tmfx,
        "word2vec": tw2vx, "lm": tlmx}
# what a case hands back: the apps' host results
RESULTS = ("losses", "auc", "rmse", "accuracy", "samples_per_sec", "skew",
           "start_step")


@contextlib.contextmanager
def _patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def _cfg(spec) -> tcfg.Config:
    return tcfg.Config(table=tcfg.TableConfig(**spec["table"]),
                       train=tcfg.TrainConfig(**spec["train"]))


def _mlp_grad_f32(params, batch):
    """The MLP's ``grad_fn`` at float32 compute."""
    return value_and_grad(lambda p: tmlp.loss(
        p, batch, compute_dtype=torch.float32), params)


def _weights(app: str, w):
    """The patches that start ``app``'s tables from the JAX weights ``w``
    (global numpy state; each rank keeps its shard); none without."""
    if w is None:
        return []
    if app == "wide_deep":
        orig = twd.build

        def build(cfg, **kw):
            ps, (wide, emb, deep) = orig(cfg, **kw)
            interop.load_sparse(wide, w["wide"])
            interop.load_sparse(emb, w["emb"])
            interop.load_dense(deep, *w["deep"])
            return ps, (wide, emb, deep)
        return [(twd, {"build": build})]
    if app == "mlp":
        return [(tmlpx.mlp_model, {
            "init": lambda gen, sizes, device=None:
            interop.tree_from_numpy(w, device),
            "grad_fn": _mlp_grad_f32})]
    if app == "mf":
        orig = tmfx.make_tables

        def make_tables(cfg, users, items, device, group=None):
            u, i = orig(cfg, users, items, device, group)
            interop.load_sparse(u, w["user"])
            interop.load_sparse(i, w["item"])
            return u, i
        return [(tmfx, {"make_tables": make_tables})]
    if app == "word2vec":
        orig = tw2vx.make_tables

        def make_tables(cfg, device, group=None):
            i, o = orig(cfg, device, group)
            interop.load_sparse(i, w["in"])
            return i, o
        return [(tw2vx, {"make_tables": make_tables})]
    return []


class _Recording(consistency.SSP):
    """SSP that records, at every admitted pull, how far the worker's
    clock is ahead of the slowest worker's."""
    gaps: list = []

    def wait_until_admitted(self, worker, timeout=None):
        ok = super().wait_until_admitted(worker, timeout)
        with self._cond:
            self.gaps.append(self.tracker.clock_of(worker)
                             - self.tracker.min_clock)
        return ok


def _app(group, device, spec) -> dict:
    """An app's ``run(cfg, args, metrics, group)`` on this rank, from the
    JAX weights where ``spec`` carries them; ``record_gaps`` wraps every
    controller in :class:`_Recording`."""
    patches = _weights(spec["app"], spec.get("weights"))
    if spec.get("record_gaps"):
        _Recording.gaps = []
        patches.append((consistency, {
            "make_controller": lambda kind, n, staleness, sync_every:
            _Recording(n, staleness=staleness)}))
    with contextlib.ExitStack() as stack:
        for obj, attrs in patches:
            stack.enter_context(_patched(obj, **attrs))
        out = APPS[spec["app"]].run(
            _cfg(spec), argparse.Namespace(device=device, **spec["args"]),
            MetricsLogger(None, verbose=False), group)
    res = {k: out[k] for k in RESULTS if k in out}
    if spec.get("record_gaps"):
        res["gaps"] = list(_Recording.gaps)
    return res


def _steps(path: str) -> list[str]:
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def _resume(group, device, spec) -> dict:
    """An app's run whole, then the same run stopped halfway with a
    checkpoint and started again from it, on every rank: the three runs'
    results and the step directories after each save."""
    app, iters = spec["app"], spec["train"]["num_iters"]
    base = dict(spec, train=dict(spec["train"], checkpoint_dir=None,
                                 checkpoint_every=0))
    whole = _app(group, device, base)
    ck = dict(spec["train"], checkpoint_dir=spec["dir"],
              checkpoint_every=iters // 2)
    args = dict(spec["args"], resume=True) if app == "lm" else spec["args"]
    part = _app(group, device, dict(spec, args=args, train=dict(
        ck, num_iters=iters // 2)))
    after_part = _steps(spec["dir"])
    resumed = _app(group, device, dict(spec, args=args, train=ck))
    return {"whole": whole, "part": part, "resumed": resumed,
            "after_part": after_part, "after_resume": _steps(spec["dir"])}


# ------------------------------------------------------------------ engine
def _engine_defaults(group, device, spec) -> dict:
    """The Engine's defaults under a group, and its barrier."""
    e = Engine(group=group).start_everything()
    e.barrier()
    return {"workers": e.num_workers, "device": str(e.device),
            "rank_device": str(device), "ranks": e.num_ranks}


def _engine_snapshot(group, device, spec) -> dict:
    """``test_torch_engine.py``'s snapshot case over a group: rank 0's
    worker 0 pulls a dense tree and sparse rows, worker 1 pushes three
    times to each, and the pulled values stay as they were while the
    tables move."""
    e = Engine(num_workers=2, group=group).start_everything()
    e.create_table(tcfg.TableConfig(name="d", kind="dense", lr=0.5,
                                    consistency="asp"),
                   template={"w": torch.arange(8.0)})
    e.create_table(tcfg.TableConfig(name="s", kind="sparse", num_slots=64,
                                    dim=4, lr=1.0, consistency="asp",
                                    init_scale=0.1, updater="adagrad"))
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
    after_d, after_s = e.tables["d"].pull()["w"], e.tables["s"].pull(keys)
    e.stop_everything()
    if world(group)[0] != 0:
        return {}
    return {"d_kept": torch.equal(pulled["d"]["w"], pulled["d0"]),
            "s_kept": torch.equal(pulled["s"], pulled["s0"]),
            "d_moved": not torch.equal(after_d, pulled["d0"]),
            "s_moved": not torch.equal(after_s, pulled["s0"])}


def _ops_udf(info):
    """Every kind of table op, in a fixed order: dense pull, pull_keys,
    push and push_keys; sparse pull and push."""
    d, s = info.table("d"), info.table("s")
    keys = np.array([[1, 5, 9], [5, 40, 63]])
    out = []
    for i in range(3):
        w = d.pull()["w"]
        part = d.pull(keys=np.array([0, 3, 7]))
        rows = s.pull(keys)
        d.push({"w": torch.sin(w + i)})
        d.push(torch.tensor([0.5, -1.0, 2.0]) * (i + 1),
               keys=np.array([2, 3, 7]))
        s.push(torch.cos(rows), keys=keys)
        d.clock()
        s.clock()
        out.append([float(w.sum()), float(part.sum()), float(rows.sum())])
    return out


def _ops_engine(group, device):
    e = Engine(num_workers=1, device=device, group=group).start_everything()
    e.create_table(tcfg.TableConfig(name="d", kind="dense", lr=0.5,
                                    updater="adagrad"),
                   template={"w": torch.linspace(-1.0, 1.0, 10)})
    e.create_table(tcfg.TableConfig(name="s", kind="sparse", num_slots=64,
                                    dim=4, lr=0.3, init_scale=0.1,
                                    updater="adagrad"))
    return e


def _engine_ops(group, device, spec) -> dict:
    """One worker's every kind of table op through the group against the
    same ops on one device: the same pulls and the same final tables."""
    got = _ops_engine(group, device)
    got_pulls = got.run(MLTask(fn=_ops_udf))[0]
    got_d = got.tables["d"].state_dict()
    got_s = got.tables["s"].state_dict()
    one = _ops_engine(None, device)
    want_pulls = one.run(MLTask(fn=_ops_udf))[0]
    want_d, want_s = one.tables["d"].state_dict(), one.tables["s"].state_dict()
    n = one.tables["d"].num_keys
    return {"pulls": got_pulls == want_pulls,
            "dense": all(np.array_equal(a[:n], b[:n]) for a, b in zip(
                [got_d["params"], *got_d["opt_state"]],
                [want_d["params"], *want_d["opt_state"]])),
            "sparse": all(np.array_equal(got_s[k], want_s[k])
                          for k in want_s)}


def engine_error(group, device):
    """``test_udf_error_surfaces_root_cause`` over a group: rank 0's
    worker 1 raises while worker 0 waits at the BSP gate."""
    e = Engine(num_workers=2, group=group).start_everything()
    e.create_table(tcfg.TableConfig(name="t", kind="dense", lr=0.5,
                                    consistency="bsp"),
                   template={"w": torch.zeros(8)})

    def udf(info):
        tbl = info.table("t")
        if info.worker_id == 1:
            raise RuntimeError("worker 1 exploded")
        tbl.pull()
        tbl.push({"w": torch.ones(8)})
        tbl.clock()
        tbl.pull(timeout=30.0)  # parked; unblocked by the stop cascade

    e.run(MLTask(fn=udf))


KINDS = {"app": _app, "resume": _resume, "engine_defaults": _engine_defaults,
         "engine_snapshot": _engine_snapshot, "engine_ops": _engine_ops}


def run_cases(group, device, cases):
    """Every case of ``cases`` on this rank, in order; a case whose spec
    has ``raises`` returns the message of the ``SystemExit`` it raised."""
    out = {}
    for name, kind, spec in cases:
        try:
            out[name] = KINDS[kind](group, device, spec)
        except SystemExit as e:
            if not spec.get("raises"):
                raise
            out[name] = {"raised": str(e)}
    out["_jax"] = sorted({m.split(".")[0] for m in sys.modules}
                         & {"jax", "jaxlib", "optax", "minips_tpu"})
    return out
