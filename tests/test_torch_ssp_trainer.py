"""``train/ssp_trainer.py`` (SSPTrainer) and ``apps/ssp_lr_example.py``
of the port, on the CPU.

- The JAX package's launched smoke drills (``tests/test_distributed_smoke.py``,
  through ``port_drills``) run on the port's launcher and app: BSP
  lockstep on 3 processes, SSP under a straggler, BASELINE.json's config 2
  (the MLP at SSP s = 4) and the Wide&Deep ASP job. Left out, each run by
  an earlier port file: ``test_run_local_job_tolerates_non_json_brace_lines``
  and ``test_spawn_rank_path_selection`` (``test_torch_partition_launch.py``),
  ``test_wide_deep_multiproc_ssp_staleness4``
  (``test_torch_multiproc_apps.py::test_wide_deep_ssp_straggler_three_processes``).
- The trainer against the JAX package's on two in-process loopback nodes
  each, the same seeded batches, in BSP lockstep: each step starts only
  once both nodes have drained their inboxes (a barrier inside the step
  function), so which peer deltas a step sees is fixed, and the two
  packages' per-node losses and replicas agree within ``TOL`` (f32 LR;
  the gradient's reduction order differs).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import lr as jlr
from minips_tpu.train.ssp_trainer import SSPTrainer as JSSPTrainer
from minips_tpu_torch import interop
from minips_tpu_torch.models import lr as tlr
from minips_tpu_torch.train.ssp_trainer import SSPTrainer
from minips_tpu_torch.utils.tree import tree_leaves, tree_rebuild
from tests.conftest import mk_loopback_buses
from tests.torch_ref_drills import port_drills, port_loopback_buses

LEAVE = ("test_run_local_job_tolerates_non_json_brace_lines",
         "test_spawn_rank_path_selection",
         "test_wide_deep_multiproc_ssp_staleness4")
globals().update(port_drills("test_distributed_smoke.py", leave=LEAVE))

TOL = 1e-6
D, B, STEPS, LR = 16, 32, 8, 0.2


def _batches(rank):
    rng = np.random.default_rng(100 + rank)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(B, D)).astype(np.float32)
        out.append({"x": x, "y": (x.sum(axis=1) > 0).astype(np.float32)})
    return out


def _run(pkg: str, staleness: float, compress: float = 1.0):
    """Two nodes of ``pkg``'s trainer in lockstep threads; returns each
    node's losses and final flat replica."""
    buses = (port_loopback_buses if pkg == "port" else mk_loopback_buses)(2)
    gate = threading.Barrier(2, timeout=60)
    if pkg == "port":
        def step(p, b):
            loss, g = tlr.grad_fn_dense(p, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
            new = [w - LR * gw / 2 for w, gw in
                   zip(tree_leaves(p), tree_leaves(g))]
            return tree_rebuild(p, iter(new)), loss
        make = lambda bus: SSPTrainer(  # noqa: E731
            step, tlr.init(D, device="cpu"), bus, 2, staleness=staleness,
            gate_timeout=30.0, compress=compress)
    else:
        @jax.jit
        def jstep(p, b):
            loss, g = jax.value_and_grad(jlr.loss_dense)(p, b)
            return jax.tree.map(lambda w, gw: w - LR * gw / 2, p, g), loss
        step = jstep
        make = lambda bus: JSSPTrainer(  # noqa: E731
            step, jlr.init(D), bus, 2, staleness=staleness,
            gate_timeout=30.0, compress=compress)

    def locked(fn):
        def run(p, b):
            gate.wait()  # both nodes drained their inboxes
            return fn(p, b)
        return run

    out, errs = [None, None], []
    try:
        trainers = [make(b) for b in buses]
        for t in trainers:
            t.step_fn = locked(t.step_fn)

        def node(r):
            try:
                losses = [trainers[r].step(b) for b in _batches(r)]
                trainers[r].finalize(timeout=30.0)
                flat = trainers[r].state_dict()["flat"]
                out[r] = (losses, np.asarray(flat))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append((r, repr(e)))

        ts = [threading.Thread(target=node, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts) and not errs, errs
        return out
    finally:
        for b in buses:
            b.close()


@pytest.mark.parametrize("compress", [1.0, 0.5])
def test_ssp_trainer_lockstep_matches_the_jax_trainer(compress):
    """BSP (the gate admits step c + 1 only after the peer's clock c, and
    its delta c precedes that clock on the wire), with the dense and the
    top-k push; SSP lets a node drain before or after a peer's delta
    lands, which no lockstep fixes."""
    port = _run("port", 0, compress)
    ref = _run("ref", 0, compress)
    for (pl, pf), (jl, jf) in zip(port, ref):
        np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL)
        np.testing.assert_allclose(pf, jf, rtol=0, atol=TOL)
    # replicas agree after finalize, in each package
    np.testing.assert_allclose(port[0][1], port[1][1], rtol=0, atol=1e-6)


def test_state_dict_carries_between_the_packages():
    """``interop.load_ssp`` carries a JAX trainer's replica and clock into
    the port's; the port's ``state_dict`` gives the same layout back."""
    jbuses, pbuses = mk_loopback_buses(1), port_loopback_buses(1)
    try:
        jt = JSSPTrainer(lambda p, b: (p, 0.0), jlr.init(D), jbuses[0], 1)
        pt = SSPTrainer(lambda p, b: (p, 0.0), tlr.init(D, device="cpu"),
                        pbuses[0], 1)
        flat = np.arange(D + 1, dtype=np.float32) / 7
        jt.load_state_dict({"flat": jnp.asarray(flat), "clock": 5})
        interop.load_ssp(pt, np.asarray(jt.state_dict()["flat"]),
                         int(jt.state_dict()["clock"]))
        got = pt.state_dict()
        np.testing.assert_array_equal(got["flat"], flat)
        assert int(got["clock"]) == 5 and pt.clock == 5
        # the replica's tree is the JAX trainer's, leaf for leaf
        for a, b in zip(tree_leaves(pt.params), jax.tree.leaves(jt.params)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    finally:
        for b in jbuses + pbuses:
            b.close()
