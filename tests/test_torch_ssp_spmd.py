"""``train/ssp_spmd.py`` (CollectiveSSP) of the port against the JAX
package's, at world one on the CPU.

Each case of ``tests/test_ssp_spmd.py`` runs on both packages with the
same seeded numpy batches: the JAX trainer on the suite's 8-device mesh,
the port's on one device (its table pads to one shard, the JAX table to
eight; ``interop.load_cssp`` refits a carried state). The two compute the
same batch-mean gradient in another reduction order, so losses and
parameters agree within ``TOL``; the port's own invariants (the sync at
world one is the identity, bit for bit) hold exactly, as the reference's
do. The JAX sync compiles to an HLO all-reduce; the port's keeps a record
of the collectives a sync launches (``sync_record``) and the test holds
that record instead.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minips_tpu.models import lr as jlr
from minips_tpu.train.ssp_spmd import CollectiveSSP as JCollectiveSSP
from minips_tpu_torch import interop
from minips_tpu_torch.comm import cluster
from minips_tpu_torch.models import lr as tlr
from minips_tpu_torch.train import ssp_spmd
from minips_tpu_torch.train.ssp_spmd import CollectiveSSP

CPU = torch.device("cpu")
TOL = 1e-5  # f32 LR: the JAX mesh's 8-shard gradient mean vs one device's


def _batch(rng, n=32, d=16):
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    return {"x": x, "y": y}


def _port(d=16, **kw):
    return CollectiveSSP(tlr.init(d, device=CPU), tlr.grad_fn_dense,
                         device=CPU, **kw)


def _jax(d=16, **kw):
    return JCollectiveSSP(jlr.init(d), jlr.grad_fn_dense, **kw)


def _params(tr) -> np.ndarray:
    t = tr.table
    return np.asarray(t.params)[: t.num_keys] if hasattr(
        t.params, "sharding") else t.params.numpy()[: t.num_keys]


def test_collective_ssp_single_process_trains():
    rng = np.random.default_rng(0)
    bs = [_batch(rng) for _ in range(6)]
    jt = _jax(lr=0.3, sync_every=2)
    pt = _port(lr=0.3, sync_every=2)
    jl = [jt.step(b) for b in bs]
    pl = [pt.step(b) for b in bs]
    np.testing.assert_allclose(pl, jl, atol=TOL)
    assert pl[-1] < pl[0]
    assert (pt.clock, pt.sync_rounds) == (jt.clock, jt.sync_rounds) == (6, 3)
    np.testing.assert_allclose(_params(pt), _params(jt), atol=TOL)
    assert torch.isfinite(pt.table.params).all()


def test_collective_ssp_sync_is_identity_at_world_one():
    """One process: base + own delta reproduces the params EXACTLY in
    both packages, also right after a sync (the base was refreshed)."""
    rng = np.random.default_rng(1)
    bs = [_batch(rng) for _ in range(3)]
    for tr in (_jax(lr=0.3, sync_every=10_000),
               _port(lr=0.3, sync_every=10_000)):
        for b in bs:
            tr.step(b)
        before = np.array(_params(tr))
        tr._sync()
        np.testing.assert_array_equal(_params(tr), before)
        assert tr.sync_rounds == 1
        tr._sync()
        np.testing.assert_array_equal(_params(tr), before)


def test_collective_ssp_finalize_merges_tail():
    rng = np.random.default_rng(2)
    bs = [_batch(rng) for _ in range(6)]
    rounds = []
    for tr in (_jax(lr=0.3, sync_every=4), _port(lr=0.3, sync_every=4)):
        for b in bs:  # 4 + a 2-step tail
            tr.step(b)
        got = [tr.sync_rounds]
        tr.finalize()
        got.append(tr.sync_rounds)
        tr.finalize()  # aligned clock: no extra collective
        got.append(tr.sync_rounds)
        rounds.append(got)
    assert rounds[0] == rounds[1] == [1, 2, 2]


def test_collective_ssp_sync_program_is_a_collective():
    """The JAX sync compiles to an all-reduce; the port's record says its
    sync is one all_reduce of the padded float32 delta."""
    assert "all-reduce" in _jax().sync_hlo()
    tr = _port()
    rec = tr.sync_record()
    assert [(r["op"], r["dtype"]) for r in rec] == [("all_reduce",
                                                     "float32")]
    assert rec[0]["bytes"] == 4 * tr.table.padded
    assert ssp_spmd.sync_wire_ok(rec, "float32")


def test_collective_ssp_rejects_bad_sync_every():
    for make in (_jax, _port):
        with pytest.raises(ValueError, match="sync_every"):
            make(d=8, sync_every=0)


def test_collective_ssp_multiprocess_without_bus_refuses(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(cluster, "process_count", lambda: 2)
    for make in (_jax, _port):
        with pytest.raises(ValueError, match="control bus"):
            make(d=8, staleness=2, sync_every=8)


def test_collective_ssp_local_step_stays_on_local_devices():
    tr = _port()
    assert tr.table.params.device == CPU
    assert all(x.device == CPU for x in tr.table.opt_state)
    assert tr._base.device == CPU
    # the sync plane spans every process (one here), one device each
    assert (tr.plane.nprocs, tr.plane.n_local) == (cluster.process_count(),
                                                   1)
    jt = _jax()
    assert len(jt.sync_mesh.devices.ravel()) == len(jax.devices())


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "adam"])
def test_carried_state_trains_alike(updater):
    """``interop.load_cssp`` carries a JAX trainer's mid-run state (params,
    opt state, base) into the port's; the next steps agree."""
    rng = np.random.default_rng(3)
    bs = [_batch(rng) for _ in range(6)]
    jt = _jax(updater=updater, lr=0.1, sync_every=3)
    for b in bs[:2]:
        jt.step(b)
    pt = _port(updater=updater, lr=0.1, sync_every=3)
    interop.load_cssp(pt, np.asarray(jt.table.params),
                      [np.asarray(x) for x in
                       jax.tree.leaves(jt.table.opt_state)],
                      base=np.asarray(jt._base))
    pt.clock = pt._synced_at = 2
    jl = [jt.step(b) for b in bs[2:]]
    pl = [pt.step(b) for b in bs[2:]]
    np.testing.assert_allclose(pl, jl, atol=TOL)
    np.testing.assert_allclose(_params(pt), _params(jt), atol=TOL)
    assert pt.sync_rounds == jt.sync_rounds
