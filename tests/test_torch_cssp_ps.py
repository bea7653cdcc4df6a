"""``train/cssp_ps.py`` (CollectiveSSPPS) and the compressed and
reconciled syncs of ``train/ssp_spmd.py``: the port against the JAX
package, on the CPU.

The cases are ``tests/test_cssp_ps.py``'s fast tier, each on both
packages with the same seeded inputs. The JAX trainers run on the
suite's 8-device mesh, the port's on one device; the W&D tables start
from the JAX tables' state, carried across by ``interop.load_cssp_ps``
(torch cannot replay ``jax.random``). Where the two reduce a gradient in
another order the tolerance is ``TOL``; the port's own invariants (a
one-process sync is the identity, bit for bit; untouched rows never
move) are held exactly, as the reference holds its own.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from minips_tpu.models import lr as jlr
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables.sparse import next_pow2 as jnext_pow2
from minips_tpu.train import cssp_ps as jcssp
from minips_tpu.train import ssp_spmd as jspmd
from minips_tpu_torch import interop
from minips_tpu_torch.apps.wide_deep_example import build as tbuild
from minips_tpu_torch.comm import cluster
from minips_tpu_torch.comm.bus import BlobExchange
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.models import lr as tlr
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import hash_to_slots_np
from minips_tpu_torch.train import cssp_ps, ssp_spmd
from tests.test_cssp_ps import _batches, _tiny_build
from tests.torch_ref_drills import port_loopback_buses

CPU = torch.device("cpu")
TOL = 1e-5


def _port_build(device, updater="adagrad", num_slots=4096, seed=0):
    cfg = Config(
        table=TableConfig(name="ctr", kind="sparse", updater=updater,
                          lr=0.05, dim=4, num_slots=num_slots),
        train=TrainConfig(batch_size=32, num_iters=4),
    )
    ps, (wide_t, emb_t, deep_t) = tbuild(cfg, use_fm=True, seed=seed,
                                         device=device)
    return ps, {"wide": wide_t, "emb": emb_t, "deep": deep_t}


def _carry(jt, pt) -> None:
    """The JAX trainer's tables and bases into the port's."""
    interop.load_cssp_ps(
        pt, {k: (np.asarray(t.params),
                 [np.asarray(x) for x in jax.tree.leaves(t.opt_state)])
             for k, t in jt.dense.items()},
        {k: {kk: np.asarray(v) for kk, v in t.state_dict().items()}
         for k, t in jt.sparse.items()})


@pytest.fixture
def f32_towers(monkeypatch):
    """Both deep towers compute in float32 (their default is bf16, whose
    roundings the two frameworks place apart; under the tower's Adam a
    flipped near-zero gradient then moves a weight by 2 lr a step, as
    ``tests/test_torch_wide_deep.py`` sets out)."""
    import functools

    import jax.numpy as jnp

    from minips_tpu.models import mlp as jmlp
    from minips_tpu_torch.models import mlp as tmlp

    monkeypatch.setattr(jmlp, "apply", functools.partial(
        jmlp.apply, compute_dtype=jnp.float32))
    monkeypatch.setattr(tmlp, "apply", functools.partial(
        tmlp.apply, compute_dtype=torch.float32))


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "adam"])
def test_single_process_cssp_is_bitwise_the_fused_step(updater, f32_towers):
    """One process: the port's CSSP losses are the port's raw fused-step
    losses bit for bit, and the JAX CSSP's (state carried, towers at
    float32) within TOL."""
    bs = _batches(6)
    pt = cssp_ps.CollectiveSSPPS(
        lambda d: _port_build(d, updater=updater), staleness=2,
        sync_every=2, device=CPU)
    jt = jcssp.CollectiveSSPPS(lambda m: _tiny_build(m, updater=updater),
                               staleness=2, sync_every=2)
    _carry(jt, pt)
    raw, tables = _port_build(CPU, updater=updater)
    for name, t in tables.items():  # the same start as the trainer's
        if isinstance(t, DenseTable):
            t.load_state_dict(pt.dense[name].state_dict())
        else:
            t.load_state_dict(pt.sparse[name].state_dict())
    port = [pt.step(b) for b in bs]
    pt.finalize()
    assert port == [float(raw(raw.shard_batch(b))) for b in bs]
    assert pt.sync_rounds == 3
    ref = [jt.step(b) for b in bs]
    np.testing.assert_allclose(port, ref, atol=TOL)


def test_sync_leaves_untouched_rows_and_bases_consistent():
    pt = cssp_ps.CollectiveSSPPS(lambda d: _port_build(d), sync_every=1,
                                 device=CPU)
    emb_t = pt.sparse["emb"]
    init_emb = emb_t.emb.clone()
    touched: set = set()
    for b in _batches(3):
        pt.step(b)
        touched.update(hash_to_slots_np(
            b["cat"].reshape(-1), emb_t.num_slots, emb_t.salt).tolist())
    for name, t in pt.sparse.items():
        for lname, leaf in pt._leaves(t):
            assert torch.equal(leaf, pt._sparse_base[name][lname])
    untouched = np.setdiff1d(np.arange(emb_t.num_slots),
                             np.fromiter(touched, dtype=np.int64))
    now = emb_t.emb
    assert torch.equal(now[untouched], init_emb[untouched])
    assert float((now - init_emb).abs().sum()) > 0


def test_row_merge_programs_roundtrip():
    """The port's row programs against the JAX trainer's jitted ones on
    the same leaf, base and union: the delta (padding gathers zero), and
    ``base + merged`` landing on exactly the union rows."""
    jt = jcssp.CollectiveSSPPS(lambda m: _tiny_build(m, num_slots=64))
    emb = np.asarray(jt.sparse["emb"].emb)
    dim = emb.shape[1]
    rng = np.random.default_rng(0)
    bump = rng.normal(size=(3, dim)).astype(np.float32)
    cur = emb.copy()
    cur[[3, 9, 40]] += bump
    idx = np.full(8, 64, np.int64)   # C=8, union size 3
    idx[:3] = [3, 9, 40]
    jidx = jax.device_put(jax.numpy.asarray(idx, jax.numpy.int32),
                          jt._rep_sharding)
    jcur = jax.device_put(cur, jt.sparse["emb"].emb.sharding)
    jbase = jax.device_put(emb, jt.sparse["emb"].emb.sharding)
    jd = jt._rows_delta(jcur, jbase, jidx)
    pcur, pbase = torch.from_numpy(cur.copy()), torch.from_numpy(emb.copy())
    pidx = torch.from_numpy(idx)
    pd = cssp_ps.rows_delta(pcur, pbase, pidx)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert not pd.reshape(8, dim)[3:].any()      # padding gathers zero
    jnew, jnb = jt._apply_for(jt.sparse["emb"].emb.sharding)(
        jcur, jbase, jidx, jax.device_put(jd * 2.0, jd.sharding))
    cssp_ps.rows_apply(pcur, pbase, pidx, pd * 2.0)
    np.testing.assert_array_equal(pcur.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(pbase.numpy(), np.asarray(jnb))
    untouched = np.setdiff1d(np.arange(64), [3, 9, 40])
    np.testing.assert_array_equal(pcur.numpy()[untouched], cur[untouched])


def test_sync_block_rows_divisible_for_any_device_count():
    for n_local in (1, 2, 3, 4, 6, 8, 12):
        for union in (1, 2, 5, 6, 7, 31, 100):
            c = cssp_ps.sync_block_rows(union, n_local)
            assert c == jcssp.sync_block_rows(union, n_local)
            assert c >= union and c % n_local == 0, (union, n_local, c)
            assert c >= max(jnext_pow2(union), n_local)
    assert max(jnext_pow2(5), 6) % 6 != 0      # the old formula: broken
    assert cssp_ps.sync_block_rows(5, 6) == 12  # fixed: 2 rows a device


def test_sync_block_rows_six_device_mesh_shards_evenly():
    """The block of a 6-device host splits into 6 equal shards of its
    ``C * dim`` delta (the old C = 8 at dim 4 did not)."""
    dim, union, n_local = 4, 5, 6
    C = cssp_ps.sync_block_rows(union, n_local)
    cur = torch.arange(16 * dim, dtype=torch.float32).reshape(16, dim)
    idx = torch.full((C,), 16, dtype=torch.int64)
    idx[:union] = torch.arange(union)
    d = cssp_ps.rows_delta(cur, torch.zeros_like(cur), idx)
    assert {p.numel() for p in d.chunk(n_local)} == {C * dim // n_local}
    assert C == 12


def test_blob_exchange_allgather_and_early_arrival():
    buses = port_loopback_buses(2, settle=0.2)
    try:
        ex0, ex1 = (BlobExchange(buses[0], 2), BlobExchange(buses[1], 2))
        a0 = np.array([3, 1, 2], np.int64)
        a1 = np.array([7, 1], np.int64)
        b1 = np.array([9], np.int64)
        res1 = {}

        def side1():
            res1["r0"] = ex1.allgather(0, "emb", a1, timeout=20)
            res1["r1"] = ex1.allgather(1, "emb", b1, timeout=20)

        th = threading.Thread(target=side1)
        th.start()
        time.sleep(0.3)
        got0 = ex0.allgather(0, "emb", a0, timeout=20)
        np.testing.assert_array_equal(got0[0], a0)
        np.testing.assert_array_equal(got0[1], a1)
        got0b = ex0.allgather(1, "emb", np.array([], np.int64), timeout=20)
        np.testing.assert_array_equal(got0b[1], b1)
        th.join(timeout=20)
        assert not th.is_alive()
        np.testing.assert_array_equal(res1["r0"][0], a0)
        np.testing.assert_array_equal(res1["r1"][1], b1)
    finally:
        for b in buses:
            b.close()


def test_cssp_ps_refuses_foreign_tables_and_busless_multiproc(monkeypatch):
    def bad_build(device):
        ps, tables = _port_build(device)
        tables["oops"] = object()
        return ps, tables

    with pytest.raises(TypeError, match="syncs DenseTable"):
        cssp_ps.CollectiveSSPPS(bad_build, device=CPU)
    monkeypatch.setattr(cluster, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="control bus"):
        cssp_ps.CollectiveSSPPS(_port_build, bus=None, device=CPU)


def _lr_data(D=32, B=64, iters=24):
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=D)
    xs, ys = [], []
    for _ in range(iters):
        x = rng.normal(size=(B, D)).astype(np.float32)
        xs.append(x)
        ys.append((x @ w_true > 0).astype(np.float32))
    return xs, ys


def _islands(opt_sync, xs, ys, D=32, B=64, sync_every=4):
    """Two simulated port islands on the oracle's merge schedule (the
    reference test's simulation, on port tables)."""
    tables = [DenseTable(tlr.init(D, device=CPU), name=f"i{h}",
                         updater="adam", lr=0.02, device=CPU)
              for h in range(2)]
    steps = [t.make_step(tlr.grad_fn_dense) for t in tables]
    bases = [t.params.clone() for t in tables]
    for i in range(len(xs)):
        for h in range(2):
            half = slice(h * B // 2, (h + 1) * B // 2)
            tables[h].step_inplace(steps[h], {
                "x": torch.from_numpy(xs[i][half]),
                "y": torch.from_numpy(ys[i][half])})
        if (i + 1) % sync_every == 0 or i + 1 == len(xs):
            total = sum(t.params - b for t, b in zip(tables, bases))
            for h in range(2):
                tables[h].params = bases[h] + total
                bases[h] = tables[h].params.clone()
            if opt_sync == "avg":
                for j, leaf in enumerate(tables[0].opt_state):
                    if ssp_spmd.is_avg_leaf(leaf, tables[0].padded):
                        mean = (tables[0].opt_state[j]
                                + tables[1].opt_state[j]) / 2
                        for t in tables:
                            t.opt_state[j] = mean.clone()
    if opt_sync == "avg":
        for a, b in zip(tables[0].opt_state, tables[1].opt_state):
            if ssp_spmd.is_avg_leaf(a, tables[0].padded):
                assert torch.equal(a, b)
    return tables[0].params.numpy()[: tables[0].num_keys]


def test_adam_moment_reconciliation_vs_centralized():
    """The reference's drift pin on port tables: both opt_sync modes land
    near the centralized server's params, averaging no worse than local,
    and the distances agree with the JAX simulation's within 1e-3."""
    from minips_tpu.tables.dense import DenseTable as JDense

    xs, ys = _lr_data()
    D, B = 32, 64
    ct = DenseTable(tlr.init(D, device=CPU), name="central", updater="adam",
                    lr=0.02, device=CPU)
    jct = JDense(jlr.init(D), make_mesh(8), name="central", updater="adam",
                 lr=0.02)
    for i in range(len(xs)):
        for h in range(2):
            half = slice(h * B // 2, (h + 1) * B // 2)
            _, g = tlr.grad_fn_dense(ct.pull(), {
                "x": torch.from_numpy(xs[i][half]),
                "y": torch.from_numpy(ys[i][half])})
            ct.push(g)
            _, jg = jlr.grad_fn_dense(jct.pull(), {
                "x": jax.numpy.asarray(xs[i][half]),
                "y": jax.numpy.asarray(ys[i][half])})
            jct.push(jg)
    central = ct.params.numpy()[: ct.num_keys]
    np.testing.assert_allclose(central, np.asarray(jct.params)[:D + 1],
                               atol=1e-4)
    d_local = float(np.linalg.norm(_islands("local", xs, ys) - central))
    d_avg = float(np.linalg.norm(_islands("avg", xs, ys) - central))
    assert d_local > 0
    assert d_avg <= d_local * 1.1, (d_avg, d_local)
    assert d_avg < 0.5 * np.linalg.norm(central) + 1.0, d_avg
    # the reference's own numbers at these shapes (its docstring: ~11% of
    # the central norm for both modes)
    ratio = np.linalg.norm(central)
    assert 0.02 < d_local / ratio < 0.5 and 0.02 < d_avg / ratio < 0.5


@pytest.mark.parametrize("comm", ["bfloat16", "int8"])
def test_sync_comm_compressed_wire_tolerance(comm):
    D = 64
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=D)
    bs = []
    for _ in range(30):
        x = rng.normal(size=(64, D)).astype(np.float32)
        bs.append({"x": x, "y": (x @ w_true > 0).astype(np.float32)})

    def run(sync_comm):
        tr = ssp_spmd.CollectiveSSP(
            tlr.init(D, device=CPU), tlr.grad_fn_dense, updater="adagrad",
            lr=0.3, sync_every=2, sync_comm=sync_comm, name=f"q{sync_comm}",
            device=CPU)
        ls = [tr.step(b) for b in bs]
        tr.finalize()
        return ls, tr

    f32_ls, _ = run("float32")
    q_ls, tr = run(comm)
    assert q_ls[-1] < q_ls[0] * 0.5
    assert abs(q_ls[-1] - f32_ls[-1]) < 0.02
    assert float(tr._residual.abs().sum()) > 0
    # the wire: all-to-all and all-gather of the compressed codes
    rec = tr.sync_record()
    assert ssp_spmd.sync_wire_ok(rec, comm)
    assert {r["op"] for r in rec} == {"all_to_all", "all_gather"}
    # and the JAX trainer on the same wire lands alike
    jtr = jspmd.CollectiveSSP(jlr.init(D), jlr.grad_fn_dense,
                              updater="adagrad", lr=0.3, sync_every=2,
                              sync_comm=comm, name=f"jq{comm}")
    j_ls = [jtr.step(b) for b in bs]
    np.testing.assert_allclose(q_ls, j_ls, atol=2e-3)


def test_sync_comm_refusals():
    with pytest.raises(ValueError, match="one lever per run"):
        ssp_spmd.CollectiveSSP(tlr.init(16, device=CPU), tlr.grad_fn_dense,
                               updater="adam", opt_sync="avg",
                               sync_comm="int8", device=CPU)
    with pytest.raises(ValueError, match="comm must be"):
        ssp_spmd.CollectiveSSP(tlr.init(16, device=CPU), tlr.grad_fn_dense,
                               sync_comm="int4", device=CPU)


def test_opt_sync_avg_refuses_adam8():
    with pytest.raises(ValueError, match="quantized moments"):
        ssp_spmd.CollectiveSSP(tlr.init(64, device=CPU), tlr.grad_fn_dense,
                               updater="adam8", opt_sync="avg", device=CPU)


def test_snapshot_schedule_refuses_off_boundary():
    for v in (ssp_spmd.validate_snapshot_schedule,
              jspmd.validate_snapshot_schedule):
        with pytest.raises(SystemExit, match="not a sync boundary"):
            v("/tmp/ck", 3, 0, iters=16, sync_every=4)
        with pytest.raises(SystemExit, match="not a sync boundary"):
            v("/tmp/ck", 0, 6, iters=16, sync_every=4)
        with pytest.raises(SystemExit, match="no sync boundary"):
            v("/tmp/ck", 0, 0, iters=3, sync_every=8)
        with pytest.raises(SystemExit, match="need --checkpoint-dir"):
            v(None, 8, 0, iters=16, sync_every=4)
        assert v("/tmp/ck", 0, 0, iters=14, sync_every=4) == 12
        assert v("/tmp/ck", 8, 4, iters=16, sync_every=4) == 8
