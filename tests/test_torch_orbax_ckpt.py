"""``ckpt/orbax_backend.py`` — the ``"orbax"`` checkpoint backend of the
port on ``torch.distributed.checkpoint`` (DCP) — and
``ckpt.convert_checkpoint``, on the CPU.

The orbax cases of ``tests/test_checkpoint.py`` on the port's DCP
backend: a roundtrip that resumes identically, retention and
``list_steps``, controller clocks, the factory's default and refusal, a
checkpoint written before the sparse ``layout`` record, and
``convert_checkpoint`` both ways with the optimizer state live after two
hops. The files are DCP's, not TensorStore's, so a checkpoint crosses
between the packages through the native npz format, which both write
alike: a JAX-package checkpoint converts into DCP and back into one the
JAX package restores, every leaf bit for bit. A sharded table's layout
(world size, padding) is recorded and a restore into another is refused.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ckpt.checkpoint import Checkpointer as JCheckpointer
from minips_tpu.consistency import SSP as JSSP
from minips_tpu.tables.sparse import SparseTable as JSparse
from minips_tpu_torch.ckpt import convert_checkpoint
from minips_tpu_torch.ckpt.checkpoint import Checkpointer
from minips_tpu_torch.ckpt.orbax_backend import (OrbaxCheckpointer,
                                                 make_checkpointer)
from minips_tpu_torch.consistency import SSP
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable

CPU = torch.device("cpu")


def _trained_tables(updater="adam"):
    dense = DenseTable({"w": torch.zeros(8)}, updater=updater, lr=0.1,
                       device=CPU)
    sparse = SparseTable(64, 4, updater="adagrad", lr=0.1, seed=7,
                         device=CPU)
    for _ in range(3):
        dense.push({"w": torch.arange(8.0)})
        sparse.push(torch.tensor([1, 2, 3]), torch.ones(3, 4))
    return dense, sparse


def _same_state(a, b) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        x, y = sa[k], sb[k]
        if isinstance(x, list):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_resumes_identically(tmp_path):
    d1, s1 = _trained_tables()
    ck = make_checkpointer(str(tmp_path), {"d": d1, "s": s1},
                           backend="orbax")
    ck.save(step=3)
    ck.wait()
    d2, s2 = _trained_tables()
    d2.push({"w": torch.ones(8) * 100})      # diverge; restore overwrites
    ck2 = make_checkpointer(str(tmp_path), {"d": d2, "s": s2},
                            backend="orbax")
    assert ck2.restore() == 3
    for t in (d1, d2):
        t.push({"w": torch.arange(8.0)})
    assert torch.equal(d2.params, d1.params)
    assert torch.equal(s2.emb, s1.emb)
    ck.close()
    ck2.close()


def test_keep_and_list_steps(tmp_path):
    d, _ = _trained_tables()
    ck = make_checkpointer(str(tmp_path), {"d": d}, keep=2, backend="orbax")
    for step in (1, 2, 3):
        ck.save(step=step)
    ck.wait()
    assert ck.list_steps() == [2, 3]
    # a torn save (no DCP metadata) is never listed
    (tmp_path / "step_9").mkdir()
    assert ck.list_steps() == [2, 3]
    ck.close()


def test_clocks_roundtrip(tmp_path):
    d, _ = _trained_tables()
    ctl = SSP(staleness=2, num_workers=3)
    jctl = JSSP(staleness=2, num_workers=3)
    for c in (ctl, jctl):
        for w in range(3):
            c.clock(w)
        c.clock(0)
    ck = make_checkpointer(str(tmp_path), {"d": d}, {"ssp": ctl},
                           backend="orbax")
    ck.save(step=5)
    ck.wait()
    ctl2 = SSP(staleness=2, num_workers=3)
    ck2 = make_checkpointer(str(tmp_path), {"d": d}, {"ssp": ctl2},
                            backend="orbax")
    assert ck2.restore() == 5
    assert ctl2.state_dict() == ctl.state_dict() == jctl.state_dict()


def test_async_save_publishes_on_wait(tmp_path):
    d1, s1 = _trained_tables()
    ck = make_checkpointer(str(tmp_path), {"d": d1, "s": s1},
                           backend="orbax", async_save=True)
    ck.save(step=2)
    ck.wait()
    assert ck.list_steps() == [2]
    d2, s2 = _trained_tables("adam")
    d2.push({"w": torch.ones(8)})
    assert make_checkpointer(str(tmp_path), {"d": d2, "s": s2},
                             backend="orbax").restore(2) == 2
    _same_state(d1, d2)
    _same_state(s1, s2)


def test_factory_default_is_native(tmp_path, monkeypatch):
    monkeypatch.delenv("MINIPS_CKPT_BACKEND", raising=False)
    d, _ = _trained_tables()
    assert isinstance(make_checkpointer(str(tmp_path), {"d": d}),
                      Checkpointer)
    monkeypatch.setenv("MINIPS_CKPT_BACKEND", "orbax")
    assert isinstance(make_checkpointer(str(tmp_path), {"d": d}),
                      OrbaxCheckpointer)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        make_checkpointer(str(tmp_path), {"d": d}, backend="bogus")


def test_orbax_restores_checkpoint_predating_layout_record(tmp_path):
    s1 = SparseTable(64, 2, updater="sgd", lr=0.5, device=CPU)
    s1.push(torch.tensor([3]), torch.ones(1, 2))
    ck = make_checkpointer(str(tmp_path), {"s": s1}, backend="orbax")
    orig = s1.state_dict

    def legacy_state_dict():
        st = orig()
        st.pop("layout")
        return st

    s1.state_dict = legacy_state_dict
    ck.save(step=1)
    ck.wait()
    s2 = SparseTable(64, 2, updater="sgd", lr=0.5, init_scale=0.0,
                     device=CPU)
    assert make_checkpointer(str(tmp_path), {"s": s2},
                             backend="orbax").restore() == 1
    assert torch.equal(s2.emb, s1.emb)
    s3 = SparseTable(64, 2, updater="sgd", identity=True, device=CPU)
    with pytest.raises(ValueError, match="no layout record"):
        make_checkpointer(str(tmp_path), {"s": s3},
                          backend="orbax").restore()


def test_mismatched_layout_is_refused(tmp_path):
    """A dense table's shards are written under the writer's layout; a
    table of another padding (here another shape) is refused, not read
    into the wrong ranges."""
    d, _ = _trained_tables()
    make_checkpointer(str(tmp_path), {"d": d}, backend="orbax").save(1)
    other = DenseTable({"w": torch.zeros(12)}, updater="adam", device=CPU)
    with pytest.raises(ValueError, match="padded lengths"):
        make_checkpointer(str(tmp_path), {"d": other},
                          backend="orbax").restore()


def test_cross_backend_convert_native_to_orbax_and_back(tmp_path):
    d1, s1 = _trained_tables()
    Checkpointer(str(tmp_path / "nat"), {"d": d1, "s": s1}).save(step=5)
    dm, sm = _trained_tables()
    assert convert_checkpoint(
        str(tmp_path / "nat"), str(tmp_path / "orb"), {"d": dm, "s": sm},
        src_backend="native", dst_backend="orbax") == 5
    d2, s2 = _trained_tables()
    d2.push({"w": torch.ones(8) * 50})
    assert make_checkpointer(str(tmp_path / "orb"), {"d": d2, "s": s2},
                             backend="orbax").restore() == 5
    _same_state(d2, d1)
    _same_state(s2, s1)
    dn, sn = _trained_tables()
    assert convert_checkpoint(
        str(tmp_path / "orb"), str(tmp_path / "nat2"), {"d": dn, "s": sn},
        src_backend="orbax", dst_backend="native") == 5
    d3, s3 = _trained_tables()
    Checkpointer(str(tmp_path / "nat2"), {"d": d3, "s": s3}).restore()
    for d, s in ((d1, s1), (d3, s3)):
        d.push({"w": torch.arange(8.0)})
        s.push(torch.tensor([2, 3]), torch.ones(2, 4))
    assert torch.equal(d3.params, d1.params)
    assert torch.equal(s3.emb, s1.emb)


def test_jax_checkpoint_crosses_through_dcp_and_back(mesh8, tmp_path):
    """A JAX-package native checkpoint of a sparse table (the layout both
    packages write alike) -> the port's DCP backend -> native again, which
    the JAX package restores: every leaf bit for bit."""
    js = JSparse(64, 4, mesh8, updater="adagrad", lr=0.1, seed=7, salt=3)
    for _ in range(3):
        js.push(jnp.array([1, 2, 3]), jnp.ones((3, 4)))
    JCheckpointer(str(tmp_path / "jnat"), {"s": js}).save(step=4)

    def port_table():
        return SparseTable(64, 4, updater="adagrad", lr=0.1, salt=3,
                           device=CPU)

    assert convert_checkpoint(
        str(tmp_path / "jnat"), str(tmp_path / "dcp"), {"s": port_table()},
        src_backend="native", dst_backend="orbax") == 4
    s2 = port_table()
    make_checkpointer(str(tmp_path / "dcp"), {"s": s2},
                      backend="orbax").restore()
    for k, v in js.state_dict().items():
        np.testing.assert_array_equal(s2.state_dict()[k], np.asarray(v))
    convert_checkpoint(str(tmp_path / "dcp"), str(tmp_path / "back"),
                       {"s": port_table()}, src_backend="orbax",
                       dst_backend="native")
    js2 = JSparse(64, 4, mesh8, updater="adagrad", lr=0.1, seed=1, salt=3)
    assert JCheckpointer(str(tmp_path / "back"), {"s": js2}).restore() == 4
    for k, v in js.state_dict().items():
        np.testing.assert_array_equal(np.asarray(js2.state_dict()[k]),
                                      np.asarray(v))
