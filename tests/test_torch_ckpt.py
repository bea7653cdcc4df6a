"""The port's native checkpointer (``ckpt/checkpoint.py``, ``ckpt``'s
``make_checkpointer``) and its agreement with the JAX package's.

Every comparison is exact: a checkpoint stores host copies, so a restore
gives the saved state bit for bit, and later identical pushes on the CPU
repeat their arithmetic. A SparseTable checkpoint written by either
package holds the same npz keys and arrays (and the same manifest), and
each package restores the other's.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.ckpt.checkpoint import Checkpointer as JCheckpointer
from minips_tpu.tables.sparse import SparseTable as JSparse
from minips_tpu_torch import interop
from minips_tpu_torch.ckpt import make_checkpointer
from minips_tpu_torch.ckpt.checkpoint import (Checkpointer, _flatten,
                                              _unflatten)
from minips_tpu_torch.consistency import SSP
from minips_tpu_torch.core.config import TableConfig
from minips_tpu_torch.core.engine import Engine
from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.tables.sparse import SparseTable

CPU = "cpu"


def _trained(updater="adam", sparse_updater="adagrad"):
    dense = DenseTable({"w": torch.zeros(8)}, updater=updater, lr=0.1,
                       device=CPU)
    sparse = SparseTable(64, 4, updater=sparse_updater, lr=0.1, seed=7,
                         device=CPU)
    for _ in range(3):
        dense.push({"w": torch.arange(8.0)})
        sparse.push(torch.tensor([1, 2, 3]), torch.ones(3, 4))
    return dense, sparse


def _same_state(a, b):
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        if isinstance(x, list):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


def test_flatten_unflatten_roundtrip():
    tree = {"a": {"b": np.arange(3)}, "c": [np.ones(2), {"d": np.zeros(1)}],
            "e": None, "empty": []}
    back = _unflatten(_flatten(tree))
    assert back["e"] is None and "empty" not in back
    np.testing.assert_array_equal(back["a"]["b"], np.arange(3))
    np.testing.assert_array_equal(back["c"][0], np.ones(2))
    np.testing.assert_array_equal(back["c"][1]["d"], np.zeros(1))


@pytest.mark.parametrize("updater", ["adam", "adagrad", "sgd", "adam_bf16",
                                     "adam8"])
def test_roundtrip_resumes_identically(tmp_path, updater):
    d1, s1 = _trained(updater)
    Checkpointer(str(tmp_path), {"d": d1, "s": s1}).save(step=3)
    d2, s2 = _trained(updater)
    d2.push({"w": torch.ones(8) * 100})  # diverge: restore must overwrite
    s2.push(torch.tensor([5]), torch.ones(1, 4))
    assert Checkpointer(str(tmp_path), {"d": d2, "s": s2}).restore() == 3
    _same_state(d2, d1)
    _same_state(s2, s1)
    for d, s in ((d1, s1), (d2, s2)):
        d.push({"w": torch.arange(8.0)})
        s.push(torch.tensor([2, 3]), torch.ones(2, 4))
    _same_state(d2, d1)
    _same_state(s2, s1)
    if updater == "sgd":  # no opt-state leaves: no 'opt_state' key at all
        with np.load(tmp_path / "step_0000000003" / "d.npz") as z:
            assert sorted(z.files) == ["params"]


def test_updater_mismatch_rejected(tmp_path):
    d1, _ = _trained("adam")
    Checkpointer(str(tmp_path), {"d": d1}).save(step=1)
    d2 = DenseTable({"w": torch.zeros(8)}, updater="adagrad", lr=0.1,
                    device=CPU)
    with pytest.raises(ValueError, match="leaf count"):
        Checkpointer(str(tmp_path), {"d": d2}).restore(step=1)
    _, s1 = _trained()
    Checkpointer(str(tmp_path), {"s": s1}).save(step=2)
    s2 = SparseTable(64, 4, updater="adam", device=CPU)
    with pytest.raises(ValueError, match="optimizer state"):
        Checkpointer(str(tmp_path), {"s": s2}).restore(step=2)


def test_retention_and_prune(tmp_path):
    d, s = _trained()
    ck = Checkpointer(str(tmp_path), {"d": d, "s": s}, keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step=step)
    assert ck.list_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert ck.prune_above(3) == [4] and ck.list_steps() == [3]
    keep_all = Checkpointer(str(tmp_path / "all"), {"d": d}, keep=0)
    for step in (1, 2, 3, 4):
        keep_all.save(step=step)
    assert keep_all.list_steps() == [1, 2, 3, 4]


def test_torn_checkpoint_walks_back(tmp_path, capsys):
    d, s = _trained()
    ck = Checkpointer(str(tmp_path), {"d": d, "s": s}, keep=5)
    states = {}
    for step in (1, 2, 3):
        d.push({"w": torch.full((8,), float(step))})
        ck.save(step=step)
        states[step] = d.state_dict()["params"]
    # a truncated npz in the newest step
    path = tmp_path / "step_0000000003" / "s.npz"
    path.write_bytes(path.read_bytes()[:40])
    d2, s2 = _trained()
    assert Checkpointer(str(tmp_path), {"d": d2, "s": s2}).restore() == 2
    np.testing.assert_array_equal(d2.state_dict()["params"], states[2])
    assert "skipping torn checkpoint" in capsys.readouterr().err
    # an explicit step stays strict
    with pytest.raises(Exception):
        Checkpointer(str(tmp_path), {"d": d2, "s": s2}).restore(step=3)
    # a corrupt manifest on the next: walk back twice
    (tmp_path / "step_0000000002" / "manifest.json").write_text("{tor")
    d3, s3 = _trained()
    assert Checkpointer(str(tmp_path), {"d": d3, "s": s3}).restore() == 1
    np.testing.assert_array_equal(d3.state_dict()["params"], states[1])
    # a missing table file is a torn checkpoint too
    os.remove(tmp_path / "step_0000000001" / "d.npz")
    with pytest.raises(FileNotFoundError, match="every candidate"):
        Checkpointer(str(tmp_path), {"d": d3, "s": s3}).restore()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Checkpointer(str(tmp_path / "none"), {"d": d3}).restore()


def test_sparse_layout_mismatch_refused_but_salt_ignored_on_identity(
        tmp_path):
    t = SparseTable(64, 2, identity=True, salt=0, device=CPU)
    Checkpointer(str(tmp_path), {"s": t}).save(step=1)
    # the identity path never reads the salt: a differing salt restores
    t2 = SparseTable(64, 2, identity=True, salt=7, device=CPU)
    Checkpointer(str(tmp_path), {"s": t2}).restore()
    # hashed against identity is a real layout change
    t3 = SparseTable(64, 2, identity=False, device=CPU)
    with pytest.raises(ValueError, match="layout"):
        Checkpointer(str(tmp_path), {"s": t3}).restore()
    # a state without a layout record restores only into the default
    # hashed layout
    legacy = {k: v for k, v in SparseTable(64, 2, salt=3, device=CPU)
              .state_dict().items() if k != "layout"}
    np.savez(tmp_path / "step_0000000001" / "s.npz", **legacy)
    with pytest.raises(ValueError, match="no layout record"):
        Checkpointer(str(tmp_path), {
            "s": SparseTable(64, 2, salt=3, device=CPU)}).restore()
    Checkpointer(str(tmp_path), {
        "s": SparseTable(64, 2, salt=0, device=CPU)}).restore()


def test_async_save_writes_the_state_at_the_call(tmp_path):
    d, s = _trained()
    want_d, want_s = d.state_dict(), s.state_dict()
    ck = Checkpointer(str(tmp_path), {"d": d, "s": s}, async_save=True)
    ck.save(step=5)
    # training goes on while the thread writes: the checkpoint still holds
    # the state at the save() call
    for _ in range(3):
        d.push({"w": torch.ones(8)})
        s.push(torch.tensor([1, 2]), torch.ones(2, 4))
    ck.save(step=6)  # waits for the first save, then starts its own
    ck.close()
    assert ck._thread is None and ck.list_steps() == [5, 6]
    d2, s2 = _trained()
    Checkpointer(str(tmp_path), {"d": d2, "s": s2}).restore(step=5)
    np.testing.assert_array_equal(d2.state_dict()["params"],
                                  want_d["params"])
    np.testing.assert_array_equal(s2.state_dict()["emb"], want_s["emb"])
    np.testing.assert_array_equal(s2.state_dict()["accum"],
                                  want_s["accum"])


def test_make_checkpointer_backends(tmp_path, monkeypatch):
    d, _ = _trained()
    ck = make_checkpointer(str(tmp_path), {"d": d}, keep=1)
    assert type(ck) is Checkpointer and ck.keep == 1
    monkeypatch.setenv("MINIPS_CKPT_BACKEND", "native")
    assert type(make_checkpointer(str(tmp_path), {"d": d})) is Checkpointer
    monkeypatch.setenv("MINIPS_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="item 16"):
        make_checkpointer(str(tmp_path), {"d": d})
    with pytest.raises(NotImplementedError, match="item 16"):
        make_checkpointer(str(tmp_path), {"d": d}, backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        make_checkpointer(str(tmp_path), {"d": d}, backend="zarr")


def test_engine_checkpoint_restores_tables_and_clocks(tmp_path):
    def engine():
        e = Engine(num_workers=2, device=CPU).start_everything()
        e.create_table(TableConfig(name="w", kind="dense",
                                   consistency="ssp", staleness=2,
                                   updater="adagrad", lr=0.1),
                       template={"w": torch.zeros(4)})
        return e

    e1 = engine()
    assert isinstance(e1.controllers["w"], SSP)
    e1.tables["w"].push({"w": torch.ones(4)})
    for w in (0, 0, 1):
        e1.controllers["w"].clock(w)
    e1.make_checkpointer(str(tmp_path)).save(step=3)
    e2 = engine()
    assert e2.make_checkpointer(str(tmp_path)).restore() == 3
    _same_state(e2.tables["w"], e1.tables["w"])
    assert (e2.controllers["w"].tracker.snapshot()
            == e1.controllers["w"].tracker.snapshot() == [2, 1])


@pytest.mark.parametrize("updater, salt, identity", [
    ("adagrad", 3, False), ("sgd", 0, True), ("adam", 1, False)])
def test_sparse_checkpoint_files_match_jax(mesh8, tmp_path, updater, salt,
                                           identity):
    """The same SparseTable state written by each package's Checkpointer:
    the same npz keys, dtypes and arrays and the same manifest; each
    package restores the other's checkpoint."""
    jt = JSparse(128, 9, mesh8, updater=updater, lr=0.1, salt=salt,
                 identity=identity, seed=4)
    if updater != "adam":  # the JAX table's donating push: ROADMAP.md
        jt.push(jnp.arange(0, 40, 3), jnp.ones((14, 9)))
    tt = SparseTable(128, 9, updater=updater, lr=0.1, salt=salt,
                     identity=identity, device=CPU)
    interop.load_sparse(tt, jt.state_dict())
    JCheckpointer(str(tmp_path / "jax"), {"s": jt}).save(step=2)
    Checkpointer(str(tmp_path / "port"), {"s": tt}).save(step=2)
    step = "step_0000000002"
    with np.load(tmp_path / "jax" / step / "s.npz") as zj, \
            np.load(tmp_path / "port" / step / "s.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            np.testing.assert_array_equal(zj[k], zt[k])
    manifests = [json.loads((tmp_path / p / step / "manifest.json")
                            .read_text()) for p in ("jax", "port")]
    assert manifests[0] == manifests[1]
    # each restores the other's
    back = SparseTable(128, 9, updater=updater, lr=0.1, salt=salt,
                       identity=identity, seed=9, device=CPU)
    assert Checkpointer(str(tmp_path / "jax"), {"s": back}).restore() == 2
    _same_state(back, tt)
    jback = JSparse(128, 9, mesh8, updater=updater, lr=0.1, salt=salt,
                    identity=identity, seed=9)
    assert JCheckpointer(str(tmp_path / "port"), {"s": jback}).restore() == 2
    for k, v in jt.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jback.state_dict()[k]), v)
