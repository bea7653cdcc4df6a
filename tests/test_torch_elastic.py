"""Elastic resume — the port's ``ckpt/elastic.py`` held against the JAX
package's on the same shard files.

Each package writes rank-local shard checkpoints the other reads: files
handcrafted in the ``Checkpointer`` layout, and files that each package's
own ``Checkpointer`` writes from live ``ShardedTable`` shards. Reshards,
the layout filter, the elastic and live step scans, the overlay-aware
restore and ``NpzSliceReader`` must give identical arrays (exact
equality: the reshard is slicing, no arithmetic). The launched drill
trains Wide&Deep on 3 CPU-pinned ranks with shard checkpoints and resumes
it on 2.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from minips_tpu.ckpt import checkpoint as jckpt
from minips_tpu.ckpt import elastic as jelastic
from minips_tpu.train import sharded_ps as jsp
from minips_tpu_torch import launch
from minips_tpu_torch.ckpt import checkpoint as ckpt
from minips_tpu_torch.ckpt import elastic
from minips_tpu_torch.train import sharded_ps as sp


class _FakeTable:
    """Just enough surface for the elastic helpers: partition geometry."""

    def __init__(self, num_rows: int, nprocs: int, rank: int):
        class _P:
            shard_size = -(-num_rows // nprocs)

        self.num_rows = num_rows
        self.part = _P()
        self.shard_lo = rank * _P.shard_size


def _write_step(ckdir, rank, step, name, num_rows, nprocs, *, value_of,
                extra=None):
    """One rank's shard file in the Checkpointer's on-disk layout, rows
    carrying ``value_of(global_row)``."""
    sz = -(-num_rows // nprocs)
    lo = rank * sz
    d = os.path.join(ckdir, f"rank{rank}", f"step_{step:010d}")
    os.makedirs(d, exist_ok=True)
    w = np.zeros((sz, 2), np.float32)
    for i in range(max(0, min(num_rows - lo, sz))):
        w[i] = value_of(lo + i)
    state = {"w": w, "lo": np.asarray(lo)}
    if extra:
        state.update(extra)
    np.savez(os.path.join(d, f"{name}.npz"), **state)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": step, "tables": [name], "clocks": {}}, f)


def _write_world(ck, step, table, moments, old_n, name="w"):
    rows = table.shape[0]
    old_sz = -(-rows // old_n)
    for r in range(old_n):
        lo = r * old_sz
        m = np.zeros((old_sz, 2), np.float32)
        valid = max(0, min(rows - lo, old_sz))
        m[:valid] = moments[lo:lo + valid]
        _write_step(ck, r, step, name, rows, old_n,
                    value_of=lambda g: table[g], extra={"m": m})


def _reshard_both(ck, step, old_n, name, rows, lo, sz):
    got = elastic.reshard_table_state(ck, step, old_n, name, rows, lo, sz)
    want = jelastic.reshard_table_state(ck, step, old_n, name, rows, lo, sz)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.mark.parametrize("old_n,new_n", [(3, 2), (2, 3), (3, 4), (1, 3)])
def test_reshard_matches_reference_and_repads(tmp_path, old_n, new_n):
    """Every new row carries its global row's value, for the params and a
    row-aligned optimizer leaf; padding rows are zero."""
    ck, rows = str(tmp_path), 10
    rng = np.random.default_rng(old_n * 10 + new_n)
    table = rng.normal(size=(rows, 2)).astype(np.float32)
    moments = rng.normal(size=(rows, 2)).astype(np.float32)
    _write_world(ck, 5, table, moments, old_n)
    new_sz = -(-rows // new_n)
    for r in range(new_n):
        st = _reshard_both(ck, 5, old_n, "w", rows, r * new_sz, new_sz)
        assert int(st["lo"]) == r * new_sz
        valid = max(0, min(rows - r * new_sz, new_sz))
        np.testing.assert_array_equal(st["w"][:valid],
                                      table[r * new_sz:r * new_sz + valid])
        np.testing.assert_array_equal(
            st["m"][:valid], moments[r * new_sz:r * new_sz + valid])
        assert not st["w"][valid:].any() and not st["m"][valid:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reshard_roundtrip_property(tmp_path, seed):
    """For seeded (rows, N, M), saving a random table as N shards and
    resharding to M reassembles the original table exactly in both
    packages."""
    rng = np.random.default_rng(seed)
    for case in range(8):
        rows = int(rng.integers(1, 61))
        old_n, new_n = int(rng.integers(1, 7)), int(rng.integers(1, 7))
        ck = str(tmp_path / f"c{case}")
        table = rng.normal(size=(rows, 2)).astype(np.float32)
        moments = rng.normal(size=(rows, 2)).astype(np.float32)
        _write_world(ck, 3, table, moments, old_n)
        new_sz = -(-rows // new_n)
        got_w = np.zeros((rows, 2), np.float32)
        got_m = np.zeros((rows, 2), np.float32)
        for r in range(new_n):
            st = _reshard_both(ck, 3, old_n, "w", rows, r * new_sz, new_sz)
            assert st["w"].shape == (new_sz, 2)
            valid = max(0, min(rows - r * new_sz, new_sz))
            assert not st["w"][valid:].any() and not st["m"][valid:].any()
            got_w[r * new_sz:r * new_sz + valid] = st["w"][:valid]
            got_m[r * new_sz:r * new_sz + valid] = st["m"][:valid]
        np.testing.assert_array_equal(got_w, table)
        np.testing.assert_array_equal(got_m, moments)


def test_layout_filter_and_elastic_scan_match_reference(tmp_path):
    ck, rows = str(tmp_path), 12
    for r in range(3):
        _write_step(ck, r, 5, "w", rows, 3, value_of=lambda g: g)
    for r in (0, 2):  # step 9 is torn: rank 1 lost it
        _write_step(ck, r, 9, "w", rows, 3, value_of=lambda g: g)
    t2 = {"w": _FakeTable(rows, 2, 1)}
    for mod in (elastic, jelastic):
        assert not mod.step_matches_layout(os.path.join(ck, "rank1"), 5, t2)
        assert mod.find_elastic_step(ck, t2) == (5, 3)
    # mixed layouts at one step number: ranks 0-1 republish step 5 under
    # a 2-world partition; k=2 now fits at step 5, k=3 no longer does
    for r in range(2):
        _write_step(ck, r, 5, "w", rows, 2, value_of=lambda g: 50 + g)
    assert elastic.find_elastic_step(ck, t2) \
        == jelastic.find_elastic_step(ck, t2) == (5, 2)
    st = _reshard_both(ck, 5, 2, "w", rows, 0, 4)
    assert st["w"][0, 0] == 50


def test_reshard_all_padding_shard(tmp_path):
    ck, rows = str(tmp_path), 9
    for r in range(3):
        _write_step(ck, r, 7, "w", rows, 3, value_of=lambda g: g,
                    extra={"m": np.ones((3, 2), np.float32)})
    st = _reshard_both(ck, 7, 3, "w", rows, 9, 3)  # rank 3 of 4: padding
    assert int(st["lo"]) == 9
    assert st["w"].shape == (3, 2) and not st["w"].any()
    assert st["m"].shape == (3, 2) and not st["m"].any()


def test_reshard_refuses_a_leaf_it_cannot_place(tmp_path):
    """A leaf that is neither row-aligned nor identical across the old
    shards is refused with ValueError (a real raise, not an assert, so
    ``python -O`` keeps it) in both packages."""
    ck, rows = str(tmp_path), 8
    for r in range(2):
        _write_step(ck, r, 4, "w", rows, 2, value_of=lambda g: g,
                    extra={"odd": np.full((3,), float(r), np.float32)})
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError, match="neither row-aligned"):
            mod.reshard_table_state(ck, 4, 2, "w", rows, 0, 8)
    # identical across shards: passed through unchanged
    for r in range(2):
        _write_step(ck, r, 6, "w", rows, 2, value_of=lambda g: g,
                    extra={"same": np.arange(3, dtype=np.float32)})
    st = _reshard_both(ck, 6, 2, "w", rows, 0, 8)
    np.testing.assert_array_equal(st["same"], np.arange(3))


def _write_rebalanced_world(ck, step, table_vals, moments, old_n, blk,
                            overlay):
    """A rebalanced world's shard files: each overlay block's live rows in
    its owner's ``xtra/<b>/...`` section, the home slab a dead copy."""
    rows = table_vals.shape[0]
    old_sz = -(-rows // old_n)
    bps = -(-old_sz // blk)
    meta = {"ep": np.asarray(3), "rb_block": np.asarray(blk),
            "ovb": np.asarray(sorted(overlay), np.int64),
            "ovo": np.asarray([overlay[b] for b in sorted(overlay)],
                              np.int64)}
    for r in range(old_n):
        lo = r * old_sz
        w = np.zeros((old_sz, 2), np.float32)
        m = np.zeros((old_sz, 2), np.float32)
        valid = max(0, min(rows - lo, old_sz))
        w[:valid] = table_vals[lo:lo + valid]
        m[:valid] = moments[lo:lo + valid]
        extra = dict(meta, m=m)
        for b, o in overlay.items():
            shard, loc = divmod(b, bps)
            blo = shard * old_sz + loc * blk
            bln = min(blk, old_sz - loc * blk)
            if shard == r:
                w[loc * blk:loc * blk + bln] = -777.0
            if o == r:
                v = max(0, min(rows - blo, bln))
                bv = np.zeros((bln, 2), np.float32)
                bm = np.zeros((bln, 2), np.float32)
                bv[:v] = table_vals[blo:blo + v]
                bm[:v] = moments[blo:blo + v]
                extra[f"xtra/{b}/w"] = bv
                extra[f"xtra/{b}/m"] = bm
        _write_step(ck, r, step, "w", rows, old_n, value_of=lambda g: 0.0,
                    extra={"w": w, **extra})


def test_reshard_through_overlay_and_block_state(tmp_path):
    """A checkpoint saved mid-rebalance at 3 ranks reshards to 2 and 4
    with every row equal to the unmigrated oracle in both packages, and
    a block's state reads from wherever the saved overlay parked it."""
    ck, rows, old_n, blk = str(tmp_path), 24, 3, 2
    rng = np.random.default_rng(11)
    oracle_w = rng.normal(size=(rows, 2)).astype(np.float32)
    oracle_m = rng.normal(size=(rows, 2)).astype(np.float32)
    _write_rebalanced_world(ck, 5, oracle_w, oracle_m, old_n, blk,
                            overlay={0: 2, 9: 1})
    for new_n in (2, 4):
        new_sz = -(-rows // new_n)
        got_w = np.zeros((rows, 2), np.float32)
        for r in range(new_n):
            st = _reshard_both(ck, 5, old_n, "w", rows, r * new_sz, new_sz)
            assert not ({"ep", "ovb", "ovo", "rb_block"} & set(st))
            valid = max(0, min(rows - r * new_sz, new_sz))
            got_w[r * new_sz:r * new_sz + valid] = st["w"][:valid]
        np.testing.assert_array_equal(got_w, oracle_w)
    for args in [(0, 0, 2, 0, 8, blk), (5, 10, 2, 1, 8, blk)]:
        st = elastic.load_block_state(ck, 5, "w", *args)
        want = jelastic.load_block_state(ck, 5, "w", *args)
        for k in want:
            np.testing.assert_array_equal(st[k], want[k])
    np.testing.assert_array_equal(
        elastic.load_block_state(ck, 5, "w", 0, 0, 2, 0, 8, blk)["m"],
        oracle_m[:2])
    with pytest.raises(ValueError, match="granularity"):
        elastic.load_block_state(ck, 5, "w", 0, 0, 4, 0, 8, 4)


def test_find_live_step_matches_reference(tmp_path):
    ck, rows = str(tmp_path), 12
    for r in range(3):
        _write_step(ck, r, 5, "w", rows, 3, value_of=lambda g: g)
        _write_step(ck, r, 10, "w", rows, 3, value_of=lambda g: g)
    for r in range(2):  # step 12 torn
        _write_step(ck, r, 12, "w", rows, 3, value_of=lambda g: g)
    t3 = {"w": _FakeTable(rows, 3, 0)}
    t2 = {"w": _FakeTable(rows, 2, 0)}
    for args, want in [((ck, t3, 3), 10), ((ck, t2, 2), None),
                       ((str(tmp_path / "empty"), t3, 3), None)]:
        assert elastic.find_live_step(*args) \
            == jelastic.find_live_step(*args) == want
    assert elastic.find_live_step(ck, t3, 3, required={0, 1, 2, 3}) == 10


def test_npz_slice_reader_matches_reference(tmp_path):
    path = str(tmp_path / "s.npz")
    rng = np.random.default_rng(4)
    arrays = {"w": rng.normal(size=(37, 5)).astype(np.float32),
              "steps": np.arange(37, dtype=np.int32),
              "lo": np.asarray(74)}
    np.savez(path, **arrays)
    with elastic.NpzSliceReader(path) as r, \
            jelastic.NpzSliceReader(path) as j:
        assert sorted(r.keys()) == sorted(j.keys())
        for k in ("w", "steps"):
            assert r.shape(k) == j.shape(k) and r.dtype(k) == j.dtype(k)
            for a, b in [(0, 37), (3, 9), (36, 37), (5, 5)]:
                np.testing.assert_array_equal(r.read_rows(k, a, b),
                                              arrays[k][a:b])
                np.testing.assert_array_equal(r.read_rows(k, a, b),
                                              j.read_rows(k, a, b))
        assert int(r.read("lo")) == 74


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpointer_shards_reshard_across_packages(tmp_path, writer):
    """Live shards of a 3-process adam table, saved by one package's
    ``Checkpointer`` (one directory per rank), reshard to 2 identically
    in both packages, and each new shard loads into the port's table."""
    rows, ck = 21, str(tmp_path)
    mod, ck_mod = (sp, ckpt) if writer == "port" else (jsp, jckpt)
    rng = np.random.default_rng(6)
    for r in range(3):
        t = mod.ShardedTable("w", rows, 3, None, r, 3, updater="adam",
                             init_scale=0.1, seed=2)
        t._apply_rows(rng.integers(0, t.part.shard_size, size=9),
                      rng.normal(size=(9, 3)).astype(np.float32))
        ck_mod.Checkpointer(os.path.join(ck, f"rank{r}"), {"w": t}).save(4)
    tables = {"w": _FakeTable(rows, 2, 0)}
    assert elastic.find_elastic_step(ck, tables) == (4, 3)
    for r in range(2):
        t = sp.ShardedTable("w", rows, 3, None, r, 2, updater="adam")
        st = _reshard_both(ck, 4, 3, "w", rows, t.shard_lo,
                           t.part.shard_size)
        t.load_shard_state_dict(st)
        assert t._steps.sum() > 0


def test_wide_deep_resumes_elastically_from_3_to_2(tmp_path):
    """The flagship's three partitioned tables (hashed wide and emb, the
    dense deep tower) reshard 3 -> 2 through the generic path; training
    continues from the saved step with replica agreement and a live
    AUC."""
    ck = str(tmp_path / "wdck")
    base = ["--exec", "multiproc", "--consistency", "ssp", "--staleness",
            "2", "--num_slots", "16384", "--batch_size", "256",
            "--checkpoint_dir", ck, "--checkpoint_every", "5"]

    def run(n, iters):
        return launch.run_local_job(
            n, [sys.executable, "-m", "minips_tpu_torch.apps."
                "wide_deep_example"] + base + ["--num_iters", str(iters)],
            env_extra={"MINIPS_FORCE_CPU": "1", "OMP_NUM_THREADS": "1"},
            timeout=240.0)

    res3 = run(3, 10)
    assert all(r["event"] == "done" and r["clock"] == 10 for r in res3)
    res2 = run(2, 25)
    for r in res2:
        assert r["event"] == "done"
        assert r["resumed_from"] == 10, r
        assert r["clock"] == 25
        assert r["auc"] > 0.6, r["auc"]
    fps = [r["param_fingerprint"] for r in res2]
    assert max(fps) - min(fps) < 1e-4, fps
