"""The port's dynamic data-block assigner (``data/blocks.py``), held
against the JAX package's.

- Every drill of ``tests/test_blocks.py`` runs on the port
  (``port_drills``): the splitters, the local assigner's exactly-once
  and re-queue, static batch shapes across blocks, and the master and
  client over the loopback bus with retries, idempotent re-requests and
  the timeout.
- Both packages split rows and files into the same blocks, read the same
  lines back, batch the same rows and walk the same local assignment.
- One mesh, both packages: a port ``BlockClient`` drains a JAX
  ``BlockMaster`` beside a JAX client (and the other way round), every
  block exactly once, and the master re-serves a dead worker's block.

The launched drills of ``tests/test_blocks_multiproc.py`` run on the
port in ``tests/test_torch_blocks_multiproc.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from minips_tpu.data import blocks as jblocks
from minips_tpu_torch.data import blocks
from tests.torch_comm_util import close_all, mixed_buses
from tests.torch_ref_drills import port_drills

globals().update(port_drills("test_blocks.py"))

PKG = {"port": blocks, "ref": jblocks}


def test_splitters_and_batches_match_reference(tmp_path):
    for n, size in ((103, 25), (1, 7), (64, 64), (1000, 3)):
        assert blocks.split_rows(n, size) == jblocks.split_rows(n, size)
    rng = np.random.default_rng(18)
    lines = [bytes(rng.integers(97, 123, size=int(rng.integers(0, 30)))
                   .astype(np.uint8)) for _ in range(83)]
    path = str(tmp_path / "d.txt")
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    for per in (1, 9, 40, 200):
        got = blocks.split_file_lines(path, per)
        assert got == jblocks.split_file_lines(path, per)
        for b in got:
            assert blocks.read_block_lines(b) == jblocks.read_block_lines(b)
            assert blocks.read_block_bytes(b) == jblocks.read_block_bytes(b)

    def parse(block):
        return {"x": np.arange(block["start"], block["end"])}

    rows = blocks.split_rows(70, 16)
    for drop in (True, False):
        a = list(blocks.iter_block_batches(iter(rows), parse, 32,
                                           drop_last=drop))
        b = list(jblocks.iter_block_batches(iter(rows), parse, 32,
                                            drop_last=drop))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["x"], y["x"])


def test_local_assigner_matches_reference():
    rng = np.random.default_rng(19)
    asg = [m.LocalBlockAssigner(m.split_rows(400, 7)) for m in PKG.values()]
    for _ in range(300):
        op, w = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        outs = []
        for a in asg:
            if op <= 1:
                outs.append(a.next_block(w))
            elif op == 2:
                outs.append(a.requeue_worker(w))
            outs.append((a.remaining, a.outstanding_total))
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]


@pytest.mark.parametrize("master,kinds", [
    ("ref", ["ref", "port", "ref"]), ("port", ["port", "ref", "port"])])
def test_clients_of_both_packages_drain_one_master(master, kinds):
    buses = mixed_buses(kinds, handshake=False)
    try:
        m = PKG[master].BlockMaster(buses[0], PKG[master].split_rows(160, 10))
        clients = [PKG[kinds[0]].BlockClient(buses[0], local_master=m)] + [
            PKG[k].BlockClient(buses[i]) for i, k in enumerate(kinds)
            if i]
        got: dict = {i: [] for i in range(3)}

        def drain(i):
            for b in clients[i]:
                got[i].append(b["id"])
                time.sleep(0.02)

        ths = [threading.Thread(target=drain, args=(i,)) for i in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30.0)
        assert sorted(i for ids in got.values() for i in ids) \
            == list(range(16))
        assert got[1] and got[2]  # both packages' remote clients worked
        assert m.assigner.remaining == 0
    finally:
        close_all(buses)


@pytest.mark.parametrize("master,worker", [("ref", "port"), ("port", "ref")])
def test_master_requeues_the_other_package_dead_worker(master, worker):
    buses = mixed_buses([master, worker], handshake=False)
    try:
        m = PKG[master].BlockMaster(buses[0], PKG[master].split_rows(20, 10))
        held = PKG[worker].BlockClient(buses[1]).next_block()
        assert held is not None
        assert m.handle_failure(1) == 1
        local = PKG[master].BlockClient(buses[0], local_master=m)
        ids = []
        while (nb := local.next_block()) is not None:
            ids.append(nb["id"])
            local.done(nb)
        assert held["id"] in ids  # the dead worker's block, re-served
    finally:
        close_all(buses)
