"""``utils/comm_analysis.py`` of the port: collective traffic read off a
``torch.profiler`` capture, against the JAX package's HLO accounting.

The JAX package proves on compiled HLO that the sharded table's pull and
push move bytes sized by the batch, never by the table
(``tests/test_sharded_traffic.py``). The port launches its collectives
one by one, so its proof reads the ``c10d::*`` events of what ran: here
the same invariants hold on the port's range-sharded ``SparseTable`` over
two gloo ranks, summed over the group (each rank's all-to-all output
depends on where the hash sends its keys; the group's total does not); a
profiled ``CollectiveSSP`` sync launches exactly what ``SyncPlane.plan``
declares, on each wire; and the parser is held to hand-written captures
shaped as gloo and NCCL record them (the NCCL one as an H100 run of
PyTorch 2.11 wrote it), with the reference's report schema, kinds and
integer ``has_dim``.
"""

from __future__ import annotations

import warnings

import pytest

import torch_comm_analysis_ranks as ranks
from minips_tpu.utils import comm_analysis as jca
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.utils import comm_analysis as tca

N = 2
SMALL, LARGE = 1 << 12, 1 << 18   # 64x the capacity
BATCH = 384  # no multiple of it is a row count of either table
KIND = {"all_reduce": "all-reduce", "all_to_all": "all-to-all",
        "all_gather": "all-gather"}


@pytest.fixture(scope="module")
def table_traffic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("traffic"))
    return run_ranks(ranks.sparse_table_traffic, N,
                     (SMALL, LARGE), (BATCH, 4 * BATCH), root,
                     device="cpu", timeout=240.0)


def _total(per_rank, leg, slots, batch) -> int:
    return sum(b for r in per_rank for _, b, _ in r[leg][(slots, batch)])


@pytest.mark.parametrize("leg", ["pull", "push"])
def test_traffic_independent_of_table_size(table_traffic, leg):
    small = _total(table_traffic, leg, SMALL, BATCH)
    large = _total(table_traffic, leg, LARGE, BATCH)
    assert small == large > 0, (
        f"{leg} collectives grew with table size: {small} -> {large}")
    # batch-sized, nowhere near one table shard
    assert large < LARGE * ranks.DIM * 4 // N / 8


@pytest.mark.parametrize("leg", ["pull", "push"])
def test_traffic_linear_in_batch(table_traffic, leg):
    b1 = _total(table_traffic, leg, SMALL, BATCH)
    b4 = _total(table_traffic, leg, SMALL, 4 * BATCH)
    # the split-size exchange is a small constant term
    assert b1 * 3 < b4 <= b1 * 4 + 1024


def test_no_table_sized_collective_op(table_traffic):
    """The literal "did the exchange ship the table" check, on every op
    of every rank: no dim equals the table's or a shard's row count."""
    for r in table_traffic:
        for leg in ("pull", "push"):
            for (slots, _), ops in r[leg].items():
                assert ops, (leg, slots)
                for kind, _, dims in ops:
                    op = tca.CollectiveOp(kind, "", 0, dims)
                    assert kind == "all-to-all"
                    assert not op.has_dim(slots) and not op.has_dim(
                        slots // N), (leg, slots, dims)


@pytest.mark.parametrize("comm", ["float32", "bfloat16", "int8"])
def test_profiled_sync_equals_the_plan(tmp_path, comm):
    """What a ``CollectiveSSP`` sync launched, read off the capture, is
    what ``SyncPlane.plan`` declares: the same collectives in order, each
    with the same per-process result bytes, on every rank. 300 elements
    split 150 a rank, so the int8 codes' block padding shows."""
    got = run_ranks(ranks.cssp_sync_traffic, N, comm, 300, str(tmp_path),
                    device="cpu", timeout=120.0)
    for r in got:
        want = [(KIND[p["op"]], p["bytes"]) for p in r["plan"]]
        seen = [(o["kind"], o["bytes"]) for o in r["observed"]["ops"]]
        assert seen == want, (comm, seen, want)
        assert r["rounds"] == 1 and r["launches"] == len(want)
        assert r["bytes"] == r["observed"]["total_bytes"]


def _x(name, ts, dur, args=None, *, cat="cpu_op", pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args or {}}


def _nccl_capture() -> list:
    """Collectives as an NCCL group records them: the dispatcher event, a
    ``record_param_comms`` inside it (dtype, group size), the backend's
    annotation, and the kernel on the GPU's process."""
    ev = []
    t = 0.0
    for name, types, dims, dtype, group in (
            ("c10d::allreduce_", ["TensorList", "", "", "", "Scalar"],
             [[[1000, 3]], [], [], [], []], "Float", 2),
            ("c10d::allreduce_", ["TensorList", "", "", "", "Scalar"],
             [[[500]], [], [], [], []], "BFloat16", 2),
            ("c10d::allgather_", ["", "TensorList", "", "Scalar"],
             [[], [[8, 4]], [], []], "Char", 4),
            ("c10d::alltoall_base_", ["float", "float", "", "ScalarList"],
             [[3, 2], [3, 2], [], []], "Float", 2)):
        ev.append(_x(name, t, 50.0, {"Input type": types,
                                     "Input Dims": dims}))
        ev.append(_x("record_param_comms", t + 5, 40.0,
                     {"dtype": dtype, "Group size": group}))
        ev.append(_x("nccl:" + name.split("::")[1].strip("_"), t + 10, 30.0,
                     {"Input type": ["float"], "Input Dims": [[1]]},
                     cat="user_annotation"))
        ev.append(_x("ncclDevKernel_Generic", t + 20, 5.0, {},
                     cat="kernel", pid=0, tid=7))
        t += 100.0
    return ev


def test_parser_on_an_nccl_capture():
    """Counted once each (not at the annotation or the kernel); a tensor
    list's dtype and a list all-gather's group size from the nested
    ``record_param_comms``; an all-to-all's output from its own typed
    argument."""
    ops = tca.collective_ops(_nccl_capture())
    assert [(o.kind, o.shape, o.bytes) for o in ops] == [
        ("all-reduce", "f32[1000,3]", 12000),
        ("all-reduce", "bf16[500]", 1000),
        ("all-gather", "s8[4,8,4]", 128),
        ("all-to-all", "f32[3,2]", 24)]
    rep = tca.traffic_report(_nccl_capture())
    assert rep["total_bytes"] == sum(o["bytes"] for o in rep["ops"])
    assert set(rep) == {"total_bytes", "ops"}
    assert all(set(o) == {"kind", "shape", "bytes"} for o in rep["ops"])
    assert all(o["kind"] in jca._COLLECTIVES for o in rep["ops"])
    assert tca._COLLECTIVES == jca._COLLECTIVES
    assert tca.collective_bytes(_nccl_capture()) == rep["total_bytes"]


def test_parser_on_a_gloo_capture():
    """gloo records no ``record_param_comms``: a tensor list's dtype comes
    from the backend's annotation of the same kind and input shape (which
    runs on a worker thread), the group size from ``world``; a ring step
    counts its receive, not its send; barriers and broadcasts are not
    counted."""
    tl = ["TensorList", "", "", "Scalar"]
    ev = [
        _x("c10d::allreduce_", 0, 20, {"Input type": tl,
                                       "Input Dims": [[[5]], [], [], []]}),
        _x("c10d::allgather_", 100, 20, {
            "Input type": ["", "TensorList", "", "Scalar"],
            "Input Dims": [[], [[10, 3]], [], []]}),
        _x("c10d::send", 200, 20, {"Input type": tl,
                                   "Input Dims": [[[7]], [], [], []]}),
        _x("c10d::recv_", 300, 20, {"Input type": tl,
                                    "Input Dims": [[[7]], [], [], []]}),
        _x("c10d::broadcast_", 400, 20, {"Input type": tl,
                                         "Input Dims": [[[2]], [], [], []]}),
        _x("c10d::barrier", 500, 20, {}),
        # annotations on the gloo worker thread, out of launch order
        _x("gloo:all_gather", 110, 50, {"Input type": ["float"],
                                        "Input Dims": [[10, 3]]}, tid=9),
        _x("gloo:all_reduce", 5, 50, {"Input type": ["c10::BFloat16"],
                                      "Input Dims": [[5]]}, tid=9),
        _x("gloo:send", 205, 5, {"Input type": ["float"],
                                 "Input Dims": [[7]]}, tid=9),
        _x("gloo:recv", 305, 5, {"Input type": ["float"],
                                 "Input Dims": [[7]]}, tid=9),
    ]
    ops = tca.collective_ops(ev, world=3)
    assert [(o.kind, o.shape, o.bytes) for o in ops] == [
        ("all-reduce", "bf16[5]", 10),
        ("all-gather", "f32[3,10,3]", 360),
        ("collective-permute", "f32[7]", 28)]
    with pytest.raises(ValueError, match="world="):
        tca.collective_ops(ev)


def test_unknown_dtype_is_conservative_and_has_dim_is_integer_exact():
    ev = [_x("c10d::allreduce_", 0, 10, {
        "Input type": ["TensorList"], "Input Dims": [[[163840]]]})]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        (op,) = tca.collective_ops(ev)
    assert op.bytes == 163840 * 16  # >= the widest known type
    assert any("no dtype recorded" in str(x.message) for x in w)
    # 16384 as a dim must not match [163840] (the substring trap), in
    # both packages
    (jop,) = jca.collective_ops("%a = f32[163840]{0} all-reduce(%x)")
    for o in (op, jop):
        assert not o.has_dim(16384) and o.has_dim(163840)


def test_reads_a_real_capture_file(tmp_path):
    """A capture written by ``utils/profiling.py`` on one gloo rank, read
    back by path and by directory."""
    got = run_ranks(ranks.cssp_sync_traffic, 1, "float32", 64,
                    str(tmp_path), device="cpu", timeout=120.0)[0]
    want = got["plan"][0]["bytes"]
    assert want == 4 * 65  # the weights and the bias, unpadded at one
    assert [o["kind"] for o in got["observed"]["ops"]] == ["all-reduce"]
    assert got["observed"]["total_bytes"] == want
    files = list((tmp_path / "sync-float32-r0").glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    assert tca.collective_bytes(str(files[0])) == want
