"""Collective-traffic accounting from a profiler trace — the port of
``minips_tpu/utils/comm_analysis.py``.

The row-sharded embedding pull/push must not degrade to "all-gather the
table": the bytes a step communicates must scale with the *touched rows*
(the batch), never with the table's capacity (SURVEY.md §7.4.2 "sparse
push/pull at 1M samples/sec"). The reference has the same sparsity
property structurally — its Mailbox ships only the key/val slices for one
batch (SURVEY.md §3.3) — so this is a parity invariant, not just a perf
nicety.

The JAX package reads its proof off compiled HLO. PyTorch compiles
nothing: the port's collectives are launched one by one through
``torch.distributed``, and each launch passes through the dispatcher as a
``c10d::*`` operator, which ``torch.profiler`` records with its tensors'
shapes (``record_shapes=True``; ``utils/profiling.py`` sets it). This
module reads those events from a capture, so the proof is of what actually
ran, on any backend:

- each collective is counted once, at its dispatcher event, and not again
  at its backend's annotation (``gloo:*``, ``nccl:*``) or its NCCL kernel;
- ``bytes`` keeps the reference's meaning, the per-device result payload:
  an all-reduce its tensors, an all-gather the world's inputs, an
  all-to-all and a reduce-scatter their outputs, a ring step
  (``collective-permute``) what it receives — its ``send`` is the peer's
  receive and is not counted again;
- barriers and broadcasts carry no table data and are not collectives of
  the reference's kinds; they are not counted.

A dispatcher event names a list of tensors only by their shapes. Their
dtype then comes from the ``record_param_comms`` event that the backend
records inside it, or else from the backend's own annotation of the same
collective (same kind, same input shape); the size of the group, which a
list all-gather's result needs, from ``record_param_comms`` or else from
the caller's ``world``.
"""

from __future__ import annotations

import gzip
import json
import os
import warnings
from dataclasses import dataclass
from typing import Optional, Union

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "all-to-all",
    "reduce-scatter",
    "collective-permute",
)

# dispatcher op -> (kind, index of the argument that holds the result,
# whether that argument is the input that every rank of the group
# contributes to the result: a list all-gather's)
_C10D = {
    "c10d::allreduce_": ("all-reduce", 0, False),
    "c10d::allgather_": ("all-gather", 1, True),
    "c10d::_allgather_base_": ("all-gather", 0, False),
    "c10d::alltoall_base_": ("all-to-all", 0, False),
    "c10d::alltoall_": ("all-to-all", 0, False),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, False),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, False),
    "c10d::recv_": ("collective-permute", 0, False),
}

# the backends' annotations of each kind: "<backend>:<name>" (gloo runs a
# reduce-scatter as an all-reduce)
_ANNOTATIONS = {
    "all-reduce": ("all_reduce",),
    "all-gather": ("all_gather", "_allgather_base"),
    "all-to-all": ("all_to_all",),
    "reduce-scatter": ("reduce_scatter", "_reduce_scatter_base",
                       "all_reduce"),
    "collective-permute": ("recv",),
}

# dtype names as the profiler spells them (``Input type``: C++ type names;
# ``record_param_comms``' ``dtype``: c10 scalar-type names) -> (HLO name,
# bytes per element), the reference's spelling of a shape
_DTYPES = {}
for _names, _hlo, _size in (
        (("float", "Float"), "f32", 4),
        (("double", "Double"), "f64", 8),
        (("c10::Half", "Half"), "f16", 2),
        (("c10::BFloat16", "BFloat16"), "bf16", 2),
        (("signed char", "Char"), "s8", 1),
        (("unsigned char", "Byte"), "u8", 1),
        (("short int", "short", "Short"), "s16", 2),
        (("int", "Int"), "s32", 4),
        (("long int", "long", "long long", "Long"), "s64", 8),
        (("bool", "Bool"), "pred", 1),
        (("c10::Float8_e4m3fn", "Float8_e4m3fn"), "f8e4m3fn", 1),
        (("c10::Float8_e5m2", "Float8_e5m2"), "f8e5m2", 1),
        (("c10::complex<float>", "ComplexFloat"), "c64", 8),
        (("c10::complex<double>", "ComplexDouble"), "c128", 16)):
    for _n in _names:
        _DTYPES[_n] = (_hlo, _size)


@dataclass(frozen=True)
class CollectiveOp:
    """One cross-device collective a profiled run launched."""
    kind: str      # all-gather / all-reduce / ...
    shape: str     # e.g. "f32[1024,64]"
    bytes: int     # payload size of the result
    # the result's dims, one tuple per array — guards compare these as
    # INTEGERS (substring matching on `shape` false-positives, e.g. 16384
    # inside f32[163840])
    dims: tuple = ()

    def has_dim(self, n: int) -> bool:
        return any(n in d for d in self.dims)


Trace = Union[str, list]


def _events(trace: Trace) -> list[dict]:
    """Complete events of a trace given as events, a trace file
    (``.json`` or ``.json.gz``) or a directory (its newest capture)."""
    if not isinstance(trace, str):
        return [e for e in trace if e.get("ph") == "X"]
    path = trace
    if os.path.isdir(path):
        from minips_tpu_torch.utils.trace_analysis import latest_trace_file

        path = latest_trace_file(trace)
        if path is None:
            raise FileNotFoundError(f"no *.trace.json.gz under {trace}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def _tensors(args: dict, i: int) -> tuple[list[tuple], Optional[str]]:
    """(shapes, dtype name or None) of argument ``i`` of a recorded op: a
    tensor, or a list of tensors (whose dtype the profiler leaves out)."""
    types = args.get("Input type") or []
    dims = args.get("Input Dims") or []
    if i >= len(types) or i >= len(dims):
        return [], None
    if types[i] == "TensorList":
        return [tuple(d) for d in dims[i]], None
    if types[i] in _DTYPES:
        return [tuple(dims[i])], types[i]
    return [], None


def _inside(inner: dict, outer: dict) -> bool:
    """``inner`` ran within ``outer`` on the same thread."""
    t0, t1 = float(outer["ts"]), float(outer["ts"]) + float(
        outer.get("dur", 0.0))
    return (inner.get("pid") == outer.get("pid")
            and inner.get("tid") == outer.get("tid")
            and t0 <= float(inner["ts"]) <= t1)


def collective_ops(trace: Trace, *, world: Optional[int] = None
                   ) -> list[CollectiveOp]:
    """Every cross-device collective of a profiled run, in launch order,
    from its ``c10d::*`` dispatcher event (see the module docstring).
    ``world`` is the group's size, needed only for a list all-gather in a
    capture whose backend did not record it."""
    events = sorted(_events(trace), key=lambda e: float(e.get("ts", 0.0)))
    params = [e for e in events if e.get("name") == "record_param_comms"]
    notes = [e for e in events
             if e.get("name", "").startswith(("gloo:", "nccl:"))]
    used: set = set()
    ops: list[CollectiveOp] = []
    for e in events:
        spec = _C10D.get(e.get("name", ""))
        if spec is None or e.get("cat", "cpu_op") != "cpu_op":
            continue
        kind, arg, gathered = spec
        args = e.get("args") or {}
        shapes, dtype = _tensors(args, arg)
        inner = next((p for p in params if _inside(p, e)), None)
        inner_args = (inner or {}).get("args") or {}
        if dtype is None and inner_args.get("dtype") in _DTYPES:
            dtype = inner_args["dtype"]
        if dtype is None:
            dtype = _annotation_dtype(notes, used, e, kind, shapes)
        if gathered:
            n = inner_args.get("Group size") or world
            if n is None:
                raise ValueError(
                    f"{e['name']} at ts {e.get('ts')}: the capture does not "
                    "record the group's size; pass world=")
            shapes = [(int(n),) + s for s in shapes]
        ops.append(_op(kind, shapes, dtype))
    return ops


def _annotation_dtype(notes, used, e, kind, shapes) -> Optional[str]:
    """The dtype of a tensor-list collective from its backend's annotation:
    the first one not yet claimed, at or after the dispatcher event, of
    the same kind and input shape."""
    want = [list(s) for s in shapes[:1]]
    for j, a in enumerate(notes):
        if j in used or float(a["ts"]) < float(e["ts"]):
            continue
        name = a["name"].split(":", 1)[1]
        aa = a.get("args") or {}
        if (name.startswith(_ANNOTATIONS[kind])
                and (aa.get("Input Dims") or [])[:1] == want
                and (aa.get("Input type") or [None])[0] in _DTYPES):
            used.add(j)
            return aa["Input type"][0]
    return None


def _op(kind: str, shapes: list[tuple], dtype: Optional[str]
        ) -> CollectiveOp:
    if dtype is None:
        # overestimating keeps the "traffic is small" guards sound
        warnings.warn(f"{kind}: no dtype recorded for its tensors; "
                      "assuming 16 bytes/element (conservative)",
                      stacklevel=3)
        hlo, size = "?", 16
    else:
        hlo, size = _DTYPES[dtype]
    nbytes = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= int(d)
        nbytes += n * size
    return CollectiveOp(kind, " ".join(
        f"{hlo}[{','.join(str(d) for d in s)}]" for s in shapes), nbytes,
        tuple(tuple(int(d) for d in s) for s in shapes))


def collective_bytes(trace: Trace, *, world: Optional[int] = None) -> int:
    """Total collective payload bytes per device over a profiled run (a
    capture of ``utils/profiling.py``: its events, file or directory)."""
    return sum(op.bytes for op in collective_ops(trace, world=world))


def traffic_report(trace: Trace, *, world: Optional[int] = None) -> dict:
    """{total_bytes, ops:[{kind, shape, bytes}...]} — JSONL-friendly, for
    bench output and metrics (SURVEY.md §5.5)."""
    ops = collective_ops(trace, world=world)
    return {
        "total_bytes": sum(o.bytes for o in ops),
        "ops": [{"kind": o.kind, "shape": o.shape, "bytes": o.bytes}
                for o in ops],
    }
