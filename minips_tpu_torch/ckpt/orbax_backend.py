"""The ``"orbax"`` checkpoint backend — the port of
``minips_tpu/ckpt/orbax_backend.py`` on ``torch.distributed.checkpoint``
(DCP).

The JAX package's second backend writes TensorStore/OCDBT files through
``orbax.checkpoint``. The port keeps its module path, its class name and
its selector (``backend="orbax"``, ``MINIPS_CKPT_BACKEND=orbax``) so the
reference's callers find it, but the files are DCP's (a ``.metadata``
file and one ``.distcp`` file per writing process), not TensorStore's: a
checkpoint carries across the two packages through
``convert_checkpoint`` and the native npz backend, not as files.

Same surface as the native backend (save / wait / restore / list_steps /
close), same content (each table's state + controller clocks), so the two
are drop-in interchangeable:

    ck = make_checkpointer(path, tables, backend="orbax")  # or "native"

Layout. A table with ``global_arrays()`` (``DenseTable``) is written as
the shards its process holds, each process writing only its own under
its rank's keys; a step directory records the world size and each such
table's padded length (``layout.json``), and a restore into another
layout is refused rather than read into the wrong ranges. Any other table
(``SparseTable``, ``SSPTrainer``) is written as its ``state_dict()``,
which its own ``load_state_dict`` checks on restore (the sparse table's
key->slot ``layout`` record among them); a key the checkpoint does not
carry is left out of the restore template, as the reference prunes it.
Controller clocks ride ``clocks.json`` beside the arrays.

Under a process group (``group=``) every rank calls ``save`` and
``restore``; DCP's planner gathers the ranks' plans, rank 0 writes the
metadata and publishes the step (``step_K.tmp/`` renamed to ``step_K/``
after every rank has written, so a torn save is never listed).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from minips_tpu_torch.parallel.mesh import Group, barrier, world

_STEP = re.compile(r"^step_(\d+)$")


def _jsonable(node):
    """Clock state: numpy scalars/arrays -> plain ints/lists for JSON."""
    if isinstance(node, dict):
        return {k: _jsonable(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_jsonable(v) for v in node]
    if isinstance(node, np.ndarray):
        return node.tolist()
    if isinstance(node, np.generic):
        return node.item()
    return node


def _to_tensor(x) -> torch.Tensor:
    """A state leaf as a CPU tensor DCP writes: numpy arrays as they are,
    uint16 (bfloat16 bit patterns) as int16 of the same bits."""
    if torch.is_tensor(x):
        return x.detach()
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a.copy())


def _flatten(state: dict, prefix: str, out: dict, kinds: dict) -> None:
    """``{"a": {"b": x, "c": [y, z]}}`` -> keys ``prefix/a/b``,
    ``prefix/a/c/0``, ...; ``kinds`` keeps each key's numpy dtype so a
    restore gives back what ``state_dict()`` gave."""
    for k, v in state.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(v, key, out, kinds)
        elif isinstance(v, (list, tuple)):
            _flatten({str(i): x for i, x in enumerate(v)}, key, out, kinds)
        else:
            out[key] = _to_tensor(v)
            kinds[key] = str(np.asarray(v).dtype) if not torch.is_tensor(v) \
                else None


def _unflatten(template: dict, prefix: str, flat: dict, kinds: dict):
    out = {}
    for k, v in template.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out[k] = _unflatten(v, key, flat, kinds)
        elif isinstance(v, (list, tuple)):
            sub = _unflatten({str(i): x for i, x in enumerate(v)}, key, flat,
                             kinds)
            out[k] = [sub[str(i)] for i in range(len(v))]
        elif key in flat:
            t = flat[key]
            if kinds.get(key) is None:     # written from a tensor
                out[k] = t
                continue
            a = t.numpy()
            out[k] = a.view(np.uint16) if kinds[key] == "uint16" else a
    return out


class OrbaxCheckpointer:
    """DCP-backed checkpointer with the JAX package's ``OrbaxCheckpointer``
    surface (module docstring)."""

    def __init__(self, directory: str, tables: dict[str, Any],
                 controllers: Optional[dict[str, Any]] = None,
                 *, keep: int = 3, async_save: bool = False,
                 group: Group = None):
        import torch.distributed.checkpoint  # noqa: F401 - fail early

        self.dir = os.path.abspath(directory)
        self.tables = tables
        self.controllers = controllers or {}
        self.keep = keep
        self.async_save = async_save
        self.group = group
        self.rank, self.world = world(group)
        self._pending = None  # (future, step) of an async save
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------ helpers
    def _dcp_kw(self) -> dict:
        if self.group is None:
            return {"no_dist": True}
        return {"process_group": self.group}

    def _sharded(self, t) -> bool:
        return hasattr(t, "global_arrays")

    def _layout(self) -> dict:
        return {"world": self.world,
                "padded": {n: int(t.padded) for n, t in self.tables.items()
                           if self._sharded(t)}}

    def _state(self) -> tuple[dict, dict]:
        """(flat tensors to write, numpy dtype of each key)."""
        flat, kinds = {}, {}
        for name, t in self.tables.items():
            if self._sharded(t):
                # this process's shards, under its rank's keys: DCP writes
                # each once, by the process that holds it
                _flatten(t.global_arrays(), f"{name}/r{self.rank}", flat,
                         kinds)
            else:
                _flatten(t.state_dict(), name, flat, kinds)
        return flat, kinds

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{int(step)}")

    # ------------------------------------------------------------------ save
    def save(self, step: int) -> str:
        import torch.distributed.checkpoint as dcp

        self.wait()  # one save in flight at a time
        flat, kinds = self._state()
        tmp = self._path(step) + ".tmp"
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "layout.json"), "w") as f:
                json.dump({**self._layout(), "kinds": kinds}, f)
            with open(os.path.join(tmp, "clocks.json"), "w") as f:
                json.dump(_jsonable({n: c.state_dict() for n, c in
                                     self.controllers.items()}), f)
        barrier(self.group)
        if self.async_save:
            fut = dcp.async_save(flat, checkpoint_id=tmp, **self._dcp_kw())
            self._pending = (fut, int(step))
        else:
            dcp.save(flat, checkpoint_id=tmp, **self._dcp_kw())
            self._publish(int(step))
        return str(step)

    def _publish(self, step: int) -> None:
        barrier(self.group)  # every rank has written its part
        if self.rank == 0:
            final = self._path(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(final + ".tmp", final)
            if self.keep > 0:
                for old in self.list_steps()[:-self.keep]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        barrier(self.group)

    def wait(self) -> None:
        if self._pending is not None:
            fut, step = self._pending
            self._pending = None
            # a Future, or (newer torch) a response with an upload future
            getattr(fut, "upload_completion", fut).result()
            self._publish(step)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = _STEP.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, ".metadata")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: Optional[int] = None) -> int:
        import torch.distributed.checkpoint as dcp

        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else int(step)
        path = self._path(step)
        with open(os.path.join(path, "layout.json")) as f:
            saved = json.load(f)
        want = self._layout()
        if saved["padded"] and (saved["world"], saved["padded"]) != (
                want["world"], want["padded"]):
            raise ValueError(
                f"checkpoint step {step} was written by {saved['world']} "
                f"shards of padded lengths {saved['padded']}; these tables "
                f"are {want['world']} shards of {want['padded']} — restore "
                "at the world size that saved, or convert it through the "
                "native backend")
        kinds = saved["kinds"]
        template, kinds_now = self._state()
        stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        # keys the checkpoint does not carry (a record added after it was
        # written) leave the template; load_state_dict decides whether
        # their absence is tolerable
        template = {k: torch.empty_like(v.cpu())
                    for k, v in template.items() if k in stored}
        dcp.load(template, checkpoint_id=path, **self._dcp_kw())
        kinds = {**kinds_now, **kinds}
        for name, t in self.tables.items():
            if self._sharded(t):
                t.load_global_arrays(_unflatten(
                    t.global_arrays(), f"{name}/r{self.rank}", template,
                    kinds))
            else:
                t.load_state_dict(_unflatten(t.state_dict(), name, template,
                                             kinds))
        with open(os.path.join(path, "clocks.json")) as f:
            clocks = json.load(f)
        for name, c in self.controllers.items():
            if name in clocks:
                c.load_state_dict(clocks[name])
        return step

    def close(self) -> None:
        self.wait()


def make_checkpointer(directory: str, tables: dict[str, Any],
                      controllers: Optional[dict[str, Any]] = None,
                      *, keep: int = 3, async_save: bool = False,
                      backend: Optional[str] = None, group: Group = None):
    """Factory: ``backend`` = "native" (npz dirs, default) or "orbax"
    (DCP); default from ``$MINIPS_CKPT_BACKEND``. ``group``: the process
    group the tables are sharded over; ``None`` is one device."""
    backend = backend or os.environ.get("MINIPS_CKPT_BACKEND", "native")
    if backend == "orbax":
        return OrbaxCheckpointer(directory, tables, controllers, keep=keep,
                                 async_save=async_save, group=group)
    if backend != "native":
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'native' or 'orbax')")
    from minips_tpu_torch.ckpt.checkpoint import Checkpointer

    return Checkpointer(directory, tables, controllers, keep=keep,
                        async_save=async_save, group=group)
