"""Checkpoint/recovery — the port of ``minips_tpu/ckpt/checkpoint.py``, the
native backend: npz files in step directories.

PS state = parameters + optimizer state + the clock vector, so that is
what a checkpoint holds:

- one ``.npz`` per table (dense: ``params`` and the ``opt_state`` leaf
  list, bfloat16 leaves as uint16 bits; sparse: ``emb``, ``layout`` and
  the row optimizer state), the same keys the JAX package writes;
- a JSON manifest with step, table names and controller clocks;
- atomic publish: write to ``step_K.tmp/`` then rename to ``step_K/``, so
  a crash mid-save never corrupts the latest good checkpoint;
- optional async save: the tables' ``state_dict()`` host copies are taken
  on the caller's thread, then a background thread writes them while the
  device keeps training.

Recovery = construct the same tables, ``restore()`` the newest step that
reads whole (walking back past a torn one), resume the loop at ``step``.

Under a process group (``group=``, the group the tables are sharded
over) every rank calls ``save`` and ``restore``: a table's
``state_dict()`` gathers its shards (a collective), rank 0 alone writes
and publishes the step directory and prunes old ones, and every rank then
waits at the group's barrier, so that no rank reads a step before it is
published; the clocks written are rank 0's controllers'. An async save
runs its writer thread on rank 0 and ``wait()`` ends in the barrier.
Every rank restores: the ranks share one host and its filesystem, each
reads the global state and ``load_state_dict`` keeps its shard.
Resharding across world sizes (``ckpt/elastic.py``) waits for the
multi-process port (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np

from minips_tpu_torch.parallel.mesh import Group, barrier, world


class Checkpointer:
    def __init__(self, directory: str, tables: dict[str, Any],
                 controllers: Optional[dict[str, Any]] = None,
                 *, keep: int = 3, async_save: bool = False,
                 group: Group = None):
        self.dir = directory
        self.group = group
        self._writes = world(group)[0] == 0  # rank 0 publishes
        self._pending = False
        self.tables = tables
        self.controllers = controllers or {}
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int) -> str:
        """Snapshot to host, then (a)synchronously write + atomically
        publish ``step_<step>/`` (under a group: every rank calls it, rank
        0 writes)."""
        snap = {name: t.state_dict() for name, t in self.tables.items()}
        clocks = {name: c.state_dict() for name, c in self.controllers.items()}
        if self.async_save:
            self.wait()  # one save in flight at a time
            if self._writes:
                self._thread = threading.Thread(
                    target=self._write, args=(step, snap, clocks),
                    daemon=True)
                self._thread.start()
            self._pending = True
        else:
            if self._writes:
                self._write(step, snap, clocks)
            barrier(self.group)
        return self._step_dir(step)

    def wait(self) -> None:
        """Until an async save is published (on every rank of a
        group)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            barrier(self.group)

    def close(self) -> None:
        """Flush a pending async save."""
        self.wait()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write(self, step: int, snap: dict, clocks: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, state in snap.items():
            flat = _flatten(state)
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "tables": sorted(snap),
                       "clocks": clocks}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def prune_above(self, step: int) -> list[int]:
        """Delete checkpoints NEWER than ``step`` and return the pruned
        step numbers. Used after a cross-rank resume negotiation: local
        steps above the agreed step belong to a dead incarnation — left
        in place, a later crash could negotiate onto a step whose shards
        mix incarnations (a torn table nothing would detect)."""
        pruned = [s for s in self.list_steps() if s > step]
        if self._writes:
            for s in pruned:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        barrier(self.group)
        return pruned

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def _validate_step(self, step: int) -> dict:
        """Read a step's manifest and force-read EVERY table's npz —
        ONE TABLE AT A TIME, discarding each after the read — applying
        nothing. Validation before mutation: a torn checkpoint
        (truncated npz, corrupt manifest, missing table file) must
        fail HERE, while the live tables are still untouched, so the
        caller can walk back to an older step instead of relaunching
        half-loaded. Reading per-table keeps the validation pass at
        the OLD peak memory (largest single table, not the whole
        checkpoint next to the live tables)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or "step" not in manifest:
            raise ValueError(f"manifest.json in {d} lacks 'step'")
        for name in self.tables:
            path = os.path.join(d, f"{name}.npz")
            with np.load(path) as z:
                # dict(z.items()) forces every array to decompress NOW
                # — a truncated/corrupt member raises inside this read,
                # not later during load_state_dict — and the dict dies
                # at the end of this iteration
                _unflatten(dict(z.items()))
        return manifest

    def restore(self, step: Optional[int] = None) -> int:
        """Load the given (or newest restorable) step into the live
        tables/controllers; returns the restored step number.

        With ``step=None`` (the relaunch path) a TORN checkpoint —
        unreadable npz, corrupt manifest, a table file missing — is
        skipped with a loud stderr warning and the walk continues to the
        next-newest step: a crash that tore the latest checkpoint must
        cost one checkpoint interval of progress, not the relaunch. An EXPLICIT ``step`` keeps the
        strict semantics (the caller asked for that step; silently
        substituting another would be worse than failing). All state
        for a step is read and validated BEFORE any of it is applied,
        so a failed candidate leaves the live tables untouched."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        explicit = step is not None
        cands = [step] if explicit else list(reversed(steps))
        skipped: list[str] = []
        for s in cands:
            try:
                manifest = self._validate_step(s)
            except Exception as e:  # noqa: BLE001 - torn-ckpt walkback
                if explicit:
                    raise
                import sys

                note = f"step_{s}: {type(e).__name__}: {e}"
                print(f"[ckpt] WARNING: skipping torn checkpoint "
                      f"{note} — walking back to the previous step",
                      file=sys.stderr, flush=True)
                try:
                    from minips_tpu_torch.obs import flight as _fl

                    _fl.record("ckpt_skip_torn",
                               {"dir": self.dir, "step": int(s),
                                "err": str(e)[:200]})
                except Exception:  # noqa: BLE001 - obs must not block
                    pass
                skipped.append(note)
                continue
            # apply pass: re-read one table at a time (old peak
            # memory — double I/O only on the restore path, where the
            # validation read is usually still in the page cache)
            d = self._step_dir(s)
            for name, t in self.tables.items():
                with np.load(os.path.join(d, f"{name}.npz")) as z:
                    t.load_state_dict(_unflatten(dict(z.items())))
            for name, c in self.controllers.items():
                if name in manifest.get("clocks", {}):
                    c.load_state_dict(manifest["clocks"][name])
            return manifest["step"]
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.dir}: every "
            f"candidate was torn ({'; '.join(skipped)})")


# --------------------------------------------------------------------- utils
def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested state dict (dicts/lists/tuples/ndarrays) to
    slash-keyed arrays for npz."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}_{i}/"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of _flatten (lists come back as lists)."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if parts[-1] == "__none__" else val
    return _listify(root)


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.keys() and all(re.fullmatch(r"_\d+", k) for k in node):
        return [_listify(node[k]) for k in
                sorted(node, key=lambda s: int(s[1:]))]
    if set(node.keys()) == {"__none__"}:
        return None
    return {k: _listify(v) for k, v in node.items()}
