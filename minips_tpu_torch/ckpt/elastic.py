"""Elastic resume — reshard rank-local checkpoints across WORLD SIZES.

The reference's recovery is relaunch at the SAME node count + per-server
Dump/Load (SURVEY.md §3.5: "no elastic resize, same as the reference's
fixed node set"). The package keeps that fast path untouched and adds an
elastic one on top: a job checkpointed by N processes can relaunch at
M != N. Each new rank reassembles its M-way row range from the
overlapping row slices of the N old shard files — parameters AND
optimizer state are row-aligned in a ShardedTable (w/acc/m/v per-row,
steps per-row), so ONE slicing rule re-partitions everything, adam
moments included. A grown world (M > N) and a shrunk one (M < N) are the
same math.

Requirements, stated honestly:

- ``checkpoint_dir`` must be a SHARED filesystem: a new rank reads OLD
  ranks' shard files. That is the assumption the reference's HDFS-backed
  dumps already make; per-host local dirs support only same-size resume
  (the existing fast path).
- resharding is only meaningful at the rank-dir layout
  ``<checkpoint_dir>/rank<r>/step_<s>/<table>.npz`` written by
  ``apps.common.shard_checkpointing``; the step chosen is the NEWEST one
  whose holders form a complete old world (rank dirs 0..k-1 all hold
  it) — a partial holder set means that incarnation's save was torn and
  is skipped.

After an elastic restore the caller should re-publish the resharded
state at the same step under its NEW rank dir (``Checkpointer.save``),
so the next crash resumes through the ordinary same-size path.

A copy of ``minips_tpu/ckpt/elastic.py``, which imports no JAX.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Optional

import numpy as np
from numpy.lib import format as _npfmt


def _rank_dirs(checkpoint_dir: str) -> dict[int, str]:
    out = {}
    try:
        entries = os.listdir(checkpoint_dir)
    except OSError:
        return out
    for d in entries:
        m = re.fullmatch(r"rank(\d+)", d)
        if m and os.path.isdir(os.path.join(checkpoint_dir, d)):
            out[int(m.group(1))] = os.path.join(checkpoint_dir, d)
    return out


def _steps_in(rank_dir: str) -> set[int]:
    out = set()
    try:
        entries = os.listdir(rank_dir)
    except OSError:
        return out
    for d in entries:
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(rank_dir, d, "manifest.json")):
            out.add(int(m.group(1)))
    return out


def _fits_partition(checkpoint_dir: str, step: int, r: int, tables: dict,
                    k: int) -> bool:
    """True iff rank ``r``'s files at ``step`` were saved under a
    ``k``-process partition (lo == r*shard_size(k) and padded rows ==
    shard_size(k) for every ShardedTable)."""
    d = os.path.join(checkpoint_dir, f"rank{r}", f"step_{step:010d}")
    for name, t in tables.items():
        if not hasattr(t, "shard_lo"):
            continue
        sz = -(-t.num_rows // k)  # RangePartitioner.shard_size at k
        if _shard_layout(d, name) != (r * sz, sz):
            return False
    return True


def find_elastic_step(checkpoint_dir: str,
                      tables: dict) -> Optional[tuple[int, int]]:
    """Newest ``(step, old_n)`` such that ranks 0..old_n-1 all hold
    ``step`` saved under a CONSISTENT old_n-process partition. None if no
    complete old world exists (fresh start).

    The partition-fit check matters because one step NUMBER can carry
    mixed layouts: an earlier elastic resume re-publishes the resharded
    state at the same step under the new world's rank dirs, while ranks
    beyond the new world still hold the old world's files. Candidate
    world sizes are tried largest-first so the most complete consistent
    layout wins."""
    dirs = _rank_dirs(checkpoint_dir)
    if not dirs:
        return None
    holders: dict[int, set[int]] = {}
    for r, d in dirs.items():
        for s in _steps_in(d):
            holders.setdefault(s, set()).add(r)
    for s in sorted(holders, reverse=True):
        ranks = holders[s]
        for k in range(len(ranks), 0, -1):
            if not set(range(k)) <= ranks:
                continue
            if all(_fits_partition(checkpoint_dir, s, r, tables, k)
                   for r in range(k)):
                return s, k
    return None


def _shard_layout(step_dir: str,
                  name: str) -> Optional[tuple[int, int]]:
    """(lo, padded row count) recorded in one table's shard file, or
    None when the file is absent/unreadable — the ONE place both layout
    checks read, so the negotiation filter and the elastic scan cannot
    drift apart on what 'fits' means."""
    path = os.path.join(step_dir, f"{name}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return int(z["lo"]), int(z["w"].shape[0])
    except (OSError, KeyError, ValueError):
        return None


def step_matches_layout(rank_dir: str, step: int, tables: dict) -> bool:
    """True iff ``step`` in ``rank_dir`` was saved under the CALLER'S
    partition — same shard origin (``lo``) and same padded shard row
    count for every ShardedTable. A surviving rank relaunched into a
    DIFFERENT world size still holds its old-world steps; offering those
    to the resume negotiation would either crash the restore (shape/lo
    mismatch) or, worse, silently restore the wrong rows. Steps that
    fail this filter stay on disk — they are exactly what the elastic
    path reshards from."""
    d = os.path.join(rank_dir, f"step_{step:010d}")
    for name, t in tables.items():
        if not hasattr(t, "shard_lo"):
            continue
        if _shard_layout(d, name) != (t.shard_lo, t.part.shard_size):
            return False
    return True


def _load_table_npz(checkpoint_dir: str, step: int, old_rank: int,
                    name: str) -> dict[str, np.ndarray]:
    path = os.path.join(checkpoint_dir, f"rank{old_rank}",
                        f"step_{step:010d}", f"{name}.npz")
    with np.load(path) as z:
        return dict(z.items())


def _shard_path(checkpoint_dir: str, step: int, rank: int,
                name: str) -> str:
    return os.path.join(checkpoint_dir, f"rank{rank}",
                        f"step_{step:010d}", f"{name}.npz")


class NpzSliceReader:
    """Row-range reads out of ONE ``np.savez`` shard file without
    materializing whole arrays — the cap-bounded staging primitive the
    planned-redistribution restore paths stream through.

    ``np.savez`` stores members uncompressed (ZIP_STORED), so a
    member's ``.npy`` payload is a flat seekable byte range: after
    parsing the npy header once, rows ``[a, b)`` of a C-contiguous
    row-aligned leaf are ``(b-a) * row_bytes`` bytes at a computed
    offset. Fortran-order or exotically-versioned members fall back to
    a whole-member read (none exist in minitpups checkpoints today —
    the fallback is the honest escape hatch, not a fast path)."""

    def __init__(self, path: str):
        self.path = path
        self._zf = zipfile.ZipFile(path, "r")
        self._members = {n[:-4]: n for n in self._zf.namelist()
                         if n.endswith(".npy")}
        self._hdr: dict[str, tuple] = {}

    def keys(self):
        return self._members.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._members

    def _header(self, key: str) -> tuple:
        """(shape, dtype, data_offset | None) — offset None means
        'stream-unsliceable, use a whole read' (fortran order or an
        npy version this parser does not know)."""
        if key not in self._hdr:
            with self._zf.open(self._members[key]) as fp:
                ver = _npfmt.read_magic(fp)
                if ver == (1, 0):
                    shape, fortran, dt = \
                        _npfmt.read_array_header_1_0(fp)
                elif ver == (2, 0):
                    shape, fortran, dt = \
                        _npfmt.read_array_header_2_0(fp)
                else:
                    shape, fortran, dt = None, True, None
                if fortran or shape is None:
                    arr = self.read(key)
                    self._hdr[key] = (arr.shape, arr.dtype, None)
                else:
                    self._hdr[key] = (shape, dt, fp.tell())
        return self._hdr[key]

    def shape(self, key: str) -> tuple:
        return tuple(self._header(key)[0])

    def dtype(self, key: str):
        return self._header(key)[1]

    def read(self, key: str) -> np.ndarray:
        """Whole-member read (meta scalars, passthrough leaves, the
        fallback path)."""
        with self._zf.open(self._members[key]) as fp:
            return _npfmt.read_array(fp, allow_pickle=False)

    def read_rows(self, key: str, a: int, b: int) -> np.ndarray:
        """Rows ``[a, b)`` of a row-aligned leaf, staged as exactly
        ``(b-a) * row_bytes`` bytes — never the whole array."""
        shape, dt, off = self._header(key)
        if b <= a:
            return np.zeros((0,) + tuple(shape[1:]),
                            dt if dt is not None else np.float32)
        if off is None:  # fallback: unsliceable member layout
            return np.array(self.read(key)[a:b])
        row = int(dt.itemsize * np.prod(shape[1:], dtype=np.int64)) \
            if len(shape) > 1 else int(dt.itemsize)
        with self._zf.open(self._members[key]) as fp:
            fp.seek(off + a * row)
            buf = fp.read((b - a) * row)
        if len(buf) != (b - a) * row:
            raise ValueError(
                f"{self.path}: short read of {key!r} rows [{a},{b}) — "
                "truncated shard file")
        return np.frombuffer(buf, dt).reshape(
            (b - a,) + tuple(shape[1:])).copy()

    def close(self) -> None:
        self._zf.close()

    def __enter__(self) -> "NpzSliceReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # cache-held readers close on collection
        try:
            self._zf.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


_META_KEYS = ("lo", "ep", "ovb", "ovo", "rb_block")


def saved_overlay(state: dict) -> tuple[int, int, dict[int, int]]:
    """``(epoch, block_size, {block: owner})`` recorded in one shard's
    flat state dict — empty when the step was saved unrebalanced. Every
    rank records the SAME routing table at a settled save boundary, so
    any one shard file is authoritative for the fleet's overlay."""
    ep = int(np.asarray(state.get("ep", 0)))
    if not ep:
        return 0, 0, {}
    blk = int(np.asarray(state.get("rb_block", 0)))
    ov = {int(b): int(o) for b, o in
          zip(np.asarray(state.get("ovb", np.zeros(0))).tolist(),
              np.asarray(state.get("ovo", np.zeros(0))).tolist())}
    return ep, blk, ov


def _block_span(old_sz: int, block_size: int, b: int) -> tuple[int, int]:
    """Global ``(lo, length)`` of block ``b`` under an ``old_sz``-row
    partition cut into ``block_size``-key blocks — the on-disk twin of
    ``BlockRouter.block_span`` (blocks are cut per shard, the last block
    of a shard possibly short)."""
    bps = -(-old_sz // block_size)
    shard, loc = divmod(int(b), bps)
    lo = shard * old_sz + loc * block_size
    return lo, min(block_size, old_sz - loc * block_size)


def reshard_table_state(checkpoint_dir: str, step: int, old_n: int,
                        name: str, num_rows: int, new_lo: int,
                        new_shard_size: int, *,
                        cap_bytes: Optional[int] = None,
                        stats: Optional[dict] = None
                        ) -> dict[str, np.ndarray]:
    """Assemble the state dict for the new shard ``[new_lo, new_lo +
    new_shard_size)`` of table ``name`` from the ``old_n`` old shard
    files at ``step``.

    Slicing rule: any leaf whose leading dimension equals the OLD
    shard_size is row-aligned (w, acc, m, v, steps — shards are PADDED to
    shard_size, so only the rows inside ``num_rows`` are real); ``lo`` is
    replaced by the new shard origin; any other leaf must be identical
    across old shards (there are none today — the assert is the tripwire
    for a future leaf this rule cannot place).

    A REBALANCED checkpoint (saved routing epoch > 0) reshards through
    its overlay instead of refusing: the home-slab slices land first
    (dead copies of moved-out blocks included), then every overlay
    block's live state — held in its save-time owner's ``xtra`` section
    — overwrites its span, optimizer leaves alike. The result is the
    FLATTENED table at the new partition: rows live where the base range
    map says, no overlay survives the resize (the restored fleet starts
    at routing epoch 0, consistent because every rank reshards from the
    same files).

    STREAMING (planned redistribution's mover (c)): old shard files are
    read through :class:`NpzSliceReader` in row chunks of at most
    ``cap_bytes`` (default 64 MiB, the MINIPS_RESHARD cap default) —
    peak transient staging is CAP-bounded, never source-shard- or
    block-bounded, which is what lets a 1/N-memory rank reshard a table
    bigger than its RAM budget. ``stats`` (optional dict out-param)
    records the measured ``peak_stage_bytes`` and ``chunks`` — the
    RESHARD-MEM gate reads the measurement, it does not trust the
    promise."""
    cap = 64 << 20 if cap_bytes is None else max(1, int(cap_bytes))
    peak = chunks = 0
    readers: dict[int, NpzSliceReader] = {}

    def _rd(rank: int) -> NpzSliceReader:
        if rank not in readers:
            readers[rank] = NpzSliceReader(
                _shard_path(checkpoint_dir, step, rank, name))
        return readers[rank]

    try:
        probe = _rd(0)
        meta = {k: probe.read(k) for k in _META_KEYS if k in probe}
        saved_ep, saved_blk, saved_ov = saved_overlay(meta)
        if saved_ep and saved_blk <= 0:
            raise ValueError(
                f"elastic reshard: step {step} of table {name!r} "
                f"records a rebalanced routing table (epoch {saved_ep}) "
                "without its block granularity — torn save, overlay "
                "blocks cannot be placed")
        old_sz = -(-num_rows // old_n)  # RangePartitioner.shard_size
        new_hi = min(new_lo + new_shard_size, num_rows)
        row_keys = sorted(
            k for k in probe.keys()
            if k not in _META_KEYS and "/" not in k
            and len(probe.shape(k)) >= 1 and probe.shape(k)[0] == old_sz)
        if new_hi <= new_lo:
            # a grown world's last shard can lie ENTIRELY in padding
            # (shard_lo >= num_rows): there are no rows to assemble, but
            # the live table still expects every leaf at full shard
            # shape — use old rank 0's leaves as the shape/dtype
            # template, zero-filled. Overlay metadata and xtra subtrees
            # never ride a resharded state: the resize flattens the
            # routing table.
            out = {"lo": np.asarray(new_lo)}
            for key in sorted(probe.keys()):
                if key in _META_KEYS or "/" in key:
                    continue
                if key in row_keys:
                    out[key] = np.zeros(
                        (new_shard_size,) + probe.shape(key)[1:],
                        probe.dtype(key))
                else:
                    out[key] = probe.read(key)
            return out
        # preallocate the DESTINATION arrays once (they are the final
        # storage, not staging) — streamed chunks land in place, the
        # last shard's padding stays zero exactly like __init__ pads
        out: dict[str, np.ndarray] = {"lo": np.asarray(new_lo)}
        for key in row_keys:
            out[key] = np.zeros(
                (new_shard_size,) + probe.shape(key)[1:],
                probe.dtype(key))
        passthrough: dict[str, np.ndarray] = {}
        for o in range(old_n):
            lo_o = o * old_sz
            hi_o = min(lo_o + old_sz, num_rows)
            a, b = max(lo_o, new_lo), min(hi_o, new_hi)
            if a >= b:
                continue
            r = _rd(o)
            for key in sorted(r.keys()):
                if key in _META_KEYS or "/" in key:
                    continue  # routing metadata / xtra: overlay pass
                shape = r.shape(key)
                if len(shape) >= 1 and shape[0] == old_sz:
                    row_b = max(1, int(r.dtype(key).itemsize
                                       * np.prod(shape[1:],
                                                 dtype=np.int64)))
                    step_rows = max(1, cap // row_b)
                    for ca in range(a, b, step_rows):
                        cb = min(ca + step_rows, b)
                        rows = r.read_rows(key, ca - lo_o, cb - lo_o)
                        out[key][ca - new_lo:cb - new_lo] = rows
                        peak = max(peak, int(rows.nbytes))
                        chunks += 1
                        del rows
                else:
                    arr = r.read(key)
                    prev = passthrough.get(key)
                    # a hard refusal, not an assert: resharding a leaf
                    # that is neither row-aligned nor shard-invariant
                    # would silently pick one shard's copy — and
                    # `python -O` strips asserts, so the tripwire must
                    # be a real raise
                    if prev is not None \
                            and not np.array_equal(prev, arr):
                        raise ValueError(
                            f"elastic reshard: leaf {name}.{key} is "
                            "neither row-aligned nor identical across "
                            "old shards")
                    passthrough[key] = arr
        out.update(passthrough)
        if saved_ep:
            # overlay pass: every moved block's LIVE rows sit in its
            # save-time owner's xtra section; the home-slab slice
            # placed above is a dead copy. Overwrite the intersection
            # of each overlay block's span with my new range, every
            # row-aligned leaf alike (optimizer state migrates with
            # its rows) — streamed in the same cap-bounded chunks.
            for blk_id, owner in sorted(saved_ov.items()):
                blo, bln = _block_span(old_sz, saved_blk, blk_id)
                a, b = max(blo, new_lo), min(blo + bln, new_hi)
                if a >= b:
                    continue
                r = _rd(int(owner))
                prefix = f"xtra/{blk_id}/"
                xs = sorted(k[len(prefix):] for k in r.keys()
                            if k.startswith(prefix))
                if not set(row_keys) <= set(xs):
                    # EVERY row-aligned leaf must come from the live
                    # copy: a subset (say w without m) would silently
                    # mix live params with a dead home copy's
                    # optimizer state
                    raise ValueError(
                        f"elastic reshard: step {step} of table "
                        f"{name!r} maps block {blk_id} to rank "
                        f"{owner}, but that rank's shard file lacks "
                        f"{sorted(set(row_keys) - set(xs))} for it — "
                        "torn rebalanced save")
                for key in xs:
                    if key not in out:
                        continue
                    member = prefix + key
                    shape = r.shape(member)
                    row_b = max(1, int(r.dtype(member).itemsize
                                       * np.prod(shape[1:],
                                                 dtype=np.int64)))
                    step_rows = max(1, cap // row_b)
                    for ca in range(a, b, step_rows):
                        cb = min(ca + step_rows, b)
                        rows = r.read_rows(member, ca - blo, cb - blo)
                        out[key][ca - new_lo:cb - new_lo] = rows
                        peak = max(peak, int(rows.nbytes))
                        chunks += 1
                        del rows
        return out
    finally:
        if stats is not None:
            stats["peak_stage_bytes"] = max(
                stats.get("peak_stage_bytes", 0), peak)
            stats["chunks"] = stats.get("chunks", 0) + chunks
        for r in readers.values():
            r.close()


def find_live_step(checkpoint_dir: str, tables: dict, n: int,
                   required=None) -> Optional[int]:
    """Newest step that every rank in ``required`` (default: all of
    ``0..n-1``) holds under the CALLER'S ``n``-way partition (overlays
    allowed — the slab layout is what the fit check reads). The
    elastic-membership death path restores a dead rank's blocks from
    this step, passing ``required = live ∪ {corpse}``: one
    coordinator-chosen step keeps every survivor's restore consistent,
    and a never-checkpointed STANDBY's missing rank dir must not veto
    recovery (it owns nothing a checkpoint could hold — its home range
    was evacuated into live ranks' files at bootstrap). Ranks in
    ``required`` that never created a dir are skipped for the same
    reason; no dirs at all means no recovery."""
    dirs = _rank_dirs(checkpoint_dir)
    need = sorted((set(range(n)) if required is None
                   else {int(r) for r in required}) & set(dirs))
    if not need:
        return None
    common: Optional[set[int]] = None
    for r in need:
        steps = _steps_in(dirs[r])
        common = steps if common is None else common & steps
    for s in sorted(common or (), reverse=True):
        if all(_fits_partition(checkpoint_dir, s, r, tables, n)
               for r in need):
            return s
    return None


def load_block_state(checkpoint_dir: str, step: int, name: str,
                     block: int, blo: int, bln: int, home_rank: int,
                     shard_size: int, block_size: int,
                     cache: Optional[dict] = None
                     ) -> dict[str, np.ndarray]:
    """State of ONE key block at ``step``, read through the save-time
    routing table — the elastic-membership death path's restore unit
    (a dead rank's blocks reassemble onto survivors from exactly what
    the checkpoint holds, wherever the overlay had parked them).

    ``blo``/``bln``/``home_rank`` are the block's LIVE geometry
    (``BlockRouter.block_span``/``home_of``); the saved block size must
    match the live router's, else block ids name different key ranges
    and the restore would be silently torn — refused loudly instead.
    ``cache`` (rank -> open :class:`NpzSliceReader`, caller-held across
    one adoption) keeps a dead rank's B-block restore from re-opening
    the same shard files B times — and because the reader SLICES rows
    instead of materializing whole shards, a B-block restore stages
    only the blocks it returns, never a full old shard (the planned-
    redistribution memory contract)."""

    def _rd(rank: int) -> NpzSliceReader:
        if cache is None:
            return NpzSliceReader(
                _shard_path(checkpoint_dir, step, rank, name))
        if rank not in cache:
            cache[rank] = NpzSliceReader(
                _shard_path(checkpoint_dir, step, rank, name))
        return cache[rank]

    # the routing metadata is identical in every shard file, so read it
    # from the home rank when possible and fall back to ANY holder: the
    # home rank may be a corpse that never checkpointed (an admitted-
    # then-killed joiner), whose blocks' live state sits in other
    # ranks' files per the overlay
    meta = None
    for rank in [home_rank] + sorted(set(_rank_dirs(checkpoint_dir))
                                     - {home_rank}):
        try:
            r = _rd(rank)
            meta = {k: r.read(k) for k in _META_KEYS if k in r}
            break
        except (OSError, ValueError, KeyError):
            continue
    if meta is None:
        raise ValueError(
            f"elastic restore: no readable shard file at step {step} "
            f"of table {name!r} — nothing to restore block {block} "
            "from")
    saved_ep, saved_blk, saved_ov = saved_overlay(meta)
    if saved_ep and saved_blk != block_size:
        raise ValueError(
            f"elastic restore: step {step} of table {name!r} was saved "
            f"at block granularity {saved_blk}, live router runs "
            f"{block_size} — block ids are incomparable")
    owner = saved_ov.get(int(block), home_rank)
    if owner == home_rank:
        try:
            home = _rd(home_rank)
        except (OSError, ValueError, KeyError) as e:
            # the state lived only on the (dir-less) home rank: gone
            raise ValueError(
                f"elastic restore: step {step} of table {name!r} holds "
                f"no file for rank {home_rank}, the save-time owner of "
                f"block {block}") from e
        lo_local = blo - home_rank * shard_size
        st = {}
        for key in sorted(home.keys()):
            if key in _META_KEYS or "/" in key:
                continue
            shape = home.shape(key)
            if len(shape) >= 1 and shape[0] == shard_size:
                st[key] = home.read_rows(key, lo_local, lo_local + bln)
    else:
        state = _rd(int(owner))
        prefix = f"xtra/{block}/"
        st = {k[len(prefix):]: state.read(k) for k in state.keys()
              if k.startswith(prefix)}
    if st.get("w") is None or st["w"].shape[0] != bln:
        raise ValueError(
            f"elastic restore: step {step} of table {name!r} holds no "
            f"usable state for block {block} "
            f"(expected {bln} rows at rank "
            f"{owner})")
    return st


def read_saved_clock(checkpoint_dir: str, step: int,
                     name: str = "trainer") -> int:
    """The clock stamped into rank 0's trainer snapshot at ``step`` — at
    a save boundary every rank stamps the same value (save_hook runs at
    clock == i+1), so one representative suffices."""
    state = _load_table_npz(checkpoint_dir, step, 0, name)
    return int(state["clock"])
