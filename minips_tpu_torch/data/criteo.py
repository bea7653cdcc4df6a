"""Criteo display-advertising TSV reader/writer — a copy of
``minips_tpu/data/criteo.py``.

The reference family's flagship sparse workload is Wide&Deep / DeepFM on
Criteo-1TB (SURVEY.md §2 "Data loading"; BASELINE.json:10). Line format:

    label \\t I1..I13 (decimal ints, may be empty or negative)
          \\t C1..C26 (8-hex-digit categorical hashes, may be empty)

``read_criteo`` returns the same batch schema the apps and the synthetic
generator use (``data/synthetic.py`` ``criteo_like``):

- ``y``          [N]      float32 click labels
- ``dense``      [N, 13]  float32 numeric features (missing → 0)
- ``dense_mask`` [N, 13]  float32 presence mask
- ``cat``        [N, 26]  int64 categorical ids, offset ``field << 32`` so
  every column keeps a distinct id space (per-column vocabularies); missing
  values map to the field-offset 0 token. Downstream, SparseTable hashes
  these unbounded ids onto slots (tables/sparse.py ``hash_to_slots``).

A native C++ parser (cpp/criteo_reader.cpp, SURVEY.md §2.1 item 6) is used
transparently when buildable; the pure-Python path is the fallback and the
correctness oracle for it.
"""

from __future__ import annotations

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26


def write_criteo(path: str, y: np.ndarray, dense: np.ndarray,
                 cat: np.ndarray, dense_mask: np.ndarray | None = None) -> None:
    """Write rows in Criteo TSV form (used by tests/synthetic dumps). ``cat``
    entries are written as 8-hex of their low 32 bits; a masked-out dense
    cell (or NaN) is written as an empty field."""
    y = np.asarray(y)
    dense = np.asarray(dense)
    cat = np.asarray(cat)
    with open(path, "w") as f:
        for r in range(len(y)):
            fields = [str(int(y[r]))]
            for j in range(dense.shape[1]):
                v = dense[r, j]
                present = not np.isnan(v) if dense_mask is None \
                    else bool(dense_mask[r, j])
                fields.append(str(int(v)) if present else "")
            for j in range(cat.shape[1]):
                fields.append(format(int(cat[r, j]) & 0xFFFFFFFF, "08x"))
            f.write("\t".join(fields) + "\n")


def _read_python(path: str) -> dict:
    with open(path) as f:
        return _parse_lines(f, where=path)


def _parse_lines(lines, where: str = "<lines>") -> dict:
    """Parse an iterable of Criteo TSV lines (str or bytes) — the one
    Python parsing loop behind both the whole-file and byte-span paths
    (and the correctness oracle for the native parser)."""
    ys, denses, masks, cats = [], [], [], []
    field_offset = np.arange(NUM_CAT, dtype=np.int64) << 32
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode()
        line = line.rstrip("\r\n")
        if not line:
            continue
        parts = line.split("\t")
        # pad short lines so slicing below is uniform
        parts += [""] * (1 + NUM_DENSE + NUM_CAT - len(parts))
        # strict int label (same contract as the native parser's rc=3)
        ys.append(float(int(parts[0])) if parts[0] else 0.0)
        d = np.zeros(NUM_DENSE, np.float32)
        m = np.zeros(NUM_DENSE, np.float32)
        for j, tok in enumerate(parts[1:1 + NUM_DENSE]):
            if tok:
                d[j] = float(int(tok))
                m[j] = 1.0
        cat_toks = parts[1 + NUM_DENSE:1 + NUM_DENSE + NUM_CAT]
        if any(len(tok) > 8 for tok in cat_toks):
            # >8 hex digits would exceed the 32-bit per-field id space
            # (the native parser rejects these too — rc=3)
            raise ValueError(f"categorical token over 8 hex digits in "
                             f"{where!r}")
        c = np.array([int(tok, 16) if tok else 0 for tok in cat_toks],
                     np.int64) | field_offset
        denses.append(d)
        masks.append(m)
        cats.append(c)
    n = len(ys)
    return {
        "y": np.asarray(ys, np.float32),
        "dense": (np.stack(denses) if n else
                  np.zeros((0, NUM_DENSE), np.float32)),
        "dense_mask": (np.stack(masks) if n else
                       np.zeros((0, NUM_DENSE), np.float32)),
        "cat": (np.stack(cats) if n else np.zeros((0, NUM_CAT), np.int64)),
    }


def read_criteo(path: str, use_native: bool = True,
                shared: bool = False) -> dict:
    """Returns dict(y, dense, dense_mask, cat) — see module docstring.
    ``shared=True``: under the launcher, only the host's local leader
    parses; colocated processes mmap the same copy (data/shm_store.py)."""
    if shared:
        from minips_tpu_torch.data.shm_store import make_tag, shared_load

        tag = make_tag("criteo", path)
        return shared_load(tag, lambda: read_criteo(
            path, use_native=use_native, shared=False))
    if use_native:
        try:
            from minips_tpu_torch.data.native import read_criteo_native

            out = read_criteo_native(path)
            if out is not None:
                return out
        except ImportError:
            pass
    return _read_python(path)


def parse_criteo_chunk(data: bytes, use_native: bool = True,
                       where: str = "<bytes>") -> dict:
    """Parse a chunk of whole Criteo TSV lines already in memory. Native
    fast path (cpp criteo_parse_mem) with the Python line parser as
    fallback/oracle."""
    if use_native:
        try:
            from minips_tpu_torch.data.native import parse_criteo_bytes

            out = parse_criteo_bytes(data, where=where)
            if out is not None:
                return out
        except ImportError:
            pass
    return _parse_lines(data.splitlines(), where=where)


def stream_criteo_batches(path: str, batch_size: int, *,
                          chunk_bytes: int = 8 << 20,
                          use_native: bool = True, prefetch: int = 2,
                          transform=None, stats: dict | None = None):
    """Streaming ingestion: a producer thread reads the file ONCE,
    sequentially, in ~``chunk_bytes`` line-aligned chunks and parses each
    straight from memory while the consumer trains on earlier batches —
    parse overlaps compute, the first batch exists after one chunk, and
    the working set is one chunk, never the file (SURVEY.md §7.4.4; the
    Criteo-1TB posture). Yields dict batches of exactly ``batch_size``
    rows (tails carry across chunks; a final short batch is dropped — pass
    ``stats={}`` to read back ``stats["dropped_rows"]`` after exhaustion,
    the repo's no-silent-caps convention).
    ``transform(block_dict) -> block_dict`` runs ON THE PRODUCER THREAD
    (e.g. log_transform of dense), keeping that cost off the training
    thread too. Abandoning the generator (close/GC/exception) stops the
    producer promptly — it never blocks forever on a full queue."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    _SENTINEL = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with open(path, "rb") as f:
                tail = b""
                while not stop.is_set():
                    chunk = f.read(chunk_bytes)
                    if not chunk:
                        break
                    chunk = tail + chunk
                    nl = chunk.rfind(b"\n")
                    if nl < 0:  # no complete line yet; keep accumulating
                        tail = chunk
                        continue
                    tail = chunk[nl + 1:]
                    d = parse_criteo_chunk(chunk[: nl + 1],
                                           use_native=use_native,
                                           where=path)
                    if not put(d if transform is None else transform(d)):
                        return
                if tail and not stop.is_set():
                    d = parse_criteo_chunk(tail, use_native=use_native,
                                           where=path)
                    if not put(d if transform is None else transform(d)):
                        return
            put(_SENTINEL)
        except BaseException as e:  # surface parse errors to the consumer
            put(e)

    threading.Thread(target=produce, daemon=True).start()

    # linear batching: one concat of the (< batch_size) leftover per
    # chunk; yielded batches are views into the chunk's arrays
    buf = None
    pos = 0
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            if buf is None or pos >= len(buf["y"]):
                buf, pos = item, 0
            else:
                buf = {k: np.concatenate([buf[k][pos:], item[k]])
                       for k in buf}
                pos = 0
            n = len(buf["y"])
            while pos + batch_size <= n:
                yield {k: v[pos:pos + batch_size] for k, v in buf.items()}
                pos += batch_size
        if stats is not None:  # rows short of one final batch, dropped
            stats["dropped_rows"] = (len(buf["y"]) - pos) if buf else 0
    finally:
        stop.set()


def log_transform(dense: np.ndarray,
                  mask: np.ndarray | None = None) -> np.ndarray:
    """Standard Criteo numeric preprocessing: ``log1p(max(x, 0))``, with
    masked-out (missing) cells staying 0. Negative raw values (I2 can be
    −1..−3) clamp to 0 before the log."""
    out = np.log1p(np.maximum(np.asarray(dense, np.float32), 0.0))
    if mask is not None:
        out = out * np.asarray(mask, np.float32)
    return out
