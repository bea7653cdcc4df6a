"""libsvm text format reader/writer — a copy of
``minips_tpu/data/libsvm.py`` (the reference's parser family, SURVEY.md §2
"Data loading": libsvm/text parsers, LabeledSample).

Format: ``label idx:val idx:val ...`` per line (a9a/RCV1 ship this way —
BASELINE.json:7). The Python reader is vectorized per chunk; a C++ reader
(cpp/) accelerates the same contract when built (SURVEY.md §2.1 item 6) —
``read_libsvm`` transparently uses it when available.

Output is padded fixed-width arrays (idx [N, F], val [N, F], mask), the
static shapes a batch of the fused step has; F = max features per row (or
the given cap, truncating the tail).
"""

from __future__ import annotations

import numpy as np


def write_libsvm(path: str, y: np.ndarray, idx: np.ndarray,
                 val: np.ndarray, mask: np.ndarray) -> None:
    with open(path, "w") as f:
        for r in range(len(y)):
            feats = " ".join(
                f"{int(i)}:{float(v):g}"
                for i, v, m in zip(idx[r], val[r], mask[r]) if m)
            f.write(f"{int(y[r])} {feats}\n")


def read_libsvm(path: str, max_features: int | None = None,
                use_native: bool = True, shared: bool = False):
    """Returns dict(y [N] float32, idx [N, F] int32, val [N, F] float32,
    mask [N, F] float32). ``shared=True``: under the launcher, only the
    host's local leader parses; colocated processes mmap the same copy
    (data/shm_store.py)."""
    if shared:
        from minips_tpu_torch.data.shm_store import make_tag, shared_load

        tag = make_tag("libsvm", path, max_features)
        return shared_load(tag, lambda: read_libsvm(
            path, max_features, use_native=use_native, shared=False))
    if use_native:
        try:
            from minips_tpu_torch.data.native import read_libsvm_native

            out = read_libsvm_native(path, max_features)
            if out is not None:
                return out
        except ImportError:
            pass
    with open(path) as f:
        return parse_libsvm_lines(f, max_features=max_features)


def parse_libsvm_lines(lines, max_features: int | None = None,
                       width: int | None = None) -> dict:
    """Parse an iterable of libsvm lines (str or bytes) into the same
    padded dict as :func:`read_libsvm`. ``width`` fixes the padded feature
    count — block-wise streaming (data/blocks.py) needs every block to
    produce the same static shape regardless of which rows landed in it."""
    rows = []
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode()
        parts = line.split()
        if not parts:
            continue
        label = float(parts[0])
        pairs = [p.split(":") for p in parts[1:]]
        rows.append((label,
                     np.array([int(i) for i, _ in pairs], np.int32),
                     np.array([float(v) for _, v in pairs], np.float32)))
    n = len(rows)
    if width is None:
        width = max((len(r[1]) for r in rows), default=0)
        if max_features is not None:
            width = min(width, max_features)
    y = np.zeros(n, np.float32)
    idx = np.zeros((n, width), np.int32)
    val = np.zeros((n, width), np.float32)
    mask = np.zeros((n, width), np.float32)
    for r, (label, ii, vv) in enumerate(rows):
        y[r] = label
        k = min(len(ii), width)
        idx[r, :k] = ii[:k]
        val[r, :k] = vv[:k]
        mask[r, :k] = 1.0
    # normalize labels {-1,1} -> {0,1} (a9a convention)
    if y.size and y.min() < 0:
        y = (y > 0).astype(np.float32)
    return {"y": y, "idx": idx, "val": val, "mask": mask}


def parse_libsvm_block(data: bytes, width: int,
                       use_native: bool = True,
                       where: str = "<bytes>") -> dict:
    """Parse a raw bytes chunk of whole libsvm lines to the padded block
    schema at fixed ``width`` — the distributed block path's parser
    (data/blocks.py assigns byte ranges; this reads each once and parses
    natively, ~6x the Python line loop; the Python path stays as
    fallback/oracle)."""
    if use_native:
        try:
            from minips_tpu_torch.data.native import parse_libsvm_bytes

            out = parse_libsvm_bytes(data, width, where=where)
            if out is not None:
                return out
        except ImportError:
            pass
    return parse_libsvm_lines(data.splitlines(), width=width)


def detect_one_based(data: dict) -> bool:
    """True iff every present feature index is >= 1 — the canonical
    libsvm convention (a9a/RCV1 index from 1)."""
    present = data["mask"] > 0
    return bool(present.any() and data["idx"][present].min() >= 1)


def apply_one_based_shift(data: dict) -> dict:
    """Shift present indices down by one (masked padding stays 0), in
    place. Callers that decide once per FILE (block streaming) pair this
    with :func:`detect_one_based` on a head sample."""
    present = data["mask"] > 0
    data["idx"] = np.where(present, data["idx"] - 1, 0).astype(np.int32)
    return data


def shift_one_based(data: dict) -> dict:
    """Canonical libsvm files (a9a/RCV1) index features from 1; the
    framework's key spaces are 0-based. If every present index is >= 1,
    shift down by one (masked padding cells stay 0). Without this, densify
    at dim=D silently drops feature D of a 1-based file. Returns the same
    dict, modified in place."""
    if detect_one_based(data):
        apply_one_based_shift(data)
    return data


def densify(data: dict, dim: int) -> dict:
    """Sparse rows -> dense [N, dim] matrix (the LR-on-a9a dense-ified
    minimum slice, SURVEY.md §7.3)."""
    n, width = data["idx"].shape
    X = np.zeros((n, dim), np.float32)
    rows = np.repeat(np.arange(n), width)
    cols = data["idx"].reshape(-1)
    vals = (data["val"] * data["mask"]).reshape(-1)
    # cols >= 0 too: a mistaken one-based shift of a 0-based row yields
    # idx -1, and numpy would silently wrap it into column dim-1
    keep = (cols >= 0) & (cols < dim)
    np.add.at(X, (rows[keep], cols[keep]), vals[keep])
    return {"x": X, "y": data["y"]}
