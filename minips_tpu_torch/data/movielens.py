"""MovieLens ratings reader — a copy of ``minips_tpu/data/movielens.py``,
the real-file path for the MF workload (BASELINE.json:9: "Matrix
factorization on MovieLens-20M").

Handles both shipped formats:

- ``ratings.csv`` (ML-20M/25M): header line ``userId,movieId,rating,
  timestamp`` then comma-separated rows.
- ``ratings.dat`` (ML-1M/10M): ``UserID::MovieID::Rating::Timestamp``.
- ``u.data`` (ML-100K): tab-separated ``user item rating ts``.

Raw ids are arbitrary (1-based, sparse); they are remapped to dense
0-based indices so the SparseTables size to the number of distinct
users/items, not the max raw id.
"""

from __future__ import annotations

import numpy as np


def read_ratings(path: str) -> dict:
    """File -> {"user": [n] int32 dense ids, "item": [n] int32 dense ids,
    "rating": [n] float32, "num_users": int, "num_items": int}."""
    users: list[int] = []
    items: list[int] = []
    ratings: list[float] = []
    with open(path, "r", errors="replace") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if "::" in line:
                parts = line.split("::")
            elif "," in line:
                parts = line.split(",")
            else:
                parts = line.split()
            if len(parts) < 3:
                raise ValueError(f"{path}:{lineno}: expected >= 3 fields, "
                                 f"got {len(parts)}")
            try:
                u, i, r = int(parts[0]), int(parts[1]), float(parts[2])
            except ValueError:
                # Only ratings.csv has a header, and only on line 1 —
                # a corrupt first row in ::/tab formats must still raise.
                if lineno == 1 and "," in line:
                    continue
                raise ValueError(f"{path}:{lineno}: unparseable row "
                                 f"{line[:60]!r}") from None
            users.append(u)
            items.append(i)
            ratings.append(r)
    if not users:
        raise ValueError(f"{path}: no ratings rows")
    u_raw = np.asarray(users, np.int64)
    i_raw = np.asarray(items, np.int64)
    u_uniq, u_dense = np.unique(u_raw, return_inverse=True)
    i_uniq, i_dense = np.unique(i_raw, return_inverse=True)
    return {"user": u_dense.astype(np.int32),
            "item": i_dense.astype(np.int32),
            "rating": np.asarray(ratings, np.float32),
            "num_users": int(len(u_uniq)),
            "num_items": int(len(i_uniq))}
