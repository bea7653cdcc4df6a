"""Text loaders — a copy of ``minips_tpu/data/text.py``: byte-level
windows for the LM family and word-level ids for word2vec.

There is no tokenizer download path: any local text/binary file becomes
LM training data at the byte level (vocab 256), the equivalent of the
reference's "read the local shard" loaders (SURVEY.md §2 "Data
loading"). Windows are sampled with a stride so a small file still yields
many distinct sequences.
"""

from __future__ import annotations

import numpy as np


def read_bytes(path: str) -> np.ndarray:
    """File -> uint8 token stream."""
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def byte_windows(tokens: np.ndarray, seq_len: int, *,
                 max_windows: int | None = None,
                 stride: int | None = None) -> dict:
    """Token stream -> {"tokens": [n, seq_len+1] int32} next-token windows.

    ``stride`` defaults to seq_len // 2 (half-overlapping windows); the
    stream must hold at least one full window.
    """
    need = seq_len + 1
    if len(tokens) < need:
        raise ValueError(f"need at least {need} tokens, file has "
                         f"{len(tokens)}")
    stride = stride or max(seq_len // 2, 1)
    starts = np.arange(0, len(tokens) - need + 1, stride)
    if max_windows is not None:
        starts = starts[:max_windows]
    idx = starts[:, None] + np.arange(need)[None, :]
    return {"tokens": tokens[idx].astype(np.int32)}


def read_lm_file(path: str, seq_len: int, *,
                 max_windows: int | None = None) -> dict:
    """Convenience: file path -> LM windows dict."""
    return byte_windows(read_bytes(path), seq_len, max_windows=max_windows)


def word_tokens(path: str, vocab_size: int = 10_000,
                min_count: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Whitespace-tokenize a text file into word ids for word2vec.

    Classic w2v preprocessing (the reference's enwiki pipeline shape):
    keep the ``vocab_size`` most frequent words with count >= min_count,
    DROP out-of-vocab tokens from the stream (w2v convention — an UNK
    bucket would dominate the unigram table), and return
    ``(ids [n] int32, counts [vocab] int64)`` where id ordering is by
    descending frequency (id 0 = most frequent; ties broken
    lexicographically for determinism). ``counts`` feeds UnigramSampler
    directly.

    Two streaming line passes (count, then map) so memory stays near the
    KEPT token stream, not several times the corpus size — this is the
    enwiki-scale path."""
    from collections import Counter

    counter: Counter = Counter()
    with open(path, "r", errors="replace") as f:
        for line in f:
            counter.update(line.split())
    if not counter:
        raise ValueError(f"{path}: no tokens")
    ranked = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
    kept = [(w, c) for w, c in ranked[:vocab_size] if c >= min_count]
    if not kept:
        raise ValueError(f"{path}: vocab filter dropped every token")
    word_to_id = {w: i for i, (w, _) in enumerate(kept)}
    chunks = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            mapped = [word_to_id[w] for w in line.split()
                      if w in word_to_id]
            if mapped:
                chunks.append(np.asarray(mapped, np.int32))
    ids = np.concatenate(chunks)
    return ids, np.asarray([c for _, c in kept], np.int64)
