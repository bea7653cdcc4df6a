"""Synthetic dataset generators shaped like the reference's workloads — a
numpy copy of ``minips_tpu/data/synthetic.py`` (the port imports nothing of
the JAX package), giving the same arrays from the same seeds.

They produce statistically similar data with the schemas of a9a, RCV1,
MNIST, MovieLens, Criteo and enwiki (BASELINE.json:6-12), so every app
trains and every benchmark measures the same compute and communication
shape as the real dataset would, without downloading it.
"""

from __future__ import annotations

import numpy as np


def zipf_popularity(num_keys: int, alpha: float) -> np.ndarray:
    """Normalized zipf(``alpha``) popularity over ``num_keys`` ranks —
    the one definition every skewed-key generator here shares (sparse
    features, Criteo categoricals, token unigrams, the PS bench's hot-row
    traffic) instead of ad-hoc ``1/rank**a`` copies."""
    p = 1.0 / np.arange(1, num_keys + 1, dtype=np.float64) ** alpha
    return p / p.sum()


def make_zipf_sampler(num_keys: int, alpha: float = 1.1, *,
                      spread_seed: int = 0, permute_hot: bool = True):
    """Seeded zipfian KEY sampler: returns ``sample(rng, size) ->
    int64[size]`` drawing keys with zipf(``alpha``) popularity, with the
    rank→key mapping scrambled by a FIXED permutation (``spread_seed``).

    The permutation matters for anything range-sharded (the sharded PS):
    raw zipf puts all the head mass in keys 0..k, i.e. entirely inside
    shard 0 — every hot row would be one owner's local traffic and the
    skew would never exercise the wire. Sharing ``spread_seed`` across
    ranks keeps every process's notion of 'hot rows' identical, like a
    real workload's.

    ``permute_hot=False`` keeps the raw rank→key identity — the
    PATHOLOGICAL case for a static range partition (the whole head on
    one owner), which is exactly what the heat-aware rebalancer exists
    to fix (balance/): the bench's unpermuted-zipf arms measure that
    imbalance instead of hiding it behind the permutation. The
    permuted default stays, but the skewed case is testable."""
    p = zipf_popularity(num_keys, alpha)
    if permute_hot:
        perm = np.random.default_rng(spread_seed).permutation(num_keys)
    else:
        perm = np.arange(num_keys)

    def sample(rng: np.random.Generator, size: int) -> np.ndarray:
        return perm[rng.choice(num_keys, size=size, p=p)].astype(np.int64)

    return sample


def classification_dense(n: int = 4096, dim: int = 123, seed: int = 0):
    """a9a-like dense binary classification: [N, dim] features, {0,1} labels,
    linearly separable-ish with noise."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=dim).astype(np.float32)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    logits = X @ w + rng.normal(scale=0.5, size=n).astype(np.float32)
    return {"x": X, "y": (logits > 0).astype(np.float32)}


def classification_sparse(n: int = 4096, dim: int = 47_236,
                          nnz_per_row: int = 14, seed: int = 0):
    """RCV1-like sparse rows: padded (idx, val, mask) + labels. Feature ids
    zipf-ish so hot keys exist (realistic PS traffic skew)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=dim).astype(np.float32) / np.sqrt(nnz_per_row)
    pop = zipf_popularity(dim, 0.7)  # zipf-weighted feature popularity
    idx = rng.choice(dim, size=(n, nnz_per_row), p=pop).astype(np.int32)
    val = np.abs(rng.normal(size=(n, nnz_per_row))).astype(np.float32)
    mask = np.ones((n, nnz_per_row), np.float32)
    logits = (w[idx] * val).sum(-1) + rng.normal(scale=0.3, size=n)
    return {"idx": idx, "val": val, "mask": mask,
            "y": (logits > 0).astype(np.float32)}


def mnist_like(n: int = 8192, dim: int = 784, classes: int = 10,
               seed: int = 0):
    """MNIST-shaped: 10 gaussian class blobs in [0,1]^784."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, size=(classes, dim)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    X = np.clip(centers[y] + rng.normal(scale=0.3, size=(n, dim)), 0, 1)
    return {"x": X.astype(np.float32), "y": y}


def movielens_like(n: int = 100_000, users: int = 1024, items: int = 2048,
                   rank: int = 8, seed: int = 0):
    """MovieLens-shaped implicit low-rank ratings in [0.5, 5]."""
    rng = np.random.default_rng(seed)
    U = rng.normal(scale=0.5, size=(users, rank)).astype(np.float32)
    V = rng.normal(scale=0.5, size=(items, rank)).astype(np.float32)
    u = rng.integers(0, users, size=n).astype(np.int32)
    i = rng.integers(0, items, size=n).astype(np.int32)
    r = 3.0 + (U[u] * V[i]).sum(-1) + rng.normal(scale=0.2, size=n)
    return {"user": u, "item": i,
            "rating": np.clip(r, 0.5, 5.0).astype(np.float32)}


def criteo_like(n: int = 8192, num_dense: int = 13, num_cat: int = 26,
                cat_cardinality: int = 100_000, seed: int = 0):
    """Criteo-shaped CTR rows: 13 numeric + 26 categorical (large id space,
    zipf-skewed), binary click label correlated with a hidden linear model."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, num_dense)).astype(np.float32)
    pop = zipf_popularity(cat_cardinality, 1.05)
    cats = rng.choice(cat_cardinality, size=(n, num_cat), p=pop).astype(
        np.int64)
    # distinct id spaces per field (like Criteo's per-column vocabularies)
    cats = cats + np.arange(num_cat, dtype=np.int64) * cat_cardinality
    w_dense = rng.normal(size=num_dense).astype(np.float32)
    cat_effect = ((cats % 97) / 97.0 - 0.5).sum(-1).astype(np.float32)
    logits = dense @ w_dense * 0.5 + 0.3 * cat_effect + rng.normal(
        scale=0.5, size=n)
    return {"dense": dense, "cat": cats,
            "y": (logits > 0).astype(np.float32)}


def text_corpus(vocab: int = 10_000, n_tokens: int = 200_000, seed: int = 0):
    """enwiki-shaped token stream: zipf unigram distribution with weak
    bigram structure (neighbors correlated) for skip-gram training."""
    rng = np.random.default_rng(seed)
    p = zipf_popularity(vocab, 1.05)
    tokens = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    # weak local structure: every other token copies a neighbor's topic bucket
    tokens[1::2] = (tokens[::2][: len(tokens[1::2])] + rng.integers(
        0, 50, size=len(tokens[1::2]))) % vocab
    counts = np.bincount(tokens, minlength=vocab)
    return tokens, counts


def skipgram_pairs(tokens: np.ndarray, window: int = 2, seed: int = 0):
    """(center, context) pairs from a token stream."""
    rng = np.random.default_rng(seed)
    centers, contexts = [], []
    offsets = rng.integers(1, window + 1, size=len(tokens))
    for off in range(1, window + 1):
        sel = offsets >= off
        idx = np.nonzero(sel[:-off])[0]
        centers.append(tokens[idx])
        contexts.append(tokens[idx + off])
    c = np.concatenate(centers)
    x = np.concatenate(contexts)
    perm = rng.permutation(len(c))
    return c[perm], x[perm]


def lm_sequences(n: int = 2048, seq_len: int = 128, vocab: int = 256,
                 seed: int = 0, order: int = 3):
    """Long-context LM windows [n, seq_len+1]: an order-k Markov chain over
    the vocab, so next-token loss has real learnable structure (an LM that
    trains drives cross-entropy well below log(vocab))."""
    rng = np.random.default_rng(seed)
    # deterministic transition: context hash -> a small candidate set
    a, b = rng.integers(1, vocab, size=2) | 1
    stream = list(rng.integers(0, vocab, size=order))
    noise = rng.random(n * (seq_len + 1) + order)
    jump = rng.integers(0, vocab, size=len(noise))
    for i in range(n * (seq_len + 1)):
        h = 0
        for t in stream[-order:]:
            h = (h * a + t * b) % vocab
        nxt = h if noise[i] > 0.15 else jump[i]   # 85% predictable
        stream.append(int(nxt))
    toks = np.asarray(stream[order:], dtype=np.int32)
    return {"tokens": toks.reshape(n, seq_len + 1)}
