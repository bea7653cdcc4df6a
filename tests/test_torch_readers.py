"""The port's dataset readers (``data/{libsvm,criteo,movielens,mnist,text,
native}.py``, ``utils/native_lib.py``) against the JAX package's, on files
the tests write themselves. Every comparison is exact: the readers are
host parsers whose outputs are numpy arrays. The native (C++, ``cpp/``)
and Python paths are each held against the JAX package's same path, and
the two paths against each other.
"""

from __future__ import annotations

import argparse
import gzip

import numpy as np
import pytest

from minips_tpu.data import criteo as jcriteo
from minips_tpu.data import libsvm as jlibsvm
from minips_tpu.data import mnist as jmnist
from minips_tpu.data import movielens as jmovielens
from minips_tpu.data import native as jnative
from minips_tpu.data import text as jtext
from minips_tpu_torch.data import criteo, libsvm, mnist, movielens, native
from minips_tpu_torch.data import synthetic, text
from minips_tpu_torch.utils import native_lib


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)


def test_native_library_is_found_from_the_ports_own_path():
    assert native_lib.REPO_CPP == jnative.load_native_lib.__globals__[
        "REPO_CPP"]
    # the same availability as the JAX package's copy: both build cpp/
    assert (native._load() is None) == (jnative._load() is None)


# ------------------------------------------------------------------ libsvm
@pytest.fixture
def libsvm_file(tmp_path):
    d = synthetic.classification_sparse(300, dim=500, seed=1)
    d["mask"][5] = 0.0  # a row without features
    path = str(tmp_path / "data.libsvm")
    libsvm.write_libsvm(path, 2 * d["y"] - 1, d["idx"] + 1, d["val"],
                        d["mask"])
    jpath = str(tmp_path / "jax.libsvm")
    jlibsvm.write_libsvm(jpath, 2 * d["y"] - 1, d["idx"] + 1, d["val"],
                         d["mask"])
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    return path


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("max_features", [None, 5])
def test_libsvm_matches_jax(libsvm_file, use_native, max_features):
    got = libsvm.read_libsvm(libsvm_file, max_features, use_native=use_native)
    _equal(got, jlibsvm.read_libsvm(libsvm_file, max_features,
                                    use_native=use_native))
    if use_native:  # and the native path agrees with the Python one
        _equal(got, libsvm.read_libsvm(libsvm_file, max_features,
                                       use_native=False))
    assert libsvm.detect_one_based(got) == jlibsvm.detect_one_based(got)
    shifted = libsvm.shift_one_based(dict(got))
    _equal(shifted, jlibsvm.shift_one_based(dict(got)))
    _equal(libsvm.densify(shifted, 123), jlibsvm.densify(shifted, 123))


@pytest.mark.parametrize("use_native", [True, False])
def test_libsvm_block_matches_jax(libsvm_file, use_native):
    with open(libsvm_file, "rb") as f:
        data = f.read()
    _equal(libsvm.parse_libsvm_block(data, 16, use_native=use_native),
           jlibsvm.parse_libsvm_block(data, 16, use_native=use_native))


# ------------------------------------------------------------------ criteo
@pytest.fixture
def criteo_file(tmp_path):
    rng = np.random.default_rng(2)
    n = 700
    dense = rng.integers(-3, 1000, (n, criteo.NUM_DENSE)).astype(np.float32)
    mask = (rng.random((n, criteo.NUM_DENSE)) > 0.2).astype(np.float32)
    cat = rng.integers(0, 1 << 32, (n, criteo.NUM_CAT))
    y = (rng.random(n) > 0.7).astype(np.float32)
    path = str(tmp_path / "day_0.tsv")
    criteo.write_criteo(path, y, dense, cat, mask)
    jpath = str(tmp_path / "jax.tsv")
    jcriteo.write_criteo(jpath, y, dense, cat, mask)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    return path


@pytest.mark.parametrize("use_native", [True, False])
def test_criteo_matches_jax(criteo_file, use_native):
    got = criteo.read_criteo(criteo_file, use_native=use_native)
    _equal(got, jcriteo.read_criteo(criteo_file, use_native=use_native))
    _equal(got, criteo.read_criteo(criteo_file, use_native=not use_native))
    np.testing.assert_array_equal(
        criteo.log_transform(got["dense"], got["dense_mask"]),
        jcriteo.log_transform(got["dense"], got["dense_mask"]))
    with open(criteo_file, "rb") as f:
        chunk = f.read()
    _equal(criteo.parse_criteo_chunk(chunk, use_native=use_native),
           jcriteo.parse_criteo_chunk(chunk, use_native=use_native))


@pytest.mark.parametrize("use_native", [True, False])
def test_criteo_stream_matches_jax(criteo_file, use_native):
    """Chunks of 4 KB (many lines cut across chunks), a transform on the
    producer thread, and the dropped tail reported."""
    def xform(d):
        return {"dense": criteo.log_transform(d["dense"], d["dense_mask"]),
                "cat": d["cat"], "y": d["y"]}

    runs = []
    for mod in (criteo, jcriteo):
        stats: dict = {}
        batches = list(mod.stream_criteo_batches(
            criteo_file, 64, chunk_bytes=4096, use_native=use_native,
            transform=xform, stats=stats))
        runs.append((batches, stats))
    (got, gs), (want, ws) = runs
    assert len(got) == len(want) == 700 // 64 and gs == ws == \
        {"dropped_rows": 700 % 64}
    for g, w in zip(got, want):
        _equal(g, w)
    # abandoning the stream stops its producer
    it = criteo.stream_criteo_batches(criteo_file, 64, chunk_bytes=4096)
    next(it)
    it.close()


# --------------------------------------------------------------- movielens
@pytest.mark.parametrize("name, header, sep", [
    ("ratings.csv", "userId,movieId,rating,timestamp\n", ","),
    ("ratings.dat", "", "::"),
    ("u.data", "", "\t")])
def test_movielens_matches_jax(tmp_path, name, header, sep):
    rng = np.random.default_rng(3)
    n = 500
    users = rng.integers(1, 5000, n)
    items = rng.integers(1, 130000, n)
    stars = rng.integers(1, 11, n) / 2.0
    path = tmp_path / name
    path.write_text(header + "".join(
        f"{u}{sep}{i}{sep}{r}{sep}{1000 + k}\n"
        for k, (u, i, r) in enumerate(zip(users, items, stars))) + "\n")
    got = movielens.read_ratings(str(path))
    _equal(got, jmovielens.read_ratings(str(path)))
    assert got["num_users"] == len(np.unique(users))
    assert int(got["user"].max()) + 1 == got["num_users"]


@pytest.mark.parametrize("body, match", [
    ("1,2\n", "expected >= 3 fields"), ("1::x::3::4\n", "unparseable row"),
    ("", "no ratings rows")])
def test_movielens_refuses_bad_files(tmp_path, body, match):
    path = tmp_path / "ratings.dat"
    path.write_text(body)
    with pytest.raises(ValueError, match=match):
        movielens.read_ratings(str(path))


# ------------------------------------------------------------------- mnist
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_mnist_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(4)
    images = str(tmp_path / f"images-idx3-ubyte{suffix}")
    labels = str(tmp_path / f"labels-idx1-ubyte{suffix}")
    img = rng.integers(0, 256, (37, 28, 28)).astype(np.uint8)
    lab = rng.integers(0, 10, 37).astype(np.uint8)
    mnist.write_idx(images, img)
    mnist.write_idx(labels, lab)
    jimages = str(tmp_path / f"j-images{suffix}")
    jmnist.write_idx(jimages, img)
    opener = gzip.open if suffix else open
    with opener(images, "rb") as a, opener(jimages, "rb") as b:
        assert a.read() == b.read()
    got = mnist.read_mnist(images, labels)
    _equal(got, jmnist.read_mnist(images, labels))
    assert got["x"].shape == (37, 784) and got["x"].max() <= 1.0
    floats = str(tmp_path / f"f{suffix}")
    mnist.write_idx(floats, rng.random((3, 4)).astype(np.float32))
    _equal({"a": mnist.read_idx(floats)}, {"a": jmnist.read_idx(floats)})


def test_mnist_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x02ab")
    with pytest.raises(ValueError, match="bad idx magic"):
        mnist.read_idx(str(bad))
    short = tmp_path / "short"
    short.write_bytes(b"\x00\x00\x08\x01\x00\x00\x00\x09ab")
    with pytest.raises(ValueError, match="truncated idx payload"):
        mnist.read_idx(str(short))


# -------------------------------------------------------------------- text
def test_text_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(300)]
    lines = [" ".join(rng.choice(words, rng.integers(0, 30), p=None))
             for _ in range(200)]
    path = str(tmp_path / "corpus.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    for vocab, min_count in ((50, 1), (1000, 3)):
        got = text.word_tokens(path, vocab_size=vocab, min_count=min_count)
        want = jtext.word_tokens(path, vocab_size=vocab, min_count=min_count)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    toks = text.read_bytes(path)
    np.testing.assert_array_equal(toks, jtext.read_bytes(path))
    _equal(text.byte_windows(toks, 32, max_windows=7, stride=5),
           jtext.byte_windows(toks, 32, max_windows=7, stride=5))
    _equal(text.read_lm_file(path, 64), jtext.read_lm_file(path, 64))
    with pytest.raises(ValueError, match="need at least"):
        text.byte_windows(toks[:10], 32)


# ---------------------------------------------------- the readers in apps
def test_word2vec_app_reads_a_text_file(tmp_path):
    """``--data_file`` and ``--subsample`` through the port's app: the
    pairs it trains on are the JAX app's."""
    from minips_tpu.apps import word2vec_example as jw2vx
    from minips_tpu_torch.apps import word2vec_example as tw2vx

    rng = np.random.default_rng(6)
    path = str(tmp_path / "enwik.txt")
    with open(path, "w") as f:
        for _ in range(300):
            f.write(" ".join(f"t{int(z)}" for z in rng.zipf(1.3, 40)) + "\n")
    args = argparse.Namespace(data_file=path, subsample=1e-2)
    got = tw2vx.pairs(tw2vx.DEFAULT, args, vocab=500)
    want = jw2vx._pairs(jw2vx.DEFAULT, args, vocab=500)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
