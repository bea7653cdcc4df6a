"""The port's quantized collectives (``ops/quantized_comm.py``) against the
JAX package's.

- The numpy host codecs are a copy: bit-identical on the same inputs (and
  the same ``numpy.random.Generator`` state for the stochastic ones).
- ``_quantize_blocks``/``_dequantize_blocks``: bit-identical, ties
  rounded half to even as ``jnp.round`` rounds them.
- Each collective at float32, bfloat16 and int8 on n = 2 and 4 gloo ranks
  (one spawn a world size for this module, ``run_ranks``), against JAX's
  on ``make_mesh(n)`` from the same inputs. The two move the same codes
  (bit-identical) and add the decompressed contributions in float32 in
  rank order, so every all-gathered vector and every float32 and
  bfloat16 result is bit-identical. The int8 reduce's outputs (the sum,
  what was sent, the residual) are held to 2 n float32 ulps of the
  largest input: XLA fuses each dequantizing multiply into the add or
  subtract after it (one rounding, an FMA) where the port rounds the
  product first. Beside that, each is held against the exact result with the
  JAX package's own tolerances (``tests/test_quantized_comm.py``): an
  all-gather within 1e-2 (bf16) and 1.6e-2 (int8) of the largest value, a
  reduce-scatter within 4e-2 of the largest input times n (f32 1e-6).
- ``group=None`` (one device) runs the codecs with no collective, as the
  JAX functions do on ``make_mesh(1)``: bit-identical to them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharded_ranks as ranks
from minips_tpu.ops import quantized_comm as jqc
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch.ops import quantized_comm as tqc
from minips_tpu_torch.parallel.mesh import run_ranks

WORLD_SIZES = (2, 4)
SPAWN_TIMEOUT = 180.0
C = 300                       # elements a rank: not a multiple of BLOCK
FNS = [("all_gather", c) for c in ("float32", "bfloat16", "int8")] + \
      [("psum_scatter", c) for c in ("float32", "bfloat16", "int8")] + \
      [("psum_scatter_ef", c) for c in ("float32", "bfloat16", "int8")] + \
      [("a2a_reduce", c) for c in ("bfloat16", "int8")] + \
      [("gather_broadcast", c) for c in ("bfloat16", "int8")]
IDS = [f"{f}-{c}" for f, c in FNS]


# ------------------------------------------------------------- host codecs
def _rows(seed=0, n=50, dim=17):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, dim)).astype(np.float32)
    rows[3] = 0.0                                 # an all-zero row
    rows[7] *= 1e-4                               # a small one
    return rows


@pytest.mark.parametrize("stochastic", [False, True])
def test_rows_int8_codec_is_a_copy(stochastic):
    rows = _rows()
    rng = (lambda: np.random.default_rng(9)) if stochastic else \
        (lambda: None)
    jq, js = jqc.quantize_rows_int8(rows, rng())
    tq, ts = tqc.quantize_rows_int8(rows, rng())
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tqc.dequantize_rows_int8(tq, ts),
                                  jqc.dequantize_rows_int8(jq, js))


@pytest.mark.parametrize("mass,cap", [(0.9, 0.5), (0.5, 1.0), (1.0, 0.1)])
def test_topk_rows_is_a_copy(mass, cap):
    rows = _rows(1)
    rows[10] *= 30.0                              # a hot row
    np.testing.assert_array_equal(
        tqc.topk_rows(rows, mass=mass, frac_cap=cap),
        jqc.topk_rows(rows, mass=mass, frac_cap=cap))
    zero = np.zeros((4, 3), np.float32)
    np.testing.assert_array_equal(tqc.topk_rows(zero), jqc.topk_rows(zero))
    assert tqc.topk_rows(zero[:0]).size == jqc.topk_rows(zero[:0]).size == 0


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [64, 32])
@pytest.mark.parametrize("stochastic", [False, True])
def test_blockwise_codec_is_a_copy(bits, block, stochastic):
    rows = _rows(2, n=21, dim=13)                 # 273 elements: a part block
    rng = (lambda: np.random.default_rng(4)) if stochastic else \
        (lambda: None)
    jc, js = jqc.quantize_blockwise(rows, bits, block=block, rng=rng())
    tc, ts = tqc.quantize_blockwise(rows, bits, block=block, rng=rng())
    assert tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    n, dim = rows.shape
    np.testing.assert_array_equal(
        tqc.dequantize_blockwise(tc, ts, n, dim, bits, block=block),
        jqc.dequantize_blockwise(jc, js, n, dim, bits, block=block))
    assert tqc.blockwise_stream_bytes(n, dim, bits, block) == \
        jqc.blockwise_stream_bytes(n, dim, bits, block)


@pytest.mark.parametrize("top", [200, 60_000, 1 << 20, 1 << 40])
def test_key_delta_codec_is_a_copy(top):
    rng = np.random.default_rng(top % 97)
    keys = np.unique(rng.integers(0, top, 300)).astype(np.int64) + 5
    jdw, jbuf = jqc.encode_key_deltas(keys)
    tdw, tbuf = tqc.encode_key_deltas(keys)
    assert (tdw, tbuf) == (jdw, jbuf)
    np.testing.assert_array_equal(
        tqc.decode_key_deltas(tbuf, keys.size, tdw),
        jqc.decode_key_deltas(jbuf, keys.size, jdw))
    assert tqc.delta_stream_bytes(keys.size, tdw) == \
        jqc.delta_stream_bytes(keys.size, jdw) == len(tbuf)
    for edge in (keys[:0], keys[:1]):
        assert tqc.encode_key_deltas(edge) == jqc.encode_key_deltas(edge)
    with pytest.raises(ValueError, match="strictly"):
        tqc.encode_key_deltas(keys[::-1].copy())


def test_constants_and_comm_check():
    assert (tqc.VALID, tqc.BLOCK, tqc.HOST_BLOCK) == \
        (jqc.VALID, jqc.BLOCK, jqc.HOST_BLOCK)
    for comm in tqc.VALID:
        tqc._check(comm)
    with pytest.raises(ValueError, match="comm must be one of"):
        tqc._check("int4")


# ----------------------------------------------------------- block codec
def _blocks_input(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 50.0],
                                             size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    if flat.size >= 512:
        flat[:256] = 0.0                      # an all-zero block
        flat[256:512] = np.arange(256) - 127.5  # absmax 127.5: x / s ties
        flat[300] = 127.0
    return x


@pytest.mark.parametrize("shape", [(5,), (256,), (1000,), (3, 1000),
                                   (2, 4, 256), (4, 300)])
def test_quantize_blocks_bit_identical(shape):
    x = _blocks_input(shape, sum(shape))
    jq, js = jqc._quantize_blocks(jnp.asarray(x))
    tq, ts = tqc._quantize_blocks(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        tqc._dequantize_blocks(tq, ts, shape[-1]).numpy(),
        np.asarray(jqc._dequantize_blocks(jq, js, shape[-1])))


def test_quantize_blocks_rounds_half_to_even():
    x = np.zeros(256, np.float32)
    x[0] = 127.0                               # scale 1.0
    x[1:6] = (0.5, 1.5, 2.5, -0.5, -2.5)
    q, _ = tqc._quantize_blocks(torch.from_numpy(x))
    np.testing.assert_array_equal(q.reshape(-1)[:6].numpy(),
                                  [127, 0, 2, 2, 0, -2])


# --------------------------------------------------------- the collectives
def _inputs(fn, n, seed):
    """Each rank's input ([n, ...], a row a rank): C elements a chunk,
    half near 1 and half near 0.005 (a raveled model's mixed scales)."""
    rng = np.random.default_rng(seed)
    width = C if fn in ("all_gather", "gather_broadcast") else n * C
    x = rng.normal(size=(n, width)).astype(np.float32)
    x[:, width // 2:] *= 0.005
    if fn == "a2a_reduce":
        x = x.reshape(n, n, C)
    return x


def _jax_collective(fn, comm, x):
    """JAX's collective on make_mesh(n), each device given its row of x;
    the outputs as device 0..n-1 hold them."""
    n = x.shape[0]
    mesh = make_mesh(n)
    if fn == "all_gather":
        body = lambda v: (jqc.quantized_all_gather(v, "data", comm),)  # noqa
    elif fn == "psum_scatter":
        body = lambda v: (jqc.quantized_psum_scatter(v, "data", comm),)  # noqa
    elif fn == "psum_scatter_ef":
        body = lambda v: jqc.quantized_psum_scatter_ef(v, "data", comm)  # noqa
    elif fn == "a2a_reduce":
        body = lambda v: jqc.a2a_reduce(v, "data", comm)  # noqa
    else:
        body = lambda v: jqc.gather_broadcast(v, "data", comm)  # noqa
    flat = jnp.asarray(x.reshape((n * x.shape[1],) + x.shape[2:]))
    outs = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                             out_specs=P("data")))(flat)
    return [[np.asarray(o).reshape((n, -1) + o.shape[1:])[r]
             for o in outs] for r in range(n)]


def _exact(fn, x):
    """The uncompressed result on each rank: the whole vector, or the sum
    of the ranks' contributions to this rank's chunk."""
    n = x.shape[0]
    if fn in ("all_gather", "gather_broadcast"):
        return [x.reshape(-1)] * n
    chunks = x.reshape(n, n, C).astype(np.float64)
    return [chunks[:, r].sum(axis=0) for r in range(n)]


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda n: f"n{n}")
def collectives(request):
    n = request.param
    cases = [(f"{fn}-{comm}", {"kind": "collective", "fn": fn, "comm": comm,
                               "x": _inputs(fn, n, i)})
             for i, (fn, comm) in enumerate(FNS)]
    cases += [
        # n - 1 tiny contributions after one large one: a bf16 running sum
        # would drop them
        ("bf16_accumulates_in_f32", {
            "kind": "collective", "fn": "psum_scatter", "comm": "bfloat16",
            "x": np.concatenate([np.ones((1, n * 64), np.float32),
                                 np.full((n - 1, n * 64), 2.0 ** -10,
                                         np.float32)])}),
        # layernorm-like ones beside weights of 0.005, in one all-gather
        ("int8_small_tensors", {
            "kind": "collective", "fn": "all_gather", "comm": "int8",
            "x": np.concatenate([np.ones((n, 1024), np.float32),
                                 (np.random.default_rng(3).normal(
                                     size=(n, 1024)) * 0.005)
                                 .astype(np.float32)], axis=1)})]
    got = run_ranks(ranks.run, n, cases, device="cpu", timeout=SPAWN_TIMEOUT)
    return {"n": n, "ranks": got, "cases": dict(cases)}


@pytest.mark.parametrize("fn,comm", FNS, ids=IDS)
def test_collective_matches_jax(collectives, fn, comm):
    n, spec = collectives["n"], collectives["cases"][f"{fn}-{comm}"]
    want = _jax_collective(fn, comm, spec["x"])
    for r in range(n):
        got = collectives["ranks"][r][f"{fn}-{comm}"]
        assert len(got) == len(want[r])
        for i, (g, w) in enumerate(zip(got, want[r])):
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            if comm == "int8" and fn != "all_gather" and not (
                    fn == "gather_broadcast" and i == 0):
                ulp = np.finfo(np.float32).eps * np.abs(spec["x"]).max()
                np.testing.assert_allclose(g, w, rtol=0, atol=2 * n * ulp)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn,comm", FNS, ids=IDS)
def test_collective_error_bounded(collectives, fn, comm):
    n, x = collectives["n"], collectives["cases"][f"{fn}-{comm}"]["x"]
    exact = _exact(fn, x)
    big = float(np.abs(x).max())
    for r in range(n):
        got = collectives["ranks"][r][f"{fn}-{comm}"]
        if fn in ("all_gather", "gather_broadcast"):
            tol = {"float32": 0.0, "bfloat16": 1e-2, "int8": 1.6e-2}[comm]
            assert np.abs(got[0] - exact[r]).max() <= tol * big
        else:
            tol = {"float32": 1e-6, "bfloat16": 4e-2, "int8": 4e-2}[comm]
            np.testing.assert_allclose(got[0], exact[r], rtol=0,
                                       atol=tol * big * n)
        if fn == "psum_scatter_ef":     # residual = input - what was sent
            if comm == "float32":
                assert not got[1].any()
            else:
                assert np.abs(got[1]).max() <= 1.6e-2 * big


def test_bf16_push_accumulates_in_f32(collectives):
    n = collectives["n"]
    for r in range(n):
        got = collectives["ranks"][r]["bf16_accumulates_in_f32"][0]
        np.testing.assert_allclose(got, 1.0 + (n - 1) * 2.0 ** -10,
                                   rtol=1e-6)


def test_int8_block_scales_keep_small_tensors(collectives):
    spec = collectives["cases"]["int8_small_tensors"]
    got = collectives["ranks"][0]["int8_small_tensors"][0].reshape(
        collectives["n"], -1)
    small, back = spec["x"][:, 1024:], got[:, 1024:]
    assert np.abs(back).max() > 0.001
    assert np.abs(back - small).max() / np.abs(small).max() < 0.02


@pytest.mark.parametrize("fn,comm", FNS, ids=IDS)
def test_one_device_runs_the_codec_without_a_group(fn, comm):
    x = _inputs(fn, 1, 50)
    got = ranks.run(None, "cpu", [("c", {"kind": "collective", "fn": fn,
                                         "comm": comm, "x": x})])["c"]
    for g, w in zip(got, _jax_collective(fn, comm, x)[0]):
        np.testing.assert_array_equal(g, w)
