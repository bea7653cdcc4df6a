"""The port's low-precision Adam (``adam_bf16``, ``adam8``) against the JAX
package: the updaters, the dense table's alignment and block-granular
masked restore, the interop of both leaf orders, and the LM step.

Tolerances:

- The quantizer on the same float32 input: codes and scales bit-identical.
- The updaters over 5 steps: wherever the two packages' float32 moments
  agree bit for bit (a block for adam8's codes and scale, an element for
  adam_bf16's moments), the stored state is bit-identical. Elsewhere XLA
  may fuse a multiply and an add that PyTorch rounds apart, so the float32
  moments can differ by an ulp: at least 99.9% of the codes and bf16 moments
  must still match, and no code may differ by more than one step. Scales
  to 1e-6 relative. Updates to 1e-5 relative plus 1e-7 absolute where the
  state they start from matches (an update divides two float32 moments and
  two bias corrections, each of which may differ by an ulp); where a code
  differs by one step, the moment it holds moves by up to 6% (the log
  codebook's step), so those elements are held to 6% of the largest update.
- The LM (bf16 compute, 3 steps): losses to 5e-3 absolute and params to
  2 x lr x steps, as ``test_torch_lm_step.py`` holds Adam.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import lr as jlr
from minips_tpu.models import transformer as jtfm
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables import dense as jdense
from minips_tpu.tables import updaters as jupd
from minips_tpu_torch import interop
from minips_tpu_torch.apps.lm import build_lm
from minips_tpu_torch.models import lr as tlr
from minips_tpu_torch.models import transformer as ttfm
from minips_tpu_torch.tables import dense as tdense
from minips_tpu_torch.tables import updaters as tupd

BLOCK = 256
STEPS = 5


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def _bits(x) -> np.ndarray:
    """A state leaf as integers for exact comparisons: float32 and
    bfloat16 as their bit patterns, integer leaves as they are (a torch
    tensor goes through the port's host copy, which gives bfloat16 as
    uint16)."""
    x = tdense._host(x) if torch.is_tensor(x) else np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _grads(rng, n, block):
    """A gradient of 16 ordinary blocks and one outlier block, whose one
    large element sets the block's absmax 3 decades above the rest."""
    g = rng.normal(size=n).astype(np.float32) * 0.01
    g[16 * block + 3] = 10.0
    g[16 * block + 9] = 1e-5
    return g


# ---------------------------------------------------------------- quantizer
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_block_bit_identical(signed):
    rng = np.random.default_rng(2)
    x = rng.normal(size=17 * BLOCK) * 10.0 ** rng.uniform(-8, 0, 17 * BLOCK)
    x = (x if signed else np.abs(x)).astype(np.float32)
    x[5 * BLOCK:6 * BLOCK] = 0.0          # an all-zero block
    x[7 * BLOCK + 1] = 3e4                # an outlier
    x[8 * BLOCK:8 * BLOCK + 4] = [1.0, 0.5, 0.25, 1e-9]   # ties, the floor
    jq, js = jupd._quantize_block(jnp.asarray(x), BLOCK, signed=signed)
    tq, ts = tupd._quantize_block(torch.from_numpy(x), BLOCK, signed=signed)
    assert tq.dtype == torch.uint8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    back_j = jupd._dequantize_block(jq, js, BLOCK, signed=signed)
    back_t = tupd._dequantize_block(tq, ts, BLOCK, signed=signed)
    np.testing.assert_array_equal(_bits(back_t), _bits(back_j))


def test_codebooks_are_the_jax_packages():
    for signed in (True, False):
        want = jupd._codebook(signed)
        got = tupd._codebook(signed, "cpu").numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


# ----------------------------------------------------------------- updaters
def _f32_moments(name, state, g, b1=0.9, b2=0.999):
    """Each package's float32 moments before they are stored: the JAX
    formulas on the JAX state, the port's on the port's."""
    b1f, b2f = np.float32(b1), np.float32(b2)
    if isinstance(state[0], torch.Tensor):
        tg = torch.from_numpy(g)
        c1, c2 = float(np.float32(1) - b1f), float(np.float32(1) - b2f)
        if name == "adam_bf16":
            m, v = state[1].float(), state[2].float()
        else:
            m = tupd._dequantize_block(state[1], state[2], BLOCK)
            v = tupd._dequantize_block(state[3], state[4], BLOCK, False)
        return ((float(b1f) * m + c1 * tg).numpy(),
                (float(b2f) * v + c2 * tg * tg).numpy())
    jg = jnp.asarray(g)
    if name == "adam_bf16":
        m, v = state.mu.astype(jnp.float32), state.nu.astype(jnp.float32)
        return (np.asarray(b1f * m + (1 - b1f) * jg),
                np.asarray(b2f * v + (1 - b2f) * jnp.square(jg)))
    m = jupd._dequantize_block(state.mu_q, state.mu_s, BLOCK)
    v = jupd._dequantize_block(state.nu_q, state.nu_s, BLOCK, signed=False)
    return (np.asarray(b1f * m + (1 - b1f) * jg),
            np.asarray(b2f * v + (1 - b2f) * jg * jg))


@pytest.mark.parametrize("name", ["adam_bf16", "adam8"])
def test_lowp_updater_matches_jax(name):
    rng = np.random.default_rng(7)
    n = 17 * BLOCK
    jtx, ttx = jupd.make_updater(name, 1e-3), tupd.make_updater(name, 1e-3)
    p = np.zeros(n, np.float32)
    js, ts = jtx.init(jnp.asarray(p)), ttx.init(torch.from_numpy(p))
    jleaves = jax.tree.leaves(js)
    assert len(ts) == len(jleaves) == ttx.num_leaves
    assert [_bits(t).dtype for t in ts] == [_bits(x).dtype for x in jleaves]
    stored = (1, 2) if name == "adam_bf16" else (1, 3)   # moments / codes
    matched = total = 0
    for _ in range(STEPS):
        g = _grads(rng, n, BLOCK)
        # the state each update starts from: equal (bits) where it matches
        jprev = jax.tree.leaves(js)
        same_start = np.ones(n, bool)
        for i in stored:
            same_start &= _bits(ts[i]) == _bits(jprev[i])
        if name == "adam8":   # and the scales, block by block
            for i in (2, 4):
                same_start &= np.repeat(_bits(ts[i]) == _bits(jprev[i]),
                                        BLOCK)
        jm = _f32_moments(name, js[0], g)
        tm = _f32_moments(name, ts, g)
        ju, js = jtx.update(jnp.asarray(g), js, jnp.asarray(p))
        tu, ts = ttx.update(torch.from_numpy(g), ts, torch.from_numpy(p))
        ju, tu = np.asarray(ju), tu.numpy()
        big = float(np.abs(ju).max())
        np.testing.assert_allclose(tu[same_start], ju[same_start],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tu, ju, rtol=0, atol=0.06 * big)
        jleaves = jax.tree.leaves(js)
        assert int(ts[0]) == int(jleaves[0])
        for k, i in enumerate(stored):
            got, want = _bits(ts[i]), _bits(jleaves[i])
            agree = _bits(tm[k]) == _bits(jm[k])
            # one code (or one bf16 step) at most where the float32 differ
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            if name == "adam8":
                agree = np.repeat(agree.reshape(-1, BLOCK).all(axis=1),
                                  BLOCK)
                scales_t, scales_j = ts[i + 1].numpy(), np.asarray(
                    jleaves[i + 1])
                np.testing.assert_allclose(scales_t, scales_j, rtol=1e-6)
                blocks = agree.reshape(-1, BLOCK)[:, 0]
                np.testing.assert_array_equal(_bits(scales_t)[blocks],
                                              _bits(scales_j)[blocks])
            np.testing.assert_array_equal(got[agree], want[agree])
            matched += int((got == want).sum())
            total += got.size
    assert matched >= 0.999 * total, (matched, total)


@pytest.mark.parametrize("blocks", [1, 3, 16])
def test_adam8_update_by_slices_equals_one_pass(monkeypatch, blocks):
    """adam8 updates its vector a slice of whole blocks at a time to bound
    its temporaries; slices of 1, 3 (not dividing the 17 blocks) or 16
    blocks give the one-slice update's outputs and state bit for bit."""
    rng = np.random.default_rng(11)
    n = 17 * BLOCK
    whole = tupd.make_updater("adam8", 1e-3)
    monkeypatch.setattr(tupd, "_ADAM8_SLICE", blocks * BLOCK)
    sliced = tupd.make_updater("adam8", 1e-3)
    p = torch.zeros(n)
    sw, ss = whole.init(p), sliced.init(p)
    for _ in range(3):
        g = torch.from_numpy(_grads(rng, n, BLOCK))
        uw, sw = whole.update(g, sw, p)
        us, ss = sliced.update(g, ss, p)
        np.testing.assert_array_equal(_bits(uw), _bits(us))
        for a, b in zip(sw, ss):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_lowp_updaters_take_their_options():
    bf = tupd.make_updater("adam_bf16", 1e-3, state_dtype="float16",
                           clip_norm=1.0)
    st = bf.init(torch.zeros(8))
    assert [x.dtype for x in st] == [torch.int32, torch.float16,
                                     torch.float16]
    a8 = tupd.make_updater("adam8", 1e-3, block=4, clip_norm=1.0)
    assert a8.num_leaves == 5
    with pytest.raises(ValueError, match="divisible by block=4"):
        a8.init(torch.zeros(6))
    # an adam8 part after another stateful one restores its own leaves at
    # its offset, block by block, and the other part's per key
    both = tupd.chain(tupd.trace(0.5), a8)
    old = both.init(torch.zeros(8))
    assert len(old) == 6
    _, new = both.update(torch.arange(1.0, 9.0), old, torch.zeros(8))
    mask = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    got = both.restore(new, old, mask)
    assert torch.equal(got[0], torch.where(mask > 0, new[0], old[0]))
    want = tupd.masked_merge_adam8(tupd.Adam8bitState(*new[1:]),
                                   tupd.Adam8bitState(*old[1:]), mask)
    for g, w in zip(got[1:], want):
        assert torch.equal(g, w)
    # the untouched block keeps its codes and scale; the touched one moved
    assert torch.equal(got[2][4:], old[2][4:]) and float(got[3][1]) == 0.0
    assert not torch.equal(got[2][:4], old[2][:4])


# -------------------------------------------------------------- dense table
def _lr_batches(n, d=127, bsz=256):
    """``tests/test_dense_table.py``'s LR batches."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=d)
    data = np.random.default_rng(1)
    out = []
    for _ in range(n):
        x = data.normal(size=(bsz, d)).astype(np.float32)
        out.append({"x": x, "y": (x @ w_true > 0).astype(np.float32)})
    return out


def _tgrad(params, batch):
    return ttfm.value_and_grad(lambda p: tlr.loss_dense(p, batch), params)


def _port_run(updater, kw, batches, d=127):
    t = tdense.DenseTable(tlr.init(d, device="cpu"), name=f"t_{updater}",
                          updater=updater, lr=0.01, updater_kwargs=kw,
                          device="cpu")
    step = t.make_step(_tgrad)
    losses = [float(t.step_inplace(step, {k: torch.from_numpy(v)
                                          for k, v in b.items()}))
              for b in batches]
    nbytes = sum(x.numel() * x.element_size() for x in t.opt_state)
    return losses, nbytes, t


def _jax_losses(updater, kw, batches, mesh):
    t = jdense.DenseTable(jlr.init(127), mesh, name=f"j_{updater}",
                          updater=updater, lr=0.01, updater_kwargs=kw)
    step = t.make_step(jlr.grad_fn_dense)
    return [float(t.step_inplace(step, b)) for b in batches]


def test_adam_bf16_matches_adam_trajectory(mesh1):
    bs = _lr_batches(40)
    ref, ref_bytes, _ = _port_run("adam", {}, bs)
    lowp, lowp_bytes, t = _port_run("adam_bf16", {}, bs)
    assert lowp_bytes <= ref_bytes // 2 + 8
    np.testing.assert_allclose(lowp, ref, atol=2e-3)
    assert lowp[-1] < lowp[0] * 0.6
    vecs = [x for x in t.opt_state if x.shape == t.params.shape]
    assert len(vecs) == 2 and all(x.dtype == torch.bfloat16 for x in vecs)
    # and on the JAX package's adam_bf16 trajectory
    np.testing.assert_allclose(lowp, _jax_losses("adam_bf16", {}, bs, mesh1),
                               rtol=1e-5)


def test_adam8_blockwise_matches_adam_trajectory(mesh1):
    bs = _lr_batches(40)
    ref, ref_bytes, _ = _port_run("adam", {}, bs)
    q, q_bytes, t = _port_run("adam8", {"block": 8}, bs)
    assert q_bytes < ref_bytes * 0.55
    np.testing.assert_allclose(q, ref, atol=5e-3)
    assert q[-1] < q[0] * 0.6
    scales = [x for x in t.opt_state
              if x.dtype == torch.float32 and 1 < x.numel() < t.padded]
    assert len(scales) == 2 and all(x.numel() == t.padded // 8
                                    for x in scales)
    np.testing.assert_allclose(q, _jax_losses("adam8", {"block": 8}, bs,
                                              mesh1), rtol=1e-4)


def test_adam8_odd_size_aligns_padding(mesh1):
    """65 keys with block 8 pad to 72 on the port's one shard, as the JAX
    table pads them on a one-device mesh; training leaves the padding
    zero."""
    t = tdense.DenseTable(tlr.init(64, device="cpu"), name="odd8",
                          updater="adam8", lr=0.05,
                          updater_kwargs={"block": 8}, device="cpu")
    j = jdense.DenseTable(jlr.init(64), mesh1, name="odd8j", updater="adam8",
                          lr=0.05, updater_kwargs={"block": 8})
    assert (t.padded, t.partitioner.shard_size) == (j.padded, j.padded) == \
        (72, 72)
    step = t.make_step(_tgrad)
    losses = [float(t.step_inplace(step, {k: torch.from_numpy(v)
                                          for k, v in b.items()}))
              for b in _lr_batches(10, d=64)]
    assert losses[-1] < losses[0]
    assert (t.params[t.num_keys:] == 0).all()


def _state8(opt_state):
    return tupd.Adam8bitState(*opt_state)


def test_push_keys_adam8_blockwise_masked_restore(mesh1):
    """A masked push restores adam8's moments block by block: a block with
    no touched key keeps its codes and scale bit for bit, a mixed block
    moves its untouched keys' moments by at most one quantize round trip,
    and the port's state after each push is the JAX package's."""
    t = tdense.DenseTable({"w": torch.zeros(64)}, updater="adam8", lr=0.1,
                          updater_kwargs={"block": 8}, device="cpu")
    j = jdense.DenseTable({"w": jnp.zeros(64)}, mesh1, updater="adam8",
                          lr=0.1, updater_kwargs={"block": 8})

    def push(key):
        t.push_keys(np.array([key]), torch.tensor([1.0]))
        j.push_keys(np.array([key]), jnp.array([1.0]))
        # an update divides two float32 moments: an ulp apart at most
        np.testing.assert_allclose(t.params.numpy(), np.asarray(j.params),
                                   rtol=1e-6, atol=0)
        for got, want in zip(t.opt_state, jax.tree.leaves(j.opt_state)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        return _state8(t.opt_state)

    st = push(5)
    mu_q0, mu_s0 = st.mu_q.clone(), st.mu_s.clone()
    nu_q0, nu_s0 = st.nu_q.clone(), st.nu_s.clone()
    m0 = tupd._dequantize_block(st.mu_q, st.mu_s, 8)
    w5 = float(t.params[5])
    assert float(m0[5]) != 0.0

    st = push(60)   # another block: block 0 comes back exactly
    assert torch.equal(st.mu_q[:8], mu_q0[:8])
    assert torch.equal(st.nu_q[:8], nu_q0[:8])
    assert float(st.mu_s[0]) == float(mu_s0[0])
    assert float(st.nu_s[0]) == float(nu_s0[0])
    assert float(t.params[5]) == w5

    st = push(7)    # block 0 again, mixed: key 5 takes one round trip
    m2 = tupd._dequantize_block(st.mu_q, st.mu_s, 8)
    assert abs(float(m2[5]) - float(m0[5])) <= 0.08 * abs(float(m0[5]))
    assert float(t.params[5]) == w5
    assert float(t.params[7]) != 0.0
    del nu_s0


def test_custom_tx_adam8_and_misalign_raises():
    t = tdense.DenseTable({"w": torch.zeros(64)}, name="ctx8",
                          tx=tupd.make_updater("adam8", 0.01, block=8),
                          device="cpu")
    assert t.padded == 64
    assert t.opt_state[2].numel() == 8   # one scale per block
    t.push({"w": torch.ones(64)})
    assert float(t.pull()["w"].abs().sum()) > 0
    # a masked push through the custom tx restores block by block too
    before = [x.clone() for x in t.opt_state]
    t.push_keys(np.array([3]), torch.tensor([1.0]))
    assert torch.equal(t.opt_state[1][8:], before[1][8:])
    assert torch.equal(t.opt_state[2][1:], before[2][1:])
    # 72 keys on one shard: block 16 does not divide it, and the table
    # refuses before adam8's own length check
    with pytest.raises(ValueError, match="whole blocks"):
        tdense.DenseTable({"w": torch.zeros(72)}, name="ctx16",
                          tx=tupd.make_updater("adam8", 0.01, block=16),
                          device="cpu")


def test_quantize_roundtrip_log_codebook_relative_error():
    for signed in (True, False):
        x = np.abs(np.random.default_rng(3).normal(size=512)) \
            if not signed else np.random.default_rng(3).normal(size=512)
        x = (x * 10.0 ** np.random.default_rng(4).uniform(
            -4, 0, size=512)).astype(np.float32)
        q, s = tupd._quantize_block(torch.from_numpy(x), 64, signed=signed)
        back = tupd._dequantize_block(q, s, 64, signed=signed).numpy()
        scale = np.repeat(s.numpy(), 64)
        rel_ok = np.abs(back - x) <= 0.07 * np.abs(x) + 1e-12
        floor_ok = np.abs(x) <= 2e-6 * scale
        assert (rel_ok | floor_ok).all()


def test_adam8_outlier_block_does_not_spike_updates():
    n, block = 64, 64
    g_scale = np.ones(n, np.float32) * 0.01
    g_scale[7] = 10.0
    g_scale[9] = 1e-3
    rng = np.random.default_rng(5)
    tx8 = tupd.make_updater("adam8", 0.001, block=block)
    txf = tupd.make_updater("adam", 0.001)
    p = torch.zeros(n)
    s8, sf = tx8.init(p), txf.init(p)
    peak8 = peakf = err_num = err_den = 0.0
    for i in range(200):
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * g_scale)
        u8, s8 = tx8.update(g, s8, p)
        uf, sf = txf.update(g, sf, p)
        if i > 20:
            a8, af = u8.numpy(), uf.numpy()
            peak8 = max(peak8, float(np.abs(a8).max()))
            peakf = max(peakf, float(np.abs(af).max()))
            err_num += float(np.square(a8 - af).sum())
            err_den += float(np.square(af).sum())
    assert peak8 < 2.0 * peakf, (peak8, peakf)
    assert err_num / err_den < 0.05, err_num / err_den


# ------------------------------------------------------------------ interop
@pytest.mark.parametrize("updater,dtypes", [
    ("adam_bf16", ["int32", "bfloat16", "bfloat16"]),
    ("adam8", ["int32", "uint8", "float32", "uint8", "float32"]),
])
def test_interop_round_trip_lowp_leaf_orders(mesh1, updater, dtypes):
    tmpl = {"w": jnp.arange(300, dtype=jnp.float32) / 100,
            "b": jnp.float32(2.0)}
    jt = jdense.DenseTable(tmpl, mesh1, updater=updater, lr=0.01)
    jt.push({"w": jnp.linspace(-1, 1, 300), "b": jnp.float32(1.0)})
    leaves = [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)]
    assert [str(x.dtype) for x in leaves] == dtypes
    tt = tdense.DenseTable({"w": torch.zeros(300), "b": torch.zeros(())},
                           updater=updater, lr=0.01, device="cpu")
    assert tt.padded == jt.padded
    assert [tuple(x.shape) for x in tt.opt_state] == [x.shape for x in leaves]
    interop.load_dense(tt, np.asarray(jt.params), leaves)
    params, back = interop.dense_to_numpy(tt)
    np.testing.assert_array_equal(params, np.asarray(jt.params))
    for got, want in zip(back, leaves):
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # and back again: the port's own uint16 bit patterns load unchanged
    interop.load_dense(tt, params, back)
    for got, want in zip(interop.dense_to_numpy(tt)[1], back):
        np.testing.assert_array_equal(got, want)
    # one more push on both sides from the same state stays together
    jt.push({"w": jnp.ones(300), "b": jnp.float32(0.5)})
    tt.push({"w": torch.ones(300), "b": torch.tensor(0.5)})
    np.testing.assert_allclose(tt.params.numpy(), np.asarray(jt.params),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------- LM
VOCAB, DIM, HEADS, DEPTH, T, B, LM_STEPS, LR = 64, 64, 1, 2, 32, 4, 3, 1e-3


@pytest.mark.parametrize("opt_state,updater", [("bf16", "adam_bf16"),
                                               ("int8", "adam8")])
def test_build_lm_lowp_matches_jax_make_step(mesh1, opt_state, updater):
    lm = build_lm(B, T, dim=DIM, depth=DEPTH, vocab=VOCAB, head_chunk=16,
                  device="cpu", opt_state=opt_state)
    assert lm.heads == HEADS
    jp = jtfm.init(jax.random.PRNGKey(0), vocab=VOCAB, dim=DIM, heads=HEADS,
                   depth=DEPTH, max_len=T)
    jt = jdense.DenseTable(jp, mesh1, name="lm", updater=updater, lr=LR)
    assert jt.padded == lm.table.padded
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)]
    interop.load_dense(lm.table, np.asarray(jt.params), jleaves)
    assert lm.opt_state_bytes == sum(x.nbytes for x in jleaves)
    jstep = jt.make_step(functools.partial(jtfm.grad_fn, heads=HEADS,
                                           attn_impl="flash", head_chunk=16),
                         compute_dtype=jnp.bfloat16)
    jl, tl = [], []
    for i in range(LM_STEPS):
        b = lm.batches[i % 2]
        tl.append(float(lm.table.step_inplace(lm.step, b)))
        jl.append(float(jt.step_inplace(
            jstep, {"tokens": jnp.asarray(b["tokens"].numpy())})))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)
    params, leaves = interop.dense_to_numpy(lm.table)
    np.testing.assert_allclose(params, np.asarray(jt.params), rtol=0,
                               atol=2 * LR * LM_STEPS)
    assert int(leaves[0]) == int(jax.tree.leaves(jt.opt_state)[0]) == \
        LM_STEPS
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_build_lm_opt_state_bytes_and_refusal():
    sizes = {}
    for opt in ("f32", "bf16", "int8"):
        lm = build_lm(2, 8, dim=64, depth=1, vocab=16, device="cpu",
                      opt_state=opt)
        n, padded = lm.table.num_keys, lm.table.padded
        sizes[opt] = lm.opt_state_bytes
        want = {"f32": 4 + 8 * n, "bf16": 4 + 4 * n,
                "int8": 4 + 2 * padded + 2 * 4 * (padded // 256)}[opt]
        assert lm.opt_state_bytes == want, opt
    assert sizes["int8"] < sizes["bf16"] < sizes["f32"]
    with pytest.raises(ValueError, match="opt_state"):
        build_lm(2, 8, dim=64, depth=1, vocab=16, device="cpu",
                 opt_state="fp8")
