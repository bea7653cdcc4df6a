"""The port's KV-cached decoding (``models/decode.py``) against the JAX
package's.

Small models (vocab 61, dim 32, 4 heads, 2 blocks) with the JAX package's
weights carried across, at float32 compute and cache: greedy tokens equal
the JAX ``generate``'s exactly and the argmax of the port's own
``transformer.apply`` on the growing sequence (the oracle that
``tests/test_decode.py`` pins); the prefill logits agree with the JAX
``forward_cached``'s to 1e-5. At bf16 the first greedy steps agree too
(the logits of a prompt's last position differ by bf16 roundings, far
less than the margin between the top two tokens here). The cache shapes,
the learned-position cap, keyed sampling and the MoE refusal are the JAX
package's rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import decode as jdec
from minips_tpu.models import transformer as jtfm
from minips_tpu_torch import interop
from minips_tpu_torch.models import decode as tdec
from minips_tpu_torch.models import transformer as ttfm

VOCAB, DIM, HEADS, DEPTH = 61, 32, 4, 2


def _models(kv_heads=None, rope=False, max_len=32, depth=DEPTH):
    jp = jtfm.init(jax.random.PRNGKey(0), vocab=VOCAB, dim=DIM, heads=HEADS,
                   depth=depth, max_len=max_len, kv_heads=kv_heads,
                   rope=rope)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompt(seed=0, shape=(2, 5)):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("rope", [False, True])
def test_greedy_tokens_match_jax(kv_heads, rope):
    jp, tp = _models(kv_heads, rope)
    prompt = _prompt()
    want = jdec.generate(jp, jnp.asarray(prompt, jnp.int32), 8, heads=HEADS,
                         compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    got = tdec.generate(tp, torch.from_numpy(prompt), 8, heads=HEADS,
                        compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    assert got.shape == (2, 8) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the oracle: argmax of the training forward on the growing sequence
    seq = torch.from_numpy(prompt)
    for i in range(8):
        logits = ttfm.apply(tp, seq, heads=HEADS,
                            compute_dtype=torch.float32)
        tok = torch.argmax(logits[:, -1], dim=-1)
        assert torch.equal(tok, got[:, i])
        seq = torch.cat([seq, tok[:, None]], dim=1)


@pytest.mark.parametrize("kv_heads,rope", [(None, False), (1, True)])
def test_prefill_and_step_logits_match_jax(kv_heads, rope):
    jp, tp = _models(kv_heads, rope)
    prompt = _prompt(1, (3, 6))
    jc = jdec.init_cache(jp, 3, 12, heads=HEADS, dtype=jnp.float32)
    tc = tdec.init_cache(tp, 3, 12, heads=HEADS, dtype=torch.float32)
    jl, jc = jdec.forward_cached(jp, jnp.asarray(prompt), jc, 0,
                                 heads=HEADS, compute_dtype=jnp.float32)
    tl, tc = tdec.forward_cached(tp, torch.from_numpy(prompt), tc, 0,
                                 heads=HEADS, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    jl, jc = jdec.forward_cached(jp, jnp.asarray(nxt), jc, 6, heads=HEADS,
                                 compute_dtype=jnp.float32)
    tl, tc = tdec.forward_cached(tp, torch.from_numpy(nxt), tc, 6,
                                 heads=HEADS, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    for j, t in zip(jc, tc):
        np.testing.assert_allclose(t["k"].numpy(), np.asarray(j["k"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(t["v"].numpy(), np.asarray(j["v"]),
                                   rtol=0, atol=1e-5)


def test_bf16_greedy_matches_jax():
    jp, tp = _models(2, True)
    prompt = _prompt(2)
    want = jdec.generate(jp, jnp.asarray(prompt, jnp.int32), 3, heads=HEADS)
    got = tdec.generate(tp, torch.from_numpy(prompt), 3, heads=HEADS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gqa_cache_is_group_factor_smaller():
    _, full = _models(depth=1, max_len=16)
    _, mqa = _models(1, depth=1, max_len=16)
    _, gqa = _models(2, depth=1, max_len=16)
    c_full = tdec.init_cache(full, 2, 16, heads=HEADS)
    assert c_full[0]["k"].shape == (2, 16, 4, 8)
    assert c_full[0]["k"].dtype == torch.bfloat16
    assert tdec.init_cache(mqa, 2, 16, heads=HEADS)[0]["v"].shape == \
        (2, 16, 1, 8)
    assert tdec.init_cache(gqa, 2, 16, heads=HEADS)[0]["k"].shape == \
        (2, 16, 2, 8)


def test_learned_positions_cap_decode_length():
    _, tp = _models(max_len=8, depth=1)
    with pytest.raises(ValueError, match="max_len"):
        tdec.init_cache(tp, 1, 9, heads=HEADS)
    with pytest.raises(ValueError, match="max_len"):
        tdec.generate(tp, torch.zeros(1, 4, dtype=torch.long), 5,
                      heads=HEADS)
    big = [{"k": torch.zeros(1, 9, 4, 8), "v": torch.zeros(1, 9, 4, 8)}]
    with pytest.raises(ValueError, match="positional table"):
        tdec.forward_cached(tp, torch.zeros(1, 1, dtype=torch.long), big, 0,
                            heads=HEADS)
    # rope: no table, no cap
    _, tr = _models(rope=True, max_len=8, depth=1)
    tdec.init_cache(tr, 1, 9, heads=HEADS)
    assert tdec.generate(tr, torch.zeros(1, 4, dtype=torch.long), 6,
                         heads=HEADS).shape == (1, 6)


def test_sampling_is_keyed_and_in_range():
    _, tp = _models(rope=True, depth=1)
    prompt = torch.zeros((2, 3), dtype=torch.long)

    def sample(seed):
        return tdec.generate(tp, prompt, 5, heads=HEADS, temperature=1.0,
                             generator=torch.Generator().manual_seed(seed))

    a = sample(7)
    assert torch.equal(a, sample(7)) and a.shape == (2, 5)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB
    assert any(not torch.equal(a, sample(s)) for s in range(8, 12))
    with pytest.raises(ValueError, match="torch.Generator"):
        tdec.generate(tp, prompt, 2, heads=HEADS, temperature=0.5)


def test_moe_blocks_are_refused():
    tp = ttfm.init_moe_lm(torch.Generator().manual_seed(0), vocab=VOCAB,
                          dim=DIM, heads=HEADS, depth=1, max_len=16,
                          num_experts=2, expert_hidden=8, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tdec.init_cache(tp, 1, 8, heads=HEADS)
    with pytest.raises(ValueError, match="MoE"):
        tdec.generate(tp, torch.zeros(1, 2, dtype=torch.long), 2,
                      heads=HEADS)
