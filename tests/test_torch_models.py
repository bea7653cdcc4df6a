"""The port's LR, MLP and Wide&Deep functions against the JAX package's.

At f32 compute the two run the same arithmetic; only the summation order
of a matmul may differ, so values are held to 1e-5 relative and 1e-6
absolute. At bf16 compute each framework rounds every product, bias add
and activation to 8 bits of mantissa, in places that differ: outputs are
held to 2e-2 relative and 2e-2 absolute (a few bf16 ulps of O(1) values).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.models import lr as jlr
from minips_tpu.models import mlp as jmlp
from minips_tpu.models import wide_deep as jwd
from minips_tpu_torch.models import lr as tlr
from minips_tpu_torch.models import mlp as tmlp
from minips_tpu_torch.models import wide_deep as twd

F32 = {"rtol": 1e-5, "atol": 1e-6}
BF16 = {"rtol": 2e-2, "atol": 2e-2}


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _pair(tree):
    """The same numpy leaves as a JAX dict and a torch dict."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.tensor(np.asarray(v)) for k, v in tree.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def test_lr_dense_and_sparse(rng):
    B, D, F = 32, 13, 6
    params = {"w": rng.normal(size=D).astype(np.float32),
              "b": np.float32(0.3)}
    jp, tp = _pair(params)
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = (rng.random(B) > 0.5).astype(np.float32)
    _close(tlr.logits_dense(tp, torch.from_numpy(x)),
           jlr.logits_dense(jp, jnp.asarray(x)), F32)
    _close(tlr.loss_dense(tp, {"x": torch.from_numpy(x),
                               "y": torch.from_numpy(y)}),
           jlr.loss_dense(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}),
           F32)
    rows = rng.normal(size=(B, F, 1)).astype(np.float32)
    batch = {"val": rng.random((B, F)).astype(np.float32),
             "mask": (rng.random((B, F)) > 0.2).astype(np.float32), "y": y}
    jb, tb = _pair(batch)
    _close(tlr.loss_sparse(torch.from_numpy(rows), tb, 0.1),
           jlr.loss_sparse(jnp.asarray(rows), jb, 0.1), F32)
    assert tlr.init(5, device="cpu")["w"].shape == (5,)


def test_bce_matches_beyond_softplus_threshold():
    # logaddexp, not F.softplus (linear past 20): same values at large |x|
    x = np.asarray([-40.0, -20.5, -1.0, 0.0, 1.0, 19.9, 20.5, 40.0],
                   np.float32)
    y = np.asarray([0, 1, 0, 1, 1, 0, 1, 0], np.float32)
    _close(tlr.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y)),
           jlr.bce_with_logits(jnp.asarray(x), jnp.asarray(y)),
           {"rtol": 1e-6, "atol": 0})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_and_loss(rng, dtype):
    params = jax.tree.map(np.asarray,
                          jmlp.init(jax.random.PRNGKey(0), (20, 16, 8, 5)))
    jp, tp = _pair(params)
    x = rng.normal(size=(24, 20)).astype(np.float32)
    y = rng.integers(0, 5, 24).astype(np.int32)
    jcd, tcd = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    out = tmlp.apply(tp, torch.from_numpy(x), compute_dtype=tcd)
    assert out.dtype == torch.float32
    _close(out, jmlp.apply(jp, jnp.asarray(x), compute_dtype=jcd), tol)
    _close(tmlp.loss(tp, {"x": torch.from_numpy(x),
                          "y": torch.from_numpy(y)}, compute_dtype=tcd),
           jmlp.loss(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                     compute_dtype=jcd), tol)
    if dtype == "bfloat16":  # apply's default is bf16, as in JAX
        _close(tmlp.accuracy(tp, {"x": torch.from_numpy(x),
                                  "y": torch.from_numpy(y)}),
               jmlp.accuracy(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}),
               {"rtol": 0, "atol": 1 / 24 + 1e-6})


def test_mlp_init_is_he_scaled_and_seeded():
    g = torch.Generator().manual_seed(0)
    p = tmlp.init(g, (400, 300, 2), device="cpu")
    assert sorted(p) == ["b0", "b1", "w0", "w1"]
    assert abs(float(p["w0"].std()) - (2 / 400) ** 0.5) < 5e-3
    again = tmlp.init(torch.Generator().manual_seed(0), (400, 300, 2),
                      device="cpu")
    assert torch.equal(p["w0"], again["w0"])


@pytest.mark.parametrize("use_fm", [False, True])
def test_wide_deep(rng, use_fm):
    B, F, k = 16, 26, 8
    deep = jax.tree.map(np.asarray,
                        jwd.init_deep(jax.random.PRNGKey(2), F, k, 13,
                                      hidden=(32, 16)))
    jp, tp = _pair(deep)
    wide = rng.normal(size=(B, F, 1)).astype(np.float32)
    emb = (0.1 * rng.normal(size=(B, F, k))).astype(np.float32)
    batch = {"dense": rng.normal(size=(B, 13)).astype(np.float32),
             "y": (rng.random(B) > 0.5).astype(np.float32)}
    jb, tb = _pair(batch)
    _close(twd.fm_term(torch.from_numpy(emb)), jwd.fm_term(jnp.asarray(emb)),
           F32)
    # the deep tower runs in bf16 by default in both packages
    _close(twd.loss(torch.from_numpy(wide), torch.from_numpy(emb), tp, tb,
                    use_fm=use_fm),
           jwd.loss(jnp.asarray(wide), jnp.asarray(emb), jp, jb,
                    use_fm=use_fm), BF16)
    tdeep = twd.init_deep(torch.Generator().manual_seed(0), F, k, 13,
                          hidden=(32, 16), device="cpu")
    assert {n: tuple(v.shape) for n, v in tdeep.items()} == \
        {n: v.shape for n, v in deep.items()}
