"""The port's PSTrainStep against the JAX package's, on the LR + MLP pair.

The pair is built as ``bench.py:bench_lrmlp`` builds it, cut to B = 256
and tables of 2^10 rows, both packages starting from the JAX package's
weights carried across. After 3 steps the losses and the final table and
optimizer state must agree:

- f32 compute (the MLP tower in float32): the same arithmetic up to
  summation order; losses to 1e-5 relative, state to 1e-6 absolute
  (2e-6 for the Adam tower, whose update divides by sqrt(v)).
- bf16 compute (the default): both frameworks round the tower's products
  to 8 bits of mantissa in different places. Losses to 1e-3 absolute;
  embedding rows and accumulators to 1e-4; the Adam tower's weights to
  6e-3, which is 2 * lr * steps: Adam moves a weight by about lr per step
  whatever the gradient's size, so a gradient near zero whose sign the
  rounding flips can move that weight by 2 * lr per step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minips_tpu.data import synthetic
from minips_tpu.models import lr as lr_model
from minips_tpu.models import mlp as mlp_model
from minips_tpu.models import wide_deep as wd_model
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables.dense import DenseTable
from minips_tpu.tables.sparse import SparseTable
from minips_tpu.train.ps_step import PSTrainStep
from minips_tpu_torch import interop
from minips_tpu_torch.apps.lrmlp import build_lrmlp
from minips_tpu_torch.tables import dense as tdense
from minips_tpu_torch.tables import sparse as tsparse
from minips_tpu_torch.train.ps_step import PSTrainStep as TPSTrainStep

B, S, STEPS = 256, 1 << 10, 3
TOL = {
    "float32": {"loss": dict(rtol=1e-5, atol=0), "rows": 1e-6,
                "lin": 1e-6, "deep": 2e-6},
    "bfloat16": {"loss": dict(rtol=0, atol=1e-3), "rows": 1e-4,
                 "lin": 1e-4, "deep": 6e-3},
}


def _jax_pair(cd):
    """bench.py:339-367 on a one-device mesh, the tower's compute dtype
    exposed."""
    mesh = make_mesh(1)
    wide_t = SparseTable(S, 1, mesh, name="wide", updater="adagrad",
                         lr=0.05, init_scale=0.0, salt=1)
    lin_t = DenseTable(lr_model.init(13), mesh, name="lin",
                       updater="adagrad", lr=0.05)

    def lr_loss(dp, rows, batch):
        logits = (jnp.sum(rows["wide"][..., 0], axis=-1)
                  + lr_model.logits_dense(dp, batch["dense"]))
        return lr_model.bce_with_logits(logits, batch["y"])

    lr_step = PSTrainStep(lr_loss, dense=lin_t, sparse={"wide": wide_t},
                          key_fns={"wide": lambda b: b["cat"]})
    emb_t = SparseTable(S, 8, mesh, name="emb", updater="adagrad", lr=0.05,
                        init_scale=0.01, salt=2)
    deep_t = DenseTable(
        wd_model.init_deep(jax.random.PRNGKey(0), 26, 8, 13,
                           hidden=(256, 128)),
        mesh, name="deep", updater="adam", lr=1e-3)

    def mlp_loss(dp, rows, batch):
        bsz = rows["emb"].shape[0]
        x = jnp.concatenate([batch["dense"], rows["emb"].reshape(bsz, -1)],
                            axis=-1)
        logits = mlp_model.apply(dp, x, compute_dtype=cd)[:, 0]
        return lr_model.bce_with_logits(logits, batch["y"])

    mlp_step = PSTrainStep(mlp_loss, dense=deep_t, sparse={"emb": emb_t},
                           key_fns={"emb": lambda b: b["cat"]})
    return lr_step, mlp_step, {"wide": wide_t, "lin": lin_t, "emb": emb_t,
                               "deep": deep_t}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrmlp_three_steps_match_jax(dtype):
    tol = TOL[dtype]
    jlr, jmlp, jt = _jax_pair(getattr(jnp, dtype))
    p = build_lrmlp(B, "cpu", num_slots=S,
                    mlp_compute_dtype=getattr(torch, dtype))
    interop.load_sparse(p.wide, jt["wide"].state_dict())
    interop.load_sparse(p.emb, jt["emb"].state_dict())
    for name in ("lin", "deep"):
        interop.load_dense(getattr(p, name), np.asarray(jt[name].params),
                           [np.asarray(x) for x in
                            jax.tree.leaves(jt[name].opt_state)])
    data = [synthetic.criteo_like(B, seed=s) for s in (0, 1)]
    for d, tb in zip(data, p.batches):  # the port's batches are the same
        np.testing.assert_array_equal(tb["cat"].numpy(), d["cat"])
    jl, tl = [], []
    for i in range(STEPS):
        jb = jlr.shard_batch(data[i % 2])
        jl.append([float(jlr(jb)), float(jmlp(jb))])
        tl.append([float(p.lr_step(p.batches[i % 2])),
                   float(p.mlp_step(p.batches[i % 2]))])
    np.testing.assert_allclose(tl, jl, **tol["loss"])
    for name in ("wide", "emb"):
        want, got = jt[name].state_dict(), interop.sparse_to_numpy(
            getattr(p, name))
        _close(got["emb"], want["emb"], tol["rows"])
        _close(got["accum"], want["accum"], tol["rows"])
    for name in ("lin", "deep"):
        params, leaves = interop.dense_to_numpy(getattr(p, name))
        _close(params, jt[name].params, tol[name])
        for got, want in zip(leaves, jax.tree.leaves(jt[name].opt_state)):
            _close(got, want, tol[name])


def test_grad_scale_and_sparse_only_step():
    # a sparse-only SGD step with grad_scale = batch size, against JAX
    mesh = make_mesh(1)
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 1 << 20, (32, 4))
    y = (rng.random(32) > 0.5).astype(np.float32)
    jt = SparseTable(64, 2, mesh, name="t", updater="sgd", lr=0.1)
    tt = tsparse.SparseTable(64, 2, name="t", updater="sgd", lr=0.1,
                             device="cpu")
    interop.load_sparse(tt, jt.state_dict())

    def jloss(dp, rows, b):
        return lr_model.bce_with_logits(jnp.sum(rows["t"], axis=(1, 2)),
                                        b["y"])

    def tloss(dp, rows, b):
        from minips_tpu_torch.models import lr as tlr
        return tlr.bce_with_logits(torch.sum(rows["t"], dim=(1, 2)), b["y"])

    js = PSTrainStep(jloss, sparse={"t": jt}, key_fns={"t": lambda b: b["k"]},
                     grad_scale=32.0)
    ts = TPSTrainStep(tloss, sparse={"t": tt},
                      key_fns={"t": lambda b: b["k"]}, grad_scale=32.0,
                      device="cpu")
    batch = {"k": keys, "y": y}
    for _ in range(2):
        jl = float(js(js.shard_batch(batch)))
        tl = float(ts(ts.shard_batch(batch)))
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _close(tt.emb.numpy(), jt.emb, 1e-6)


def test_step_fn_pure_and_checks():
    t = tsparse.SparseTable(16, 2, name="t", updater="adagrad",
                            device="cpu")
    d = tdense.DenseTable({"w": torch.zeros(2)}, updater="sgd",
                          device="cpu")

    def loss(dp, rows, b):
        return torch.sum(rows["t"]) + torch.sum(dp["w"])

    step = TPSTrainStep(loss, dense=d, sparse={"t": t},
                        key_fns={"t": lambda b: b["k"]}, device="cpu")
    state = step._collect_state()
    new, loss_val = step.step_fn_pure(state, {"k": torch.tensor([1, 2])})
    assert sorted(new) == ["dense", "t"] and loss_val.requires_grad is False
    assert d.params is state["dense"][0]  # the tables are not touched
    with pytest.raises(ValueError, match="grad_scale"):
        TPSTrainStep(loss, dense=d, grad_scale=0.0, device="cpu")
    with pytest.raises(ValueError, match="key_fns"):
        TPSTrainStep(loss, sparse={"t": t}, device="cpu")
    with pytest.raises(ValueError, match="reserved"):
        TPSTrainStep(loss, sparse={"dense": t},
                     key_fns={"dense": lambda b: b}, device="cpu")
    with pytest.raises(ValueError, match="needs a dense"):
        TPSTrainStep(loss, device="cpu")
    with pytest.raises(ValueError, match="floating"):
        TPSTrainStep(loss, dense=d, compute_dtype=torch.int32, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        TPSTrainStep(loss, dense=d, device="meta")
