"""The port's sharded parameter server against the JAX package's.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``parallel/mesh.py:run_ranks``; the rank bodies are in
``torch_sharded_ranks.py``, which imports no JAX). Every scenario runs
there on ``DenseTable``, ``SparseTable`` and ``PSTrainStep`` with
``group=``, and here on the JAX package's tables on ``make_mesh(n)``, from
the same seeded numpy inputs and weights; the parametrised tests hold the
two against each other, and the ranks against the port on one device
(``group=None``, in this process).

Tolerances:

- Pulls, padding, shard sizes, loaded states: exact.
- Against the port on one device: exact wherever the arithmetic is the
  same, each key's update on its owner (pushes, push_keys, the sparse
  pushes, whose owners add every rank's rows in the concatenated order);
  a clipped push to 1e-7 absolute (the sum of squares adds up the shards
  in another order, so the clip scale and the update differ in their last
  bits: a few ulps of params below 1).
- Against JAX, state to 1e-6 absolute as ``test_torch_tables.py`` holds
  f32 state, and losses to 1e-5 relative, at every updater and ``comm``.
  The fused step sums the ranks' gradients in rank order, as JAX's CPU
  reduce-scatter does, but each rank's gradient comes from another
  framework's kernels, so they differ in their last bits. Through the
  int8 or bf16 codec, or into adam8's codes and adam_bf16's moments, such
  a gradient element can round to the neighbouring code (one step, up to
  lr of a weight under Adam); these inputs put none within that distance
  of a rounding boundary (the compressed steps agree to 6e-8), so a
  stored code or bf16 moment is held to one step of JAX's and everything
  else to 1e-6.
- The LR + MLP pair as ``test_torch_ps_step.py`` holds it (f32 and bf16
  tower).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree
import pytest
import torch

import torch_sharded_ranks as ranks
from minips_tpu.data import synthetic
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.tables import dense as jdense
from minips_tpu.tables import sparse as jsparse
from minips_tpu.tables import updaters as jupd
from minips_tpu_torch import interop
from minips_tpu_torch.parallel.mesh import run_ranks
from minips_tpu_torch.tables import dense as tdense
from minips_tpu_torch.tables import sparse as tsparse

WORLD_SIZES = (2, 4)
SPAWN_TIMEOUT = 300.0
F, H, B = 12, 7, 32          # the dense model: 98 keys; the global batch
LR = 1e-2
STEPS = 3
S, D, KEYS_PER_RANK = 1 << 10, 8, (16, 3)


# ------------------------------------------------------------------ inputs
def _template(seed=10):
    rng = np.random.default_rng(seed)
    return {"b1": (rng.normal(size=H) * 0.1).astype(np.float32),
            "w1": (rng.normal(size=(F, H)) * 0.3).astype(np.float32),
            "w2": (rng.normal(size=H) * 0.3).astype(np.float32)}


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in _template().items()}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, F)).astype(np.float32),
            "y": (rng.random(B) > 0.5).astype(np.float32)}


def _jax_grad_fn(params, batch):
    def loss(p):
        logits = jnp.tanh(batch["x"] @ p["w1"] + p["b1"]) @ p["w2"]
        y = batch["y"]
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    return jax.value_and_grad(loss)(params)


def _dense_cases():
    keys = np.random.default_rng(5).integers(0, 98, 40)
    keys[:4] = (3, 3, 97, 0)        # repeated, the last key, the first
    vals = [np.random.default_rng(s).normal(size=40).astype(np.float32)
            for s in (6, 7)]
    mask = {"b1": np.zeros(H, np.float32), "w1": np.ones((F, H), np.float32),
            "w2": np.ones(H, np.float32)}
    pushes = [("push", _grad_tree(1)), ("push", _grad_tree(2))]
    steps = [("step", _batch(20 + i % 2), "float32", 1)
             for i in range(STEPS)]

    def steps_at(comm, accum=1):
        return [(op, b, comm, accum) for op, b, _, _ in steps]

    def case(updater, ops, **kw):
        return {"kind": "dense", "template": _template(), "updater": updater,
                "lr": LR, "kwargs": kw, "ops": ops}

    out = [("pull_adam", dict(case("adam", []),
                              pull_keys=np.array([0, 5, 97, 3, 3])))]
    for u in ("adagrad", "adam", "adam_bf16", "adam8"):
        out.append((f"push_{u}", case(u, pushes)))
    out.append(("push_clip", case("adam", pushes, clip_norm=0.5)))
    for u in ("adam", "adam8"):
        out.append((f"push_keys_{u}", case(u, [
            ("push_keys", keys, vals[0]), ("push_keys", keys[::-1].copy(),
                                           vals[1])])))
    for comm in ("float32", "bfloat16", "int8"):
        out.append((f"step_{comm}", case("adam", steps_at(comm))))
    out.append(("step_accum2", case("adam", steps_at("float32", 2))))
    out.append(("step_clip", case("adam", steps, clip_norm=0.05)))
    for u in ("adagrad", "adam_bf16", "adam8"):
        out.append((f"step_{u}", case(u, steps)))
    out.append(("step_adamw_mask", case("adamw", steps, weight_decay=0.1,
                                        decay_mask=mask)))
    return out


DENSE_CASES = _dense_cases()
DENSE_NAMES = [name for name, _ in DENSE_CASES]
EXACT_ON_ONE_DEVICE = [n for n in DENSE_NAMES
                       if n.startswith(("pull", "push_a", "push_keys"))]
SPARSE_UPDATERS = ("sgd", "adagrad", "adam")


def _sparse_keys(n, seed):
    """Each rank's [16, 3] keys, drawn from 40 ids so that keys repeat
    within a rank and across ranks; and their gradient rows."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 40, 40)
    keys = [pool[rng.integers(0, 40, KEYS_PER_RANK)] for _ in range(n)]
    grads = [rng.normal(size=KEYS_PER_RANK + (D,)).astype(np.float32)
             for _ in range(n)]
    return keys, grads


def _sparse_init(updater):
    t = jsparse.SparseTable(S, D, make_mesh(1), updater=updater, lr=0.05,
                            init_scale=0.1, seed=3)
    return t.state_dict()


def _sparse_cases(n):
    out = []
    for u in SPARSE_UPDATERS:
        rounds = [_sparse_keys(n, 30 + r) for r in range(2)]
        out.append((f"sparse_{u}", {
            "kind": "sparse", "num_slots": S, "dim": D, "updater": u,
            "lr": 0.05, "init": _sparse_init(u),
            "keys": [k for k, _ in rounds], "grads": [g for _, g in rounds]}))
    return out


# --------------------------------------------------------- the LR + MLP pair
def _jax_pair(cd, mesh):
    """bench.py:339-367 on ``mesh``, as ``test_torch_ps_step.py`` builds
    it on one device."""
    from minips_tpu.models import lr as lr_model
    from minips_tpu.models import mlp as mlp_model
    from minips_tpu.models import wide_deep as wd_model
    from minips_tpu.tables.dense import DenseTable
    from minips_tpu.tables.sparse import SparseTable
    from minips_tpu.train.ps_step import PSTrainStep

    wide_t = SparseTable(PAIR_S, 1, mesh, name="wide", updater="adagrad",
                         lr=0.05, init_scale=0.0, salt=1)
    lin_t = DenseTable(lr_model.init(13), mesh, name="lin",
                       updater="adagrad", lr=0.05)

    def lr_loss(dp, rows, batch):
        logits = (jnp.sum(rows["wide"][..., 0], axis=-1)
                  + lr_model.logits_dense(dp, batch["dense"]))
        return lr_model.bce_with_logits(logits, batch["y"])

    lr_step = PSTrainStep(lr_loss, dense=lin_t, sparse={"wide": wide_t},
                          key_fns={"wide": lambda b: b["cat"]})
    emb_t = SparseTable(PAIR_S, 8, mesh, name="emb", updater="adagrad",
                        lr=0.05, init_scale=0.01, salt=2)
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


PAIR_B, PAIR_S = 256, 1 << 10
PAIR_TOL = {  # test_torch_ps_step.py's
    "float32": {"loss": dict(rtol=1e-5, atol=0), "rows": 1e-6,
                "lin": 1e-6, "deep": 2e-6},
    "bfloat16": {"loss": dict(rtol=0, atol=1e-3), "rows": 1e-4,
                 "lin": 1e-4, "deep": 6e-3},
}


def _jax_pair_run(dtype, n):
    jlr, jmlp, jt = _jax_pair(getattr(jnp, dtype), make_mesh(n))
    init = {name: jt[name].state_dict() for name in ("wide", "emb")}
    for name in ("lin", "deep"):
        init[name] = (np.asarray(jt[name].params),
                      [np.asarray(x) for x in
                       jax.tree.leaves(jt[name].opt_state)])
    data = [synthetic.criteo_like(PAIR_B, seed=s) for s in (0, 1)]
    losses = []
    for i in range(STEPS):
        jb = jlr.shard_batch(data[i % 2])
        losses.append([float(jlr(jb)), float(jmlp(jb))])
    final = {name: jt[name].state_dict() for name in ("wide", "emb")}
    for name in ("lin", "deep"):
        final[name] = (np.asarray(jt[name].params),
                       [np.asarray(x) for x in
                        jax.tree.leaves(jt[name].opt_state)])
    return init, {"losses": losses, **final}


# ---------------------------------------------------------- save and load
SL_TEMPLATE = {"w": np.random.default_rng(40).normal(size=(8, 6))
               .astype(np.float32)}   # 48 keys: padded 48 at n = 1, 2, 4
SL_SPARSE = {"num_slots": S, "dim": 4, "updater": "adam", "lr": 0.05}


def _one_device_save_load(n):
    """The state the ranks load (written on one device after a push) and
    the spec that carries it."""
    dense = tdense.DenseTable(ranks.tensors(SL_TEMPLATE, "cpu"),
                              updater="adam", lr=1e-2, device="cpu")
    sparse = tsparse.SparseTable(S, 4, updater="adam", lr=0.05, seed=9,
                                 device="cpu")
    dense.push(ranks.tensors(_grad_like(SL_TEMPLATE, 41), "cpu"))
    keys, grads = _sparse_keys(n, 42)
    grads = [g[..., :4].copy() for g in grads]
    sparse.push(np.concatenate(keys), torch.as_tensor(np.concatenate(grads)))
    return {"kind": "save_load", "template": SL_TEMPLATE,
            "dense_state": interop.dense_to_numpy(dense),
            "sparse": dict(SL_SPARSE, init=interop.sparse_to_numpy(sparse)),
            "sparse_state": interop.sparse_to_numpy(sparse),
            "dense_grad": _grad_like(SL_TEMPLATE, 43),
            "keys": keys, "grads": grads}


def _grad_like(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in tree.items()}


# ----------------------------------------------------------- the JAX side
def _jax_dense(spec, n):
    mesh = make_mesh(n)
    kw = dict(spec["kwargs"])
    if "decay_mask" in kw:
        kw["decay_mask"] = {k: jnp.asarray(v)
                            for k, v in kw["decay_mask"].items()}
    t = jdense.DenseTable({k: jnp.asarray(v)
                           for k, v in spec["template"].items()}, mesh,
                          updater=spec["updater"], lr=spec["lr"],
                          updater_kwargs=kw)
    out = {"padded": t.padded,
           "pull": np.asarray(ravel_pytree(t.pull())[0]),
           "losses": []}
    if "pull_keys" in spec:
        out["pull_keys"] = np.asarray(t.pull_keys(spec["pull_keys"]))
    step = None
    for op in spec["ops"]:
        if op[0] == "push":
            t.push({k: jnp.asarray(v) for k, v in op[1].items()})
        elif op[0] == "push_keys":
            t.push_keys(op[1], jnp.asarray(op[2]))
        else:
            _, batch, comm, accum = op
            if step is None:
                step = t.make_step(_jax_grad_fn, comm=comm, accum=accum)
            out["losses"].append(float(t.step_inplace(
                step, {k: jnp.asarray(v) for k, v in batch.items()})))
    out["params"] = np.asarray(t.params)
    out["opt"] = [np.asarray(x) for x in jax.tree.leaves(t.opt_state)]
    return out


def _jax_sparse(spec, n):
    t = jsparse.SparseTable(S, D, make_mesh(n), updater=spec["updater"],
                            lr=spec["lr"])
    t.load_state_dict(spec["init"])
    pulls = []
    for keys, grads in zip(spec["keys"], spec["grads"]):
        pulls.append([np.asarray(t.pull(k)) for k in keys])
        t.push(np.concatenate(keys), jnp.asarray(np.concatenate(grads)))
    return {"pulls": pulls, "state": t.state_dict()}


def _jax_refuses(keys, n):
    tx = optax.chain(jupd.scale_by_adam_8bit(block=256),
                     optax.scale_by_learning_rate(1e-3))
    try:
        jdense.DenseTable({"w": jnp.zeros(keys)}, make_mesh(n), tx=tx)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------ the fixture
@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda n: f"n{n}")
def world(request):
    """One spawn of n gloo ranks running every scenario, the JAX package
    on make_mesh(n) and the port on one device; numpy results."""
    n = request.param
    pair_init, jax_pair = {}, {}
    for dtype in ("float32", "bfloat16"):
        pair_init[dtype], jax_pair[dtype] = _jax_pair_run(dtype, n)
    sparse_cases = _sparse_cases(n)
    save_load = _one_device_save_load(n)
    cases = (DENSE_CASES + sparse_cases + [
        (f"pair_{dtype}", {"kind": "pair", "batch": PAIR_B,
                           "num_slots": PAIR_S, "dtype": dtype,
                           "init": pair_init[dtype], "steps": STEPS})
        for dtype in ("float32", "bfloat16")] + [
        ("refuse", {"kind": "dense_refuse", "keys": 768, "block": 256}),
        ("save_load", save_load)])
    got = run_ranks(ranks.run, n, cases, device="cpu",
                    timeout=SPAWN_TIMEOUT)
    one = ranks.run(None, "cpu", [c for c in DENSE_CASES
                                  if c[0] in EXACT_ON_ONE_DEVICE
                                  or c[0] == "push_clip"]
                    + [c for c in sparse_cases] + [
                        ("refuse", {"kind": "dense_refuse", "keys": 768,
                                    "block": 256})])
    jax_ref = {name: _jax_dense(spec, n) for name, spec in DENSE_CASES}
    jax_ref.update({name: _jax_sparse(spec, n)
                    for name, spec in sparse_cases})
    jax_ref["refuse"] = _jax_refuses(768, n)
    jax_ref.update({f"pair_{d}": jax_pair[d] for d in jax_pair})
    return {"n": n, "ranks": got, "one": one, "jax": jax_ref,
            "save_load": save_load, "sparse_cases": dict(sparse_cases)}


# ------------------------------------------------------------------ checks
def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _as_float(x):
    """A state leaf as float64 values: bfloat16 (uint16 bit patterns on the
    port's side, ml_dtypes on JAX's) widened exactly."""
    x = np.asarray(x)
    if x.dtype == np.uint16 or x.dtype.name == "bfloat16":
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return x


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_dense_matches_jax(world, name):
    n, got, want = world["n"], world["ranks"][0][name], world["jax"][name]
    spec = dict(DENSE_CASES)[name]
    assert got["padded"] == want["padded"]
    assert got["shard"] * n == got["padded"]
    np.testing.assert_array_equal(got["pull"], want["pull"])
    if "pull_keys" in want:
        np.testing.assert_array_equal(got["pull_keys"], want["pull_keys"])
    comm = spec["ops"][0][2] if spec["ops"] and spec["ops"][0][0] == "step" \
        else "float32"
    assert comm in name or comm == "float32"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["params"], 1e-6)
    assert len(got["opt"]) == len(want["opt"])
    for g, w in zip(got["opt"], want["opt"]):
        assert g.shape == np.shape(w)
        if g.dtype == np.uint8:              # adam8's codes
            assert np.abs(g.astype(int) - np.asarray(w).astype(int)).max() \
                <= 1
        elif g.dtype == np.int32 or np.ndim(w) == 0:
            np.testing.assert_array_equal(g, w)
        elif g.dtype == np.uint16:           # adam_bf16's moments
            _close(_as_float(g), _as_float(w), atol=0, rtol=2.0 ** -7)
        else:
            _close(g, w, 1e-6)


@pytest.mark.parametrize("name", EXACT_ON_ONE_DEVICE + ["push_clip"])
def test_dense_shards_match_one_device(world, name):
    """Sharding is exact: each key's update runs on its owner as it runs on
    one device."""
    got, one = world["ranks"][0][name], world["one"][name]
    # the padding differs (adam8 pads to whole blocks a shard: 512 at n =
    # 2, 256 on one device; 98 keys pad to 100 at n = 4): the shared
    # prefix holds every key, the rest stays padding
    k = len(one["params"])
    assert not got["params"][k:].any()
    if name == "push_clip":
        _close(got["params"][:k], one["params"], 1e-7)
        return
    np.testing.assert_array_equal(got["params"][:k], one["params"])
    for g, o in zip(got["opt"], one["opt"]):
        np.testing.assert_array_equal(g[:len(o)] if g.ndim else g, o)


def test_every_rank_holds_the_same_global_state(world):
    first = world["ranks"][0]
    assert all(r["_jax"] == [] for r in world["ranks"])  # no JAX on a rank
    for other in world["ranks"][1:]:
        for name in DENSE_NAMES:
            np.testing.assert_array_equal(other[name]["params"],
                                          first[name]["params"])
            assert other[name]["losses"] == first[name]["losses"]
        for name in ("pair_float32", "pair_bfloat16"):
            assert other[name]["losses"] == first[name]["losses"]


@pytest.mark.parametrize("updater", SPARSE_UPDATERS)
def test_sparse_pull_and_push_match_jax(world, updater):
    name = f"sparse_{updater}"
    n, want = world["n"], world["jax"][name]
    for rank, got in enumerate(r[name] for r in world["ranks"]):
        assert got["shard_rows"] == S // n
        for rnd, rows in enumerate(got["pulls"]):
            # the owners' gathers equal XLA's gather on the sharded table
            np.testing.assert_array_equal(rows, want["pulls"][rnd][rank])
    got = world["ranks"][0][name]["state"]
    assert sorted(got) == sorted(want["state"])
    for k in want["state"]:
        if k in ("layout", "steps"):
            np.testing.assert_array_equal(got[k], want["state"][k])
        else:
            _close(got[k], want["state"][k], 1e-6)


@pytest.mark.parametrize("updater", SPARSE_UPDATERS)
def test_sparse_push_matches_one_device(world, updater):
    """The owners add every rank's rows in the concatenated order: the
    one-device push of all ranks' keys, bit for bit."""
    name = f"sparse_{updater}"
    spec = world["sparse_cases"][name]
    t = tsparse.SparseTable(S, D, updater=updater, lr=0.05, device="cpu")
    interop.load_sparse(t, spec["init"])
    for keys, grads in zip(spec["keys"], spec["grads"]):
        t.push(np.concatenate(keys), torch.as_tensor(np.concatenate(grads)))
    want = interop.sparse_to_numpy(t)
    got = world["ranks"][0][name]["state"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_three_steps_match_jax(world, dtype):
    n, tol = world["n"], PAIR_TOL[dtype]
    got, want = world["ranks"][0][f"pair_{dtype}"], \
        world["jax"][f"pair_{dtype}"]
    assert got["batch_rows"] == PAIR_B // n
    assert "must divide by the group size" in got["odd_batch"]
    np.testing.assert_allclose(got["losses"], want["losses"], **tol["loss"])
    for name in ("wide", "emb"):
        _close(got[name]["emb"], want[name]["emb"], tol["rows"])
        _close(got[name]["accum"], want[name]["accum"], tol["rows"])
    for name in ("lin", "deep"):
        params, leaves = got[name]
        jparams, jleaves = want[name]
        _close(params, jparams, tol[name])
        for g, w in zip(leaves, jleaves):
            _close(g, w, tol[name])


def test_adam8_refuses_a_shard_of_part_blocks(world):
    """768 keys are 3 blocks of 256: whole on one device, part blocks on
    each shard at n = 2 and 4, where both packages refuse the custom
    quantized updater."""
    assert world["one"]["refuse"]["error"] is None
    assert world["jax"]["refuse"] is not None
    assert "whole blocks" in world["ranks"][0]["refuse"]["error"]


def test_saved_at_one_device_loads_at_n_and_back(world):
    spec, got = world["save_load"], world["ranks"][0]["save_load"]
    (params, leaves), sparse = got["loaded"]
    np.testing.assert_array_equal(params, spec["dense_state"][0])
    for g, w in zip(leaves, spec["dense_state"][1]):
        np.testing.assert_array_equal(g, w)
    for k, v in spec["sparse_state"].items():
        np.testing.assert_array_equal(sparse[k], v)
    # the state written at n loads on one device, and the same pushes there
    # give it bit for bit
    dense = tdense.DenseTable(ranks.tensors(SL_TEMPLATE, "cpu"),
                              updater="adam", lr=1e-2, device="cpu")
    interop.load_dense(dense, *spec["dense_state"])
    dense.push(ranks.tensors(spec["dense_grad"], "cpu"))
    table = tsparse.SparseTable(S, 4, updater="adam", lr=0.05, device="cpu")
    interop.load_sparse(table, spec["sparse_state"])
    table.push(np.concatenate(spec["keys"]),
               torch.as_tensor(np.concatenate(spec["grads"])))
    back = tdense.DenseTable(ranks.tensors(SL_TEMPLATE, "cpu"),
                             updater="adam", lr=1e-2, device="cpu")
    interop.load_dense(back, *got["dense"])
    for a, b in ((interop.dense_to_numpy(back), got["dense"]),
                 (interop.dense_to_numpy(dense), got["dense"])):
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)
    want = interop.sparse_to_numpy(table)
    for k in want:
        np.testing.assert_array_equal(got["sparse"][k], want[k])


def test_dense_state_loads_only_at_the_same_padding(world):
    """98 keys pad to 98 at n = 2 and to 100 at n = 4: a flat state carries
    to one device only where the padding agrees."""
    n, got = world["n"], world["ranks"][0]["pull_adam"]
    table = tdense.DenseTable(ranks.tensors(_template(), "cpu"),
                              updater="adam", lr=LR, device="cpu")
    if got["padded"] == table.padded:
        interop.load_dense(table, got["params"], got["opt"])
        np.testing.assert_array_equal(table.params.numpy(), got["params"])
    else:
        assert n == 4 and got["padded"] == 100
        with pytest.raises(ValueError, match="params shape"):
            interop.load_dense(table, got["params"], got["opt"])


def test_run_ranks_reraises_a_rank_error_and_ends_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        run_ranks(ranks.raise_on_rank, 2, 1, device="cpu", timeout=120.0)
    assert "KeyError: 'rank body failed'" in str(e.value)
    assert time.monotonic() - t0 < 60.0   # rank 0 was killed, not awaited


def test_run_ranks_reports_a_rank_that_dies_without_a_word():
    t0 = time.monotonic()
    # whichever the parent hears of first: the dead rank's exit, or its
    # peer's collective failing on the closed connection
    with pytest.raises(RuntimeError,
                       match=r"rank (1 of 2 exited with code 3|0 of 2 failed)"):
        run_ranks(ranks.exit_on_rank, 2, 1, device="cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_run_ranks_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="within 5.0 s"):
        run_ranks(ranks.sleep, 2, 600.0, device="cpu", timeout=5.0)
    assert time.monotonic() - t0 < 30.0
