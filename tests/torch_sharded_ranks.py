"""Rank bodies of the sharded parity tests (``test_torch_sharded.py``,
``test_torch_quantized_comm.py``).

``minips_tpu_torch.parallel.mesh.run_ranks`` spawns fresh interpreters
that import this module by name to find the function they run, so it
imports neither JAX nor the JAX package: each rank imports torch and the
port only. Inputs arrive as numpy arrays (the same seeded arrays the JAX
reference runs on in the test process) and results go back as numpy.

Every body takes ``(group, device, cases)``, where ``cases`` is a list of
``(name, spec)``, runs every case in order on every rank (the collectives
of one case must not interleave with another's) and returns a dict of
results by name. A case that raises where a test expects it to returns
the error message instead.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from minips_tpu_torch import interop
from minips_tpu_torch.ops import quantized_comm as qc
from minips_tpu_torch.parallel.mesh import world
from minips_tpu_torch.tables.dense import DenseTable, ravel
from minips_tpu_torch.tables.sparse import SparseTable
from minips_tpu_torch.tables.updaters import (chain, scale_by_adam_8bit,
                                              scale_by_learning_rate)
from minips_tpu_torch.utils.tree import tree_map, value_and_grad


# ------------------------------------------------------------------ helpers
def tensors(tree, device):
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device), tree)


def rank_rows(x, group_rank: int, n: int):
    """Rows ``[r*B/n, (r+1)*B/n)`` of a global batch leaf."""
    b = x.shape[0] // n
    return x[group_rank * b:(group_rank + 1) * b]


def mlp_grad_fn(params, batch):
    """A two-layer tanh model's mean logistic loss and its gradient: the
    dense tables' test model, written the same way on the JAX side."""
    def loss(p):
        logits = torch.tanh(batch["x"] @ p["w1"] + p["b1"]) @ p["w2"]
        y = batch["y"]
        return torch.mean(torch.clamp(logits, min=0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))
    return value_and_grad(loss, params)


def _flat(tree) -> np.ndarray:
    return ravel(tree)[0].detach().cpu().numpy()


# ------------------------------------------------------------- dense tables
def _dense(group, device, spec):
    rank, n = world(group)
    kw = dict(spec.get("kwargs", {}))
    if "decay_mask" in kw:
        kw["decay_mask"] = tensors(kw["decay_mask"], device)
    t = DenseTable(tensors(spec["template"], device), updater=spec["updater"],
                   lr=spec["lr"], updater_kwargs=kw, device=device,
                   group=group)
    out = {"padded": t.padded, "shard": int(t.params.shape[0]),
           "pull": _flat(t.pull()), "losses": []}
    if "pull_keys" in spec:
        out["pull_keys"] = t.pull_keys(spec["pull_keys"]).cpu().numpy()
    step = None
    for op in spec["ops"]:
        if op[0] == "push":
            t.push(tensors(op[1], device))
        elif op[0] == "push_keys":
            t.push_keys(op[1], op[2])
        else:   # ("step", global batch, comm, accum)
            _, batch, comm, accum = op
            if step is None:
                step = t.make_step(mlp_grad_fn, comm=comm, accum=accum)
            b = tensors({k: rank_rows(v, rank, n) for k, v in batch.items()},
                        device)
            out["losses"].append(float(t.step_inplace(step, b)))
    out["params"], out["opt"] = interop.dense_to_numpy(t)
    return out


def _dense_refuse(group, device, spec):
    tx = chain(scale_by_adam_8bit(block=spec["block"]),
               scale_by_learning_rate(1e-3))
    try:
        DenseTable({"w": torch.zeros(spec["keys"])}, tx=tx, device=device,
                   group=group)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


# ------------------------------------------------------------ sparse tables
def _sparse_table(spec, device, group):
    t = SparseTable(spec["num_slots"], spec["dim"], updater=spec["updater"],
                    lr=spec["lr"], salt=spec.get("salt", 0), device=device,
                    group=group)
    interop.load_sparse(t, spec["init"])
    return t


def _sparse(group, device, spec):
    rank = world(group)[0]
    t = _sparse_table(spec, device, group)
    out = {"pulls": [], "shard_rows": int(t.emb.shape[0])}
    for keys, grads in zip(spec["keys"], spec["grads"]):
        out["pulls"].append(t.pull(keys[rank]).cpu().numpy())
        t.push(keys[rank], torch.as_tensor(grads[rank]))
    out["state"] = interop.sparse_to_numpy(t)
    return out


# ------------------------------------------------------- save at n, load back
def _save_load(group, device, spec):
    """A dense and a sparse table loaded from a state written at another
    group size, then stepped once; their global states go back."""
    dense = DenseTable(tensors(spec["template"], device), updater="adam",
                       lr=1e-2, device=device, group=group)
    interop.load_dense(dense, *spec["dense_state"])
    sparse = _sparse_table(spec["sparse"], device, group)
    interop.load_sparse(sparse, spec["sparse_state"])
    loaded = (interop.dense_to_numpy(dense), interop.sparse_to_numpy(sparse))
    dense.push(tensors(spec["dense_grad"], device))
    rank = world(group)[0]
    sparse.push(spec["keys"][rank], torch.as_tensor(spec["grads"][rank]))
    return {"loaded": loaded, "dense": interop.dense_to_numpy(dense),
            "sparse": interop.sparse_to_numpy(sparse)}


# ------------------------------------------------------------ the LR + MLP pair
def _pair(group, device, spec):
    from minips_tpu_torch.apps.lrmlp import build_lrmlp

    p = build_lrmlp(spec["batch"], device, num_slots=spec["num_slots"],
                    mlp_compute_dtype=getattr(torch, spec["dtype"]),
                    group=group)
    interop.load_sparse(p.wide, spec["init"]["wide"])
    interop.load_sparse(p.emb, spec["init"]["emb"])
    for name in ("lin", "deep"):
        interop.load_dense(getattr(p, name), *spec["init"][name])
    losses = []
    for i in range(spec["steps"]):
        b = p.batches[i % 2]
        losses.append([float(p.lr_step(b)), float(p.mlp_step(b))])
    try:
        p.lr_step.shard_batch({"y": np.zeros(world(group)[1] + 1)})
        odd = ""
    except ValueError as e:
        odd = str(e)
    return {"losses": losses, "odd_batch": odd,
            "batch_rows": int(p.batches[0]["y"].shape[0]),
            "wide": interop.sparse_to_numpy(p.wide),
            "emb": interop.sparse_to_numpy(p.emb),
            "lin": interop.dense_to_numpy(p.lin),
            "deep": interop.dense_to_numpy(p.deep)}


# ------------------------------------------------------ quantized collectives
def _collective(group, device, spec):
    """One collective of ``ops/quantized_comm.py`` on this rank's row of
    ``spec["x"]`` ([n, ...], one row a rank)."""
    rank = world(group)[0]
    x = torch.as_tensor(spec["x"][rank]).to(device)
    fn, comm = spec["fn"], spec["comm"]
    if fn == "all_gather":
        outs = (qc.quantized_all_gather(x, group, comm),)
    elif fn == "psum_scatter":
        outs = (qc.quantized_psum_scatter(x, group, comm),)
    elif fn == "psum_scatter_ef":
        outs = qc.quantized_psum_scatter_ef(x, group, comm)
    elif fn == "a2a_reduce":
        outs = qc.a2a_reduce(x, group, comm)
    else:
        outs = qc.gather_broadcast(x, group, comm)
    return [o.cpu().numpy() for o in outs]


def raise_on_rank(group, device, bad: int):
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if world(group)[0] == bad:
        raise KeyError("rank body failed")
    torch.distributed.all_reduce(torch.zeros(1), group=group)


def exit_on_rank(group, device, bad: int):
    """Rank ``bad`` dies without a word; the others wait for it."""
    if world(group)[0] == bad:
        os._exit(3)
    torch.distributed.all_reduce(torch.zeros(1), group=group)


def sleep(group, device, seconds: float):
    time.sleep(seconds)


KINDS = {"dense": _dense, "dense_refuse": _dense_refuse, "sparse": _sparse,
         "save_load": _save_load, "pair": _pair, "collective": _collective}


def run(group, device, cases):
    """Every case of ``cases`` in order; results by name, and under
    ``"_jax"`` the JAX modules this process has imported (none on a
    spawned rank)."""
    out = {name: KINDS[spec["kind"]](group, device, spec)
           for name, spec in cases}
    out["_jax"] = sorted({m.split(".")[0] for m in sys.modules}
                         & {"jax", "jaxlib", "optax", "minips_tpu"})
    return out
