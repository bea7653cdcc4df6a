"""Plain reference of ``criteo1tb-lrmlp``: the LR + MLP pair's first steps.

Written from the configuration, in float32 with TF32 off, touching only the
rows the steps touch:

- LR: ``logit = sum_f wide[h1(id_f)] + dense . w + b``;
- MLP: ``logit = tower([dense, emb[h2(id_1)], ..., emb[h2(id_26)]])``, the
  tower 221 -> 256 -> 128 -> 1 with ReLU between;
- both losses the mean binary cross-entropy ``log(1 + e^z) - y z``;
- the tables' rows: row Adagrad on the summed gradient of each touched
  slot (``acc += g^2``, ``w -= lr g / (sqrt(acc) + eps)``, eps outside the
  root); LR's dense weights: Adagrad with eps inside the root
  (``w -= lr g / sqrt(acc + eps)``); the tower: Adam with bias correction.

The initial weights are drawn again from the seed as the configuration
draws them: a table of normals from ``torch.Generator().manual_seed(seed)``
on the CPU times its scale (the wide table's scale is 0), the tower's He
normals from another such generator, LR's weights zero. Under
``precision="control"`` every float32 store is bfloat16 and the tower's
matmul inputs float8 (``common.py``).

``readings`` returns each step's two losses, the norm of the first
gradient of each leaf and the norm of each leaf's change after the steps,
the leaves named as the program's are (``wide``, ``emb``, ``lin.w``,
``lin.b``, ``deep.w0`` ... ``deep.b2``). Imports nothing of the program.
"""

from __future__ import annotations

import math
import os

import torch

from benchmark import spec

common = spec.load_module(
    os.path.join(spec.HERE, "reference", "common.py"),
    "benchmark_reference_common")


def _bce(z, y):
    return torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def readings(config: dict, batches: list[dict], seed: int, device,
             precision: str = "f32") -> dict:
    """The readings of the first ``len(batches)`` steps (see the module
    docstring). ``batches``: the steps' ``{dense, cat, y}`` in order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = lambda x: common.store(x, precision)  # noqa: E731
    S, D = config["num_slots"], config["emb_dim"]
    tu, lu, du = (config["table_updater"], config["lin_updater"],
                  config["tower_updater"])
    sizes = ([config["num_dense"] + config["num_cat"] * D]
             + list(config["hidden"]) + [1])

    # the touched slots of each table, and each key's row among them
    idx, uniq = {}, {}
    for name, salt in config["salts"].items():
        slots = [common.slot_hash(b["cat"], S, salt) for b in batches]
        uniq[name] = torch.unique(torch.cat([s.reshape(-1) for s in slots]))
        idx[name] = [torch.searchsorted(uniq[name], s) for s in slots]

    # initial weights, drawn again from the seed
    scale = config["init"]["emb_scale"]
    full = torch.randn((S, D), generator=torch.Generator().manual_seed(seed))
    emb = (full[uniq["emb"].cpu()] * scale).to(device)
    del full
    if config["init"]["wide_scale"]:
        raise ValueError("the wide table is drawn at scale 0 only")
    tables = {"wide": torch.zeros(uniq["wide"].numel(), config["wide_dim"],
                                  device=device), "emb": emb}
    gen = torch.Generator().manual_seed(seed)
    deep = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        deep[f"w{i}"] = (torch.randn((a, b), generator=gen)
                         * math.sqrt(2.0 / a)).to(device)
        deep[f"b{i}"] = torch.zeros(b, device=device)
    lin = {"w": torch.zeros(config["num_dense"], device=device),
           "b": torch.zeros((), device=device)}
    tables = {k: st(v) for k, v in tables.items()}
    lin = {k: st(v) for k, v in lin.items()}
    deep = {k: st(v) for k, v in deep.items()}
    start = {**{k: v.clone() for k, v in tables.items()},
             **{f"lin.{k}": v.clone() for k, v in lin.items()},
             **{f"deep.{k}": v.clone() for k, v in deep.items()}}
    acc = {k: torch.full_like(v, tu["initial_accumulator"])
           for k, v in tables.items()}
    sos = {k: torch.full_like(v, lu["initial_accumulator"])
           for k, v in lin.items()}
    m = {k: torch.zeros_like(v) for k, v in deep.items()}
    v2 = {k: torch.zeros_like(v) for k, v in deep.items()}

    losses, first = [], None
    for t, b in enumerate(batches, start=1):
        grads = {}
        # LR step
        rows = tables["wide"][idx["wide"][t - 1]].requires_grad_()
        lp = {k: x.clone().requires_grad_() for k, x in lin.items()}
        z = rows[..., 0].sum(-1) + b["dense"] @ lp["w"] + lp["b"]
        loss_lr = _bce(z, b["y"])
        g_rows, *g_lin = torch.autograd.grad(loss_lr, [rows, lp["w"],
                                                       lp["b"]])
        grads["wide"] = torch.zeros_like(tables["wide"]).index_add_(
            0, idx["wide"][t - 1].reshape(-1),
            g_rows.reshape(-1, tables["wide"].shape[1]))
        grads["lin.w"], grads["lin.b"] = g_lin
        # MLP step
        rows = tables["emb"][idx["emb"][t - 1]].requires_grad_()
        dp = {k: x.clone().requires_grad_() for k, x in deep.items()}
        h = torch.cat([b["dense"], rows.reshape(rows.shape[0], -1)], -1)
        n_layers = len(sizes) - 1
        for i in range(n_layers):
            h = common.matmul(h, dp[f"w{i}"], precision) + dp[f"b{i}"]
            if i < n_layers - 1:
                h = torch.relu(h)
        loss_mlp = _bce(h[:, 0], b["y"])
        keys = sorted(dp)
        g_rows, *g_deep = torch.autograd.grad(
            loss_mlp, [rows] + [dp[k] for k in keys])
        grads["emb"] = torch.zeros_like(tables["emb"]).index_add_(
            0, idx["emb"][t - 1].reshape(-1), g_rows.reshape(-1, D))
        grads.update({f"deep.{k}": g for k, g in zip(keys, g_deep)})
        losses.append([float(loss_lr.detach()), float(loss_mlp.detach())])

        # updates
        for k in tables:
            g = grads[k]
            acc[k] = st(acc[k] + g * g)
            tables[k] = st(tables[k] - tu["lr"] * g
                           / (torch.sqrt(acc[k]) + tu["eps"]))
        for k in lin:
            g = grads[f"lin.{k}"]
            sos[k] = st(g * g + sos[k])
            lin[k] = st(lin[k] - lu["lr"] * g
                        * torch.rsqrt(sos[k] + lu["eps"]))
        for k in deep:
            g = grads[f"deep.{k}"]
            m[k] = st((1 - du["b1"]) * g + du["b1"] * m[k])
            v2[k] = st((1 - du["b2"]) * g * g + du["b2"] * v2[k])
            mh = m[k] / (1 - du["b1"] ** t)
            vh = v2[k] / (1 - du["b2"] ** t)
            deep[k] = st(deep[k] - du["lr"] * mh / (torch.sqrt(vh)
                                                    + du["eps"]))
        if t == 1:
            first = _first_gradient(grads, tables, start, acc, sos, m, lin,
                                    config, precision)
    end = {**tables, **{f"lin.{k}": v for k, v in lin.items()},
           **{f"deep.{k}": v for k, v in deep.items()}}
    return {"loss": losses, "grad": first,
            "delta": {k: _norm(end[k] - start[k]) for k in start}}


def _first_gradient(grads, tables, start, acc, sos, m, lin, config,
                    precision):
    """Each leaf's first-gradient norm: the gradient itself in float32;
    under the control, worked out from the stored state after the step as
    the program's is (``compare.py``'s rules)."""
    if precision != "control":
        return {k: _norm(g) for k, g in grads.items()}
    tu, lu, du = (config["table_updater"], config["lin_updater"],
                  config["tower_updater"])
    out = {}
    for k in tables:
        out[k] = _norm(common.grad_from_row_adagrad(
            tables[k] - start[k], acc[k], tu["lr"], tu["eps"]))
    for k in lin:
        out[f"lin.{k}"] = _norm(common.grad_from_adagrad(
            lin[k] - start[f"lin.{k}"], sos[k], lu["lr"], lu["eps"]))
    for k in m:
        out[f"deep.{k}"] = _norm(common.grad_from_adam_m(m[k], du["b1"]))
    return out
