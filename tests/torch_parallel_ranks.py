"""Rank bodies of the parallel-layout parity tests
(``test_torch_parallel_mesh.py``, ``test_torch_ring_attention.py``,
``test_torch_a2a_attention.py``, ``test_torch_tensor_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_moe.py``,
``test_torch_lm_example.py``).

``minips_tpu_torch.parallel.mesh.run_ranks`` spawns fresh interpreters
that import this module by name, so it imports neither JAX nor the JAX
package. Inputs arrive as numpy arrays (the same seeded arrays, and the
JAX package's weights, that the JAX reference runs on in the test
process) and results go back as numpy.

:func:`run_cases` takes ``(group, device, cases)``, ``cases`` a list of
``(name, kind, spec)``, runs every case in order on every rank (one
case's collectives must not interleave with another's) and returns each
rank's results by name. Every case computes at float32. Gradients come
back as this rank's: the shard of a sharded leaf, and for a leaf
replicated over the group that shards the batch (or the sequence), the
sum of the ranks' shares, as shard_map's transpose sums them.
"""

from __future__ import annotations

import argparse
import contextlib
import functools

import torch

from minips_tpu_torch import interop
from minips_tpu_torch.apps import lm_example as tlmx
from minips_tpu_torch.core import config as tcfg
from minips_tpu_torch.models import transformer as tfm
from minips_tpu_torch.ops import flash_attention as tfa
from minips_tpu_torch.parallel import mesh
from minips_tpu_torch.parallel import moe as tmoe
from minips_tpu_torch.parallel.a2a_attention import a2a_attention_local
from minips_tpu_torch.parallel.partition import shard_params
from minips_tpu_torch.parallel.pipeline import gpipe
from minips_tpu_torch.parallel.ring_attention import ring_attention_local
from minips_tpu_torch.utils.metrics import MetricsLogger
from minips_tpu_torch.utils.tree import (tree_leaves, tree_rebuild,
                                        value_and_grad)

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy()


def _seq(x, r, n):
    """Rank r's shard of dim 1 of a global array."""
    t = x.shape[1] // n
    return x[:, r * t:(r + 1) * t]


def _rows(x, r, n):
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _rebuild(tree, leaves):
    return tree_rebuild(tree, iter(leaves))


def _grads(loss, leaves, specs, data_group):
    """d loss / d leaves, each leaf that ``specs`` leaves unsharded over
    ``data_group`` (None) summed over that group."""
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    dims = tree_leaves(specs) if specs is not None else [None] * len(leaves)
    return [_np(mesh.all_reduce_sum(g, data_group) if d is None else g)
            for g, d in zip(grads, dims)]


# ------------------------------------------------------------ collectives
def _collective(group, device, spec):
    r, n = mesh.world(group)
    x = torch.tensor(spec["x"][r], requires_grad=True)
    c = torch.tensor(spec["c"][r])
    op = spec["op"]
    if op == "ppermute":
        y = mesh.ppermute(x, group, spec.get("shift", 1))
    elif op == "all_to_all":
        y = mesh.all_to_all_axes(x, group, spec["split_axis"],
                                 spec["concat_axis"], spec["tiled"])
    elif op == "megatron":  # x and c replicated: x[r], c[r] are the same
        w = torch.tensor(spec["w"][r])
        y = mesh.reduce_from_group(torch.tanh(
            mesh.copy_to_group(x, group) * w), group)
    elif op == "pmean":
        y = mesh.pmean(torch.sin(x), group)
    else:
        raise ValueError(op)
    (y * c).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad)}


def _axes(group, device, spec, groups):
    n_data, model = spec["mesh"]
    dg, mg = groups(n_data, model)
    return {"data": mesh.axis_index(dg), "model": mesh.axis_index(mg),
            "data_size": mesh.world(dg)[1], "model_size": mesh.world(mg)[1]}


# ---------------------------------------------------------------- attention
def _attn_fn(impl, group):
    if impl == "ring":
        return functools.partial(ring_attention_local, group=group)
    if impl == "ring_flash":
        return functools.partial(tfa.ring_flash_attention_local, group=group)
    if impl == "a2a":
        return functools.partial(a2a_attention_local, group=group)
    if impl == "a2a_flash":
        return functools.partial(a2a_attention_local, group=group,
                                 inner=tfa.flash_attention)
    raise ValueError(impl)


def _attention(group, device, spec):
    r, n = mesh.world(group)
    dtype = DTYPES[spec.get("dtype", "float32")]
    q, k, v = (torch.from_numpy(_seq(spec[x], r, n)).to(dtype)
               .requires_grad_(True) for x in ("q", "k", "v"))
    out = _attn_fn(spec["impl"], group)(q, k, v, causal=spec["causal"],
                                        scale=spec.get("scale"))
    (out.float() * torch.from_numpy(_seq(spec["r"], r, n))).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


# ------------------------------------------------------------------ models
def _params(spec):
    return interop.tree_from_numpy(spec["params"], "cpu")


def _sp(group, device, spec):
    """``loss_sp`` (pmean) and ``apply_sp``'s logits on this rank's
    sequence shard; gradients summed over the group."""
    r, n = mesh.world(group)
    toks = torch.from_numpy(spec["tokens"]).long()
    T = toks.shape[1] - 1
    inp, tgt = _seq(toks[:, :-1], r, n), _seq(toks[:, 1:], r, n)
    params = _params(spec)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    kw = dict(heads=spec["heads"], group=group, compute_dtype=F32,
              attn_impl=spec["impl"])
    loss = tfm.loss_sp(params, inp, tgt, r * (T // n), **kw)
    out = {"loss": float(loss), "grads": _grads(loss, leaves, None, group)}
    with torch.no_grad():
        out["logits"] = _np(tfm.apply_sp(params, inp, r * (T // n), **kw))
    return out


def _model_parallel(group, device, spec, groups):
    """tp, pp or ep on a (data, model) mesh: the rank's logits rows and
    its shard of every leaf's gradient of the data-mean loss (+ 0.01 aux
    for ep, whose experts shard over the data axis)."""
    layout = spec["layout"]
    n_data, model = spec["mesh"]
    dg, mg = groups(n_data, model)
    d, m = mesh.axis_index(dg), mesh.axis_index(mg)
    params = _params(spec)
    toks = _rows(torch.from_numpy(spec["tokens"]).long(), d, n_data)
    heads = spec["heads"]
    if layout == "tp":
        specs, idx, n = tfm.tp_specs(params), m, model
    elif layout == "pp":
        specs, idx, n = tfm.pp_specs(params), m, model
    else:
        specs, idx, n = tfm.ep_lm_specs(params), d, n_data
    local = shard_params(params, specs, idx, n)
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(local)]
    local = _rebuild(local, leaves)
    aux = 0.0
    if layout == "tp":
        logits = tfm.apply_tp(local, toks[:, :-1], heads=heads, group=mg,
                              compute_dtype=F32)
    elif layout == "pp":
        logits = tfm.apply_pp(local, toks[:, :-1], heads=heads, group=mg,
                              num_microbatches=spec["micro"],
                              compute_dtype=F32)
    else:
        logits, aux = tfm.apply_ep(local, toks[:, :-1], heads=heads,
                                   group=dg, capacity=spec["capacity"],
                                   compute_dtype=F32, k_top=spec["k_top"])
    loss = mesh.pmean(tfm.nll(logits, toks[:, 1:]), dg) + 0.01 * aux
    # over the data axis every leaf is replicated but ep's experts
    sum_specs = specs if layout == "ep" else None
    return {"loss": float(loss), "logits": _np(logits),
            "grads": _grads(loss, leaves, sum_specs, dg)}


def _moe_layer(group, device, spec):
    r, n = mesh.world(group)
    params = _params(spec)
    local = shard_params(params, tmoe.ep_specs(), r, n)
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(local)]
    local = _rebuild(local, leaves)
    x = torch.from_numpy(_rows(spec["x"], r, n)).requires_grad_(True)
    y, aux = tmoe.moe_apply_local(local, x, group=group,
                                  capacity=spec["capacity"],
                                  compute_dtype=F32, k_top=spec["k_top"])
    loss = mesh.reduce_from_group(
        (y * torch.from_numpy(_rows(spec["r"], r, n))).sum(), group) + aux
    grads = _grads(loss, leaves + [x], tree_leaves(tmoe.ep_specs()) + [0],
                   group)
    return {"y": _np(y), "aux": float(aux), "grads": grads}


def _gpipe(group, device, spec):
    """A toy pipeline: stage i applies ``tanh(x @ w[i])`` over a
    ``(n_data, model)`` mesh; the data-mean of ``sum(out * c)``."""
    r, n = mesh.world(group)
    w = torch.from_numpy(spec["w"][r]).requires_grad_(True)
    x = torch.from_numpy(spec["x"]).requires_grad_(True)
    out = gpipe(lambda h: torch.tanh(h @ w), x, group=group)
    (out * torch.from_numpy(spec["c"])).sum().backward()
    return {"out": _np(out), "dw": _np(w.grad), "dx": _np(x.grad)}


@contextlib.contextmanager
def _patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def _grad_fn_f32(params, batch, *, heads=4, attn_impl="reference",
                 remat=False, head_chunk=0, dropout=0.0):
    """``transformer.grad_fn`` at float32 compute."""
    return value_and_grad(lambda p: tfm.loss(
        p, batch, heads=heads, compute_dtype=F32, attn_impl=attn_impl,
        remat=remat, head_chunk=head_chunk, dropout=dropout), params)


def _lm_run(group, device, spec):
    """``apps/lm_example.py``'s ``run`` on this rank, from the JAX app's
    initial weights (``spec["params"]``), every layout's model at float32
    compute."""
    def weights(*_):
        return interop.tree_from_numpy(spec["params"], "cpu")

    f32 = {name: functools.partial(getattr(tfm, name), compute_dtype=F32)
           for name in ("loss_sp", "apply_tp", "apply_pp", "apply_ep")}
    f32["grad_fn"] = _grad_fn_f32
    cfg = tcfg.Config(table=tcfg.TableConfig(**spec["table"]),
                      train=tcfg.TrainConfig(**spec["train"]))
    with _patched(tfm, **f32), _patched(tlmx, _init_params=weights,
                                        _init_moe_params=weights):
        out = tlmx.run(cfg, argparse.Namespace(device="cpu", **spec["args"]),
                       MetricsLogger(None, verbose=False), group)
    return {"losses": out["losses"]}


KINDS = {"lm_run": _lm_run, "collective": _collective,
         "attention": _attention, "sp": _sp, "moe_layer": _moe_layer,
         "gpipe": _gpipe}
GROUPED = {"axes": _axes, "model_parallel": _model_parallel}


def run_cases(group, device, cases):
    """Every case of ``cases`` on this rank, in order; a case whose spec
    has ``raises`` returns its ``ValueError``'s message."""
    made = {}

    def groups(n_data, model):
        if (n_data, model) not in made:
            made[n_data, model] = mesh.make_groups(n_data, model)
        return made[n_data, model]

    out = {}
    for name, kind, spec in cases:
        try:
            if kind in GROUPED:
                out[name] = GROUPED[kind](group, device, spec, groups)
            else:
                out[name] = KINDS[kind](group, device, spec)
        except ValueError as e:
            if not spec.get("raises"):
                raise
            out[name] = str(e)
    return out
