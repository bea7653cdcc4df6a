"""Top-k mixture-of-experts FFN — the port of the one-device part of
``minips_tpu/parallel/moe.py`` (Switch top-1 by default, GShard-style
top-2 and up through ``k_top``).

A linear router picks each token's top-k experts; each (token, choice)
takes a slot in its expert's capacity queue, rank-major (every token's
first choice queues before any second choice) and earliest first, and a
route that finds its expert full is dropped. The experts' GELU MLPs run on
their slots, and the outputs combine weighted by the raw router
probabilities of the chosen experts (no top-k renormalisation: Switch's
straight-through gate for k = 1). The router learns through the combine
weights; the one-hot dispatch takes no gradient.

``moe_apply_dense`` is the whole layer on one device, the JAX package's
oracle. ``moe_apply_local`` is the expert-parallel layer over a
``torch.distributed`` group: tokens sharded over the ranks, the router
replicated, the experts' weights sharded on their expert dim
(``ep_specs``); each rank packs its tokens into per-expert slots (a
capacity queue per expert per source rank), one all-to-all ships the
slots to the experts' owners, the owners run their experts, and a second
all-to-all ships the results back. Gradients flow back through both
exchanges; the load-balancing statistics are averaged over the group
before their product, so the aux loss equals the one-device layer's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from minips_tpu_torch.parallel.mesh import (DeviceLike, Group,
                                            all_to_all_axes, pmean,
                                            resolve_device, world)


def init_moe(gen: torch.Generator, num_experts: int, dim: int, hidden: int,
             device: DeviceLike = None) -> dict:
    """Router ``[dim, E]`` and stacked expert weights ``w_in [E, dim,
    hidden]``, ``w_out [E, hidden, dim]``, at the JAX package's scales,
    drawn from ``gen`` (a ``torch.Generator`` on ``device``)."""
    device = resolve_device(device)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    return {"router": normal(dim, num_experts, scale=dim ** -0.5),
            "w_in": normal(num_experts, dim, hidden, scale=dim ** -0.5),
            "w_out": normal(num_experts, hidden, dim, scale=hidden ** -0.5)}


def _one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n)."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(
        dtype)


def _dispatch_combine(x, router_w, num_experts: int, capacity: int,
                      k_top: int = 1):
    """Route ``[N, D]`` tokens to their top-``k_top`` experts: ``(dispatch
    [N, E, C] {0, 1}, combine [N, E, C] gate-weighted, frac [E], mean_p
    [E])``, the last two the load-balancing statistics of
    :func:`_aux_loss`: the share of tokens whose first choice is each
    expert, and each expert's mean router probability."""
    N = x.shape[0]
    probs = torch.softmax(x @ router_w, dim=-1)               # [N, E]
    gate, expert = torch.topk(probs, k_top, dim=-1)           # [N, k]
    onehots = _one_hot(expert, num_experts, x.dtype)          # [N, k, E]
    # queue position of each (token, choice) in its expert, earliest first
    # over a rank-major flattening
    flat = onehots.transpose(0, 1).reshape(k_top * N, num_experts)
    pos = (torch.cumsum(flat, dim=0) * flat).to(torch.int32) - 1
    keep = (pos >= 0) & (pos < capacity)                     # -1: not routed
    slot = _one_hot(pos, capacity, x.dtype)                   # [kN, E, C]
    disp = (slot * keep[..., None]).reshape(k_top, N, num_experts, capacity)
    dispatch = disp.sum(0)
    combine = (disp * gate.T[:, :, None, None]).sum(0)
    return dispatch, combine, onehots[:, 0].mean(0), probs.mean(0)


def _aux_loss(frac, mean_p, num_experts: int):
    """``E * sum_e(frac_e * mean_p_e)``, least at uniform routing."""
    return num_experts * torch.sum(frac * mean_p)


def _expert_ffn(w_in, w_out, x, compute_dtype):
    """``x [E, C, D]`` through each expert's GELU MLP, float32 out."""
    h = F.gelu(torch.einsum("ecd,edh->ech", x.to(compute_dtype),
                            w_in.to(compute_dtype)), approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h,
                        w_out.to(compute_dtype)).float()


def moe_apply_dense(params, x, *, capacity: int,
                    compute_dtype=torch.bfloat16, k_top: int = 1):
    """The layer on one device: ``[N, D] -> ([N, D], aux_loss)``, with one
    capacity queue per expert over all N tokens."""
    E = params["router"].shape[1]
    dispatch, combine, frac, mean_p = _dispatch_combine(
        x, params["router"], E, capacity, k_top)
    slots = torch.einsum("nec,nd->ecd", dispatch, x)          # [E, C, D]
    out_slots = _expert_ffn(params["w_in"], params["w_out"], slots,
                            compute_dtype)
    return (torch.einsum("nec,ecd->nd", combine, out_slots),
            _aux_loss(frac, mean_p, E))


def moe_apply_local(params_local, x_local, *, group: Group, capacity: int,
                    compute_dtype=torch.bfloat16, k_top: int = 1):
    """The expert-parallel layer on this rank: ``x_local [N_local, D]``
    are this rank's tokens, ``params_local`` the replicated router and
    this rank's ``E/n`` experts (``w_in``, ``w_out`` cut on dim 0 by
    ``ep_specs``). ``capacity`` is per expert per source rank. Returns
    ``([N_local, D], aux_loss)``, the aux loss the same on every rank.
    Equal to ``moe_apply_dense`` on the gathered tokens wherever the
    capacity drops no route."""
    k = world(group)[1]
    E = params_local["router"].shape[1]
    e_local = params_local["w_in"].shape[0]
    if e_local * k != E:
        raise ValueError(f"router knows {E} experts but {k} ranks hold "
                         f"{e_local} each")
    dispatch, combine, frac, mean_p = _dispatch_combine(
        x_local, params_local["router"], E, capacity, k_top)
    slots = torch.einsum("nec,nd->ecd", dispatch, x_local)    # [E, C, D]
    # expert block j of every rank goes to rank j, which receives its
    # experts' slots from every source rank: [k, e_local, C, D]
    slots = slots.reshape(k, e_local, capacity, -1)
    recv = all_to_all_axes(slots, group, 0, 0, tiled=False)
    mine = recv.transpose(0, 1).reshape(e_local, k * capacity, -1)
    out = _expert_ffn(params_local["w_in"], params_local["w_out"], mine,
                      compute_dtype)
    out = out.reshape(e_local, k, capacity, -1).transpose(0, 1)
    back = all_to_all_axes(out, group, 0, 0, tiled=False)
    y = torch.einsum("nec,ecd->nd", combine, back.reshape(E, capacity, -1))
    aux = _aux_loss(pmean(frac, group), pmean(mean_p, group), E)
    return y, aux


def ep_specs() -> dict:
    """The dim each leaf of ``moe_apply_local``'s params is sharded on over
    the expert group (None: replicated)."""
    return {"router": None, "w_in": 0, "w_out": 0}
