"""GPipe-style pipeline parallelism over a ``torch.distributed`` group —
the port of ``minips_tpu/parallel/pipeline.py``.

Layer weights are stacked along a leading depth axis (:func:`stack_layers`)
and that axis is sharded over the group: rank ``i`` of ``k`` holds
``depth/k`` consecutive layers, one pipeline stage. Microbatches flow from
stage to stage with ``ppermute`` over ``M + k − 1`` ticks (the GPipe
schedule, ``k − 1`` bubble ticks): at every tick each stage applies its
layers to whatever activation has just arrived. As in the JAX package the
bubble ticks compute on values nobody reads, so every rank runs the same
graph and the same collectives; the rank picks its input and files its
output with ``torch.where``, which keeps each ``ppermute``'s backward on
every rank. Autograd runs the backward pipeline through the rotations'
backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from minips_tpu_torch.parallel.mesh import (Group, copy_to_group, ppermute,
                                            reduce_from_group, world)
from minips_tpu_torch.utils.tree import tree_leaves, tree_map


def gpipe(stage_fn: Callable[[torch.Tensor], torch.Tensor],
          x_microbatches: torch.Tensor, *, group: Group) -> torch.Tensor:
    """Run ``[M, ...]`` microbatches through the k-stage pipeline of
    ``group``. ``stage_fn`` applies THIS rank's layers to one microbatch
    and keeps its shape. Stage 0 reads microbatch t at tick t; the last
    stage files microbatch ``t − k + 1``. The result ``[M, ...]``, the
    last stage's outputs, is replicated on every rank. ``x_microbatches``
    is the same on every rank."""
    idx, k = world(group)
    M = x_microbatches.shape[0]
    dev = x_microbatches.device
    first = torch.tensor(idx == 0, device=dev)
    last = torch.tensor(idx == k - 1, device=dev)
    # the replicated input enters a computation that differs by rank
    x_microbatches = copy_to_group(x_microbatches, group)
    buf = torch.zeros_like(x_microbatches[0])
    outputs = [torch.zeros_like(x_microbatches[0]) for _ in range(M)]
    for t in range(M + k - 1):
        x = torch.where(first, x_microbatches[min(t, M - 1)], buf)
        y = stage_fn(x)
        o = t - (k - 1)
        if o >= 0:  # the last stage files microbatch o
            outputs[o] = torch.where(last, y, outputs[o])
        # stage i sends to i + 1; the wrap edge carries what stage 0 never
        # reads (the last tick's rotation too, as in the JAX scan)
        buf = ppermute(y, group)
    out = torch.stack(outputs)
    return reduce_from_group(torch.where(last, out, torch.zeros_like(out)),
                             group)


def stack_layers(layers: list) -> dict:
    """Identically structured layer trees stacked into one tree with a
    leading depth axis on every leaf, the layout :func:`gpipe` shards."""
    leaves = [tree_leaves(layer) for layer in layers]
    stacked = iter([torch.stack(xs) for xs in zip(*leaves)])
    return tree_map(lambda _: next(stacked), layers[0])


def unstack_layers(stacked: dict) -> list:
    """The inverse of :func:`stack_layers`."""
    depth = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda x: x[i], stacked) for i in range(depth)]
