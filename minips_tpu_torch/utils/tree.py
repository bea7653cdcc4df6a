"""Parameter trees: nested dicts and lists of tensors, in ``jax.tree`` order.

The JAX package keeps parameters as pytrees and walks them with
``jax.tree`` and ``ravel_pytree``: a dict's children in sorted-key order, a
list's or tuple's in order, anything else a leaf. The port keeps the same
trees and the same order, so that a flat vector raveled by either package
means the same thing (the LM's tree is ``blocks[0..depth-1]``, each block
``ln1, ln2, mlp_in, mlp_out, proj, qkv``, then ``ln_f``, ``pos_emb``,
``tok_emb``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

PyTree = Any  # nested dicts and lists of tensors


def tree_leaves(tree: PyTree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_rebuild(template: PyTree, leaves: Iterator) -> PyTree:
    """``template``'s structure with its leaves taken from ``leaves`` in
    :func:`tree_leaves` order."""
    if isinstance(template, dict):
        return {k: tree_rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(tree_rebuild(x, leaves) for x in template)
    return next(leaves)


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` applied to every leaf, the structure kept."""
    return tree_rebuild(tree, iter([fn(x) for x in tree_leaves(tree)]))


def value_and_grad(fn, params):
    """``(fn(params), d fn / d params)`` with the gradient a tree like
    ``params``, taken with respect to the leaves as given, in their own
    type (``jax.value_and_grad`` for one tree argument)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    value = fn(tree_rebuild(params, iter(leaves)))
    grads = torch.autograd.grad(value, leaves, materialize_grads=True)
    return value.detach(), tree_rebuild(params, iter(grads))
