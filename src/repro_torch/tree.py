"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

A tree is a leaf (a tensor), or a dict, list, tuple or NamedTuple of trees:
the model's parameter dict ``{"values": (...), "biases": (...)}``, an
``SGDState``, a gradient dict. ``is_leaf`` marks other objects as leaves
(the compressor's ``CompressedLeaf``, itself a NamedTuple). As in
``jax.tree``, a dict's children are visited in sorted key order, so trees
that differ only in their dicts' insertion order flatten alike; a rebuilt
dict keeps the first tree's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["tree_flatten", "tree_leaves", "tree_map"]

Leaf = Optional[Callable[[Any], bool]]


def tree_map(fn: Callable, *trees, is_leaf: Leaf = None):
    """``fn`` over the matching leaves of ``trees``, which share the first's
    structure, rebuilt in that structure."""
    first = trees[0]
    if is_leaf is not None and is_leaf(first):
        return fn(*trees)
    if isinstance(first, dict):
        mapped = {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                  for k in sorted(first)}
        return {k: mapped[k] for k in first}
    if isinstance(first, (tuple, list)):
        kids = [tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(*trees)]
        return type(first)(*kids) if hasattr(first, "_fields") else type(first)(kids)
    return fn(*trees)


def tree_flatten(tree, is_leaf: Leaf = None) -> Tuple[List, Callable[[List], Any]]:
    """The leaves in order, and the function that builds a tree of the same
    structure from a list of new leaves."""
    leaves: List = []
    tree_map(leaves.append, tree, is_leaf=is_leaf)

    def unflatten(new_leaves: List):
        it = iter(new_leaves)
        return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)

    return leaves, unflatten


def tree_leaves(tree, is_leaf: Leaf = None) -> List:
    return tree_flatten(tree, is_leaf)[0]
