"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

A tree is a leaf (a tensor), or a dict, list, tuple or NamedTuple of trees:
the model's parameter dict ``{"values": (...), "biases": (...)}``, an
``SGDState``, a gradient dict. ``is_leaf`` marks other objects as leaves
(the compressor's ``CompressedLeaf``, itself a NamedTuple). As in
``jax.tree``, a dict's children are visited in sorted key order, so trees
that differ only in their dicts' insertion order flatten alike; a rebuilt
dict keeps the first tree's order.

:func:`tree_flatten_with_names` names each leaf by its path, as the
reference's checkpoint manager names its ``.npy`` files
(``repro.checkpoint.manager._flatten_with_names``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["tree_flatten", "tree_flatten_with_names", "tree_leaves", "tree_map"]

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


def tree_flatten_with_names(tree) -> Tuple[List[Tuple[str, Any]], Callable[[List], Any]]:
    """``[(name, leaf), ...]`` in :func:`tree_flatten`'s order, and the
    function that rebuilds the tree from a list of new leaves. A leaf's name
    is its path joined by ``__``, as ``jax.tree_util.tree_flatten_with_path``
    spells it: a dict key as its ``str`` (keys sorted), a sequence index as
    its number, a NamedTuple field as its name. ``None`` holds no leaf, as
    in ``jax.tree``: ``{"values": (a, b), "biases": (c,)}`` gives
    ``biases__0``, ``values__0``, ``values__1``."""
    named: List[Tuple[str, Any]] = []

    def walk(node, path: Tuple[str, ...]) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (tuple, list)):
            fields = getattr(node, "_fields", None)
            for i, child in enumerate(node):
                walk(child, path + (fields[i] if fields else str(i),))
        else:
            named.append(("__".join(path), node))

    walk(tree, ())

    def unflatten(new_leaves: List):
        it = iter(new_leaves)

        def build(node):
            if node is None:
                return None
            if isinstance(node, dict):
                built = {k: build(node[k]) for k in sorted(node)}
                return {k: built[k] for k in node}
            if isinstance(node, (tuple, list)):
                kids = [build(c) for c in node]
                return type(node)(*kids) if hasattr(node, "_fields") else type(node)(kids)
            return next(it)

        return build(tree)

    return named, unflatten
