"""Nested dict / list trees: the few ``jax.tree`` functions the training
path needs, for the port's params, gradients and optimizer states.

A node is a dict or a list; anything else is a leaf (``is_leaf`` can stop
the walk earlier, at an int8 moment's ``{"q", "scale"}`` dict, say).
Dict keys are visited in sorted order and lists by index, as JAX flattens
a pytree, so the leaves come in the reference's order and a leaf's path
names the same entry in both packages (the checkpoint keys).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

IsLeaf = Optional[Callable[[Any], bool]]


def _is_node(x, is_leaf: IsLeaf) -> bool:
    return isinstance(x, (dict, list)) and not (is_leaf and is_leaf(x))


def leaves_with_path(tree, is_leaf: IsLeaf = None) -> list:
    """[(path tuple, leaf)] in JAX's flattening order."""
    out = []

    def walk(node, path):
        if not _is_node(node, is_leaf):
            out.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            for i, x in enumerate(node):
                walk(x, path + (i,))

    walk(tree, ())
    return out


def leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`leaves`'
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, list):
            return [walk(x) for x in node]
        return next(it)

    out = walk(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None) -> Any:
    """``fn`` over the leaves of ``tree``, with the matching subtrees of
    ``rest`` (same structure, or deeper below a leaf of ``tree``), as
    ``jax.tree.map``."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    return [tree_map(fn, x, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, x in enumerate(tree)]
