"""Minimal pytree helpers for parameter trees: nested lists, tuples and
mappings with tensor leaves (the layout of the reference's JAX pytrees,
e.g. ``[{"W": ..., "a1": ..., "a2": ...}, ...]``)."""
from __future__ import annotations

from typing import Any, Callable, List, Mapping

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure; mappings
    come back as dicts, sequences as lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, Mapping):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Tree, leaves: List[Any]) -> Tree:
    """The structure of ``tree`` with ``leaves`` (as from :func:`tree_leaves`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
