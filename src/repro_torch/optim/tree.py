"""The port's parameter trees are nested dicts of tensors; these map one
or more trees of the same structure leaf by leaf."""
from __future__ import annotations

from typing import Any, Callable, Tuple

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (each a dict with the same keys, or a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unzip(tree: Tree, n: int) -> Tuple[Tree, ...]:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)


def tree_leaves(tree: Tree) -> list:
    """The leaves in sorted key order (the reference's flatten order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
