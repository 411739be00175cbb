"""Trees of tensors: nested dicts, tuples (NamedTuples included) and lists
with tensor leaves, as the reference's pytrees.

``tree_leaves`` visits leaves in ``jax.tree_util`` order: dict keys
sorted, tuple and list items in order, ``None`` holding no leaf. That is
the order in which the reference's checkpoints number their leaves.
"""
from __future__ import annotations

from typing import Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]
