"""Trees of tensors: nested dicts, tuples (NamedTuples included) and lists
with tensor leaves, as the reference's pytrees.

``tree_leaves`` visits leaves in ``jax.tree_util`` order: dict keys
sorted, tuple and list items in order, ``None`` holding no leaf. That is
the order in which the reference's checkpoints number their leaves;
``tree_unflatten`` puts leaves back in that order, and ``treedef_str``
renders a tree's structure as ``str(treedef)`` does in JAX.
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


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, taken in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def treedef_str(tree) -> str:
    """The text ``str(jax.tree_util.tree_structure(tree))`` gives for
    the same tree in JAX: a NamedTuple is ``CustomNode(namedtuple[Name],
    [...])``, a dict ``{'k': ..., ...}`` with sorted keys, a leaf ``*``;
    tuples, lists and ``None`` as Python writes them."""

    def render(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(render(v) for v in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(render(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(render(v) for v in t) + "]"
        if t is None:
            return "None"
        return "*"

    return f"PyTreeDef({render(tree)})"
