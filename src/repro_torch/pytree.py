"""Nested-container helpers for parameter trees (the part of ``jax.tree`` the
LM port needs).

A tree is nested ``dict``s, ``list``s and ``tuple``s; anything else (or
whatever ``is_leaf`` accepts) is a leaf.  Dicts are walked in sorted key
order, as ``jax.tree`` walks them, so leaf order and key paths agree with the
reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

_LEAF = object()


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(leaves, treedef); ``tree_unflatten(treedef, leaves)`` inverts it."""
    leaves: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return _LEAF
        if isinstance(t, dict):
            return (dict, tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t), tuple(walk(x) for x in t))
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        kind, children = node
        if kind is dict:
            return {k: build(c) for k, c in children}
        return kind(build(c) for c in children)

    return build(treedef)


def tree_leaves(tree: Any, is_leaf=None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_paths(tree: Any, sep: str = "/") -> List[Tuple[str, Any]]:
    """``[(key path, leaf)]`` in leaf order; a path joins dict keys and
    sequence indices with ``sep`` (the reference checkpoint's key format)."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, path + (str(i),))
        else:
            out.append((sep.join(path), t))

    walk(tree, ())
    return out
