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

# The walkers are module-level functions that take their output list: a
# nested function that calls itself is a reference cycle (function -> cell
# -> function) that keeps the list it closes over, and so every leaf, alive
# until the cyclic garbage collector runs; for a parameter tree on a card
# that held a second copy of the weights.


def _flatten(t, is_leaf, leaves: List[Any]):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return _LEAF
    if isinstance(t, dict):
        return (dict, tuple((k, _flatten(t[k], is_leaf, leaves)) for k in sorted(t)))
    if isinstance(t, (list, tuple)):
        return (type(t), tuple(_flatten(x, is_leaf, leaves) for x in t))
    leaves.append(t)
    return _LEAF


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(leaves, treedef); ``tree_unflatten(treedef, leaves)`` inverts it."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, is_leaf, leaves)


def _build(node, it):
    if node is _LEAF:
        return next(it)
    kind, children = node
    if kind is dict:
        return {k: _build(c, it) for k, c in children}
    return kind(_build(c, it) for c in children)


def tree_unflatten(treedef, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any, is_leaf=None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _paths(t, path, sep: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], path + (str(k),), sep, out)
    elif isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            _paths(x, path + (str(i),), sep, out)
    else:
        out.append((sep.join(path), t))


def tree_paths(tree: Any, sep: str = "/") -> List[Tuple[str, Any]]:
    """``[(key path, leaf)]`` in leaf order; a path joins dict keys and
    sequence indices with ``sep`` (the reference checkpoint's key format)."""
    out: List[Tuple[str, Any]] = []
    _paths(tree, (), sep, out)
    return out
