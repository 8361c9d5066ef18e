"""Param trees: nested dicts, lists, tuples and named tuples of tensors,
walked in the reference's leaf order (dict keys sorted, sequence entries in
order; None holds no leaf), so a tree's leaves line up one for one with
the reference's flattening of the same tree."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t) -> List[Tuple[str, Any]]:
    """(path part, child) pairs in leaf order: a dict key, a sequence
    index, or ".field" for a named tuple (the reference's key names)."""
    if isinstance(t, dict):
        return [(str(k), t[k]) for k in sorted(t)]
    if _is_named(t):
        return [(f".{f}", getattr(t, f)) for f in t._fields]
    return [(str(i), x) for i, x in enumerate(t)]


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[("layers/0/attn/wq", leaf), ...] in leaf order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for part, child in _children(tree):
        out.extend(leaves_with_paths(child,
                                     f"{prefix}/{part}" if prefix else part))
    return out


def tree_leaves(tree) -> List[Any]:
    return [x for _, x in leaves_with_paths(tree)]


def _rebuild(t, items):
    if isinstance(t, dict):
        return {k: v for k, v in items}
    if _is_named(t):
        return type(t)(*(v for _, v in items))
    return type(t)(v for _, v in items)


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and of trees of the same structure
    in `rest`), keeping the structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        items = [(k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                 for k in tree]
    else:
        items = [(i, tree_map(fn, x, *(r[i] for r in rest)))
                 for i, x in enumerate(tree)]
    return _rebuild(tree, items)


def tree_unflatten(like, leaves: List[Any]):
    """`like`'s structure with `leaves` in leaf order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        return _rebuild(t, [(i, build(x)) for i, x in enumerate(t)])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
