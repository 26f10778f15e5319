"""Nested containers of tensors, the port's counterpart of JAX's pytrees.

A node is a dict (its children in sorted key order, as JAX flattens a
dict), a NamedTuple (its fields in order) or a tuple or list (by index);
anything else is a leaf. The order and the path names (keys, field names,
indices, joined by "/") are those of the reference's
``checkpoint.manager._flatten_with_paths``, so a train state's leaves line up
leaf for leaf with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    raise TypeError(f"not a tree node: {type(node).__name__}")


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def flatten_with_paths(tree: Any, is_leaf: Callable = None) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in the reference's order; a node for
    which ``is_leaf`` is true is a leaf too (JAX's ``is_leaf``)."""
    if not _is_node(tree) or (is_leaf is not None and is_leaf(tree)):
        return [("", tree)]
    out = []
    for name, child in _children(tree):
        out.extend((f"{name}/{p}" if p else name, leaf)
                   for p, leaf in flatten_with_paths(child, is_leaf))
    return out


def leaves(tree: Any, is_leaf: Callable = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf)]


def unflatten(like: Any, new_leaves, is_leaf: Callable = None) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (``is_leaf`` as for ``flatten_with_paths``)."""
    it: Iterator = iter(new_leaves)

    def build(node):
        if not _is_node(node) or (is_leaf is not None and is_leaf(node)):
            return next(it)
        if isinstance(node, dict):
            out = {k: None for k in node}              # keep the caller's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        kids = [build(c) for _, c in _children(node)]
        if hasattr(node, "_fields"):
            return type(node)(*kids)
        return type(node)(kids)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_up_to(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` for each leaf of ``tree``, where ``others`` are
    the subtrees of ``rest`` at the leaf's place (JAX's
    ``flatten_up_to``: a quantized moment's ``(q, scale)`` pair is one of
    them). Returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_up_to(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
