"""Nested trees of tensors: dicts, lists, tuples and ``NamedTuple``s,
walked in ``jax.tree_util``'s order (dict keys sorted, sequence items by
index, a ``NamedTuple``'s fields in order), with ``None`` an empty
subtree.  The optimizer maps over parameter trees with these, and the
checkpoint names leaves by the same walk, so sums over leaves run in the
reference's order."""

from __future__ import annotations

from typing import Any, Callable


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node) -> list[tuple[str, Any]]:
    """``(path component, child)`` pairs of a dict, list or tuple, in
    ``jax.tree_util``'s order and with its names (a ``NamedTuple`` field
    as ``.<field>``)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    return [(str(i), item) for i, item in enumerate(node)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [leaf for _, child in children(tree)
                for leaf in tree_leaves(child)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in leaf order and
    rebuilt as ``tree``'s types."""
    if tree is None:
        return None
    if isinstance(tree, dict):     # keys in order, as jax rebuilds them
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if is_namedtuple(tree):
            return type(tree)(*items)
        return items if isinstance(tree, list) else tuple(items)
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, is_leaf: Callable | None = None):
    """``fn(path, leaf)`` over the leaves of ``tree`` (``path`` the tuple
    of the leaf's path components, as :func:`children` names them), in
    leaf order, rebuilt as ``tree``'s types; a node for which ``is_leaf``
    holds is a leaf."""
    def walk(node, path):
        if node is None:
            return None
        if (is_leaf is None or not is_leaf(node)) and \
                isinstance(node, (dict, list, tuple)):
            items = [walk(child, path + (name,))
                     for name, child in children(node)]
            if isinstance(node, dict):
                return dict(zip(sorted(node), items))
            if is_namedtuple(node):
                return type(node)(*items)
            return items if isinstance(node, list) else tuple(items)
        return fn(path, node)

    return walk(tree, ())
