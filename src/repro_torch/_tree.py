"""Nested containers of tensors (the port's stand-in for a JAX pytree).

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (anything
else; ``None`` is an empty subtree, as in JAX). Leaves are visited in JAX's
order: a dict's entries by sorted key, a sequence's in order, a
NamedTuple's by field. A leaf's path is the reference checkpoint's key:
dict keys, sequence indices and NamedTuple field names, as strings.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, path: Tuple[str, ...] = ()
                       ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf, in JAX's order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(path, tree)]
    out = []
    for key, sub in _children(tree):
        out += flatten_with_paths(sub, path + (key,))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it: Iterator = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def _rebuild(like, it):
    if like is None:
        return None
    if not _is_node(like):
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    subs = [_rebuild(v, it) for _, v in _children(like)]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*subs)
    return type(like)(subs)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which must have ``tree``'s structure."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*ls) for ls in zip(*flat)])
