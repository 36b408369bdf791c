"""Trees of tensors, as the JAX package's pytrees: dicts (children in sorted
key order), NamedTuples (their fields), tuples and lists, ``None`` (no
leaves); anything else is a leaf.  Leaf names follow
``jax.tree_util.tree_flatten_with_path``: a dict key as itself, a field as
``.name``, an element as ``[i]``, joined with ``/``.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of a node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree, key=str)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if tree is None:
        return []
    return None


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out.extend(flatten_with_names(child, f"{prefix}/{name}" if prefix else name))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten_by_name(like, values: dict, prefix: str = ""):
    """A tree of ``like``'s structure whose leaf at each name is
    ``values[name]``."""
    kids = _children(like)
    if kids is None:
        return values[prefix]
    new = {name: unflatten_by_name(child, values, f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if isinstance(like, dict):
        return {k: new[str(k)] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(new[f".{f}"] for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(new[f"[{i}]"] for i in range(len(like)))
    return None


def leaves_like(like, other) -> list:
    """The entries of ``other`` (a tree of ``like``'s structure whose leaves
    may themselves be tuples, such as sharding specs) at ``like``'s leaves,
    in :func:`flatten_with_names`' order."""
    kids = _children(like)
    if kids is None:
        return [other]
    if isinstance(like, dict):
        subs = [other[k] for k in sorted(like, key=str)]
    elif _is_namedtuple(like):
        subs = [getattr(other, f) for f in like._fields]
    else:
        subs = list(other) if like is not None else []
    return [x for (_, child), sub in zip(kids, subs) for x in leaves_like(child, sub)]


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure with ``leaves`` in its leaf order."""
    names = [name for name, _ in flatten_with_names(like)]
    if len(names) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(names)}")
    return unflatten_by_name(like, dict(zip(names, leaves)))
