"""Nested-container trees of tensors, walked in JAX's order.

The training state (parameters, optimizer state, the data cursor) is a
tree of dicts, lists and tuples with tensors, arrays or numbers as leaves,
as the JAX package's pytrees are. JAX flattens a dict in sorted key order;
every walk here does the same, so a sum over leaves (``optim.global_norm``)
adds in JAX's order and a checkpoint's leaf names are JAX's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

Path = tuple  # dict keys and sequence indices from the root


def leaves_with_path(tree, path: Path = ()) -> Iterator[tuple[Path, Any]]:
    """(path, leaf) for every leaf, dict keys sorted."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the parts of ``rest`` at the
    same places (a part may be a subtree where ``tree`` has a leaf, as in
    JAX's ``flatten_up_to``). Dicts come back with sorted keys."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, path: Path = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, dict keys sorted."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, path + (i,)) for i, x in enumerate(tree))
    return fn(path, tree)


def unzip(tree, parts, n: int) -> tuple:
    """``parts`` holds an n-tuple at each leaf of ``tree``: n trees of ``tree``'s
    structure, the i-th holding each tuple's i-th entry."""
    return tuple(tree_map(lambda _, t, i=i: t[i], tree, parts) for i in range(n))


def structure(tree) -> str:
    """JAX's ``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists and tuples: ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def walk(t) -> str:
        if isinstance(t, Mapping):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(x) for x in t) + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({walk(tree)})"
