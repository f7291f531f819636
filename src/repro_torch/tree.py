"""Nested dict/list trees of tensors: the port's parameter and cache layout,
which mirrors the reference's pytrees.  Only dicts and lists are
containers; everything else (a tensor, a shape spec tuple) is a leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s containers with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
