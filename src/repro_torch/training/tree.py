"""Nested dicts and lists of tensors: the port's counterpart of the pytree
utilities the reference's training code reads.  Dict keys are visited in
sorted order, as JAX flattens them; empty containers hold no leaves and
keep their place."""

from __future__ import annotations

from typing import Callable, Iterator

import torch

__all__ = ["tree_map", "tree_leaves", "tree_items"]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` (tensors, or nodes ``is_leaf``
    accepts) and the matching nodes of ``rest``, in ``tree``'s structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    out = [(k, tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf))
           for k, v in _children(tree)]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(v for _, v in out)


def tree_items(tree, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs in flattening order; a path holds dict keys and
    list indices."""
    if not _is_node(tree):
        yield path, tree
        return
    for k, v in _children(tree):
        yield from tree_items(v, (*path, k))


def tree_leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_items(tree)]
