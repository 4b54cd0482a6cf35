"""Minimal pytree helpers over NamedTuples, lists and tuples of tensors."""

from __future__ import annotations

import torch


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over matching NamedTuple/list/tuple structures.

    Leaves are tensors (or anything that is not a container); ``None``
    passes through unchanged.
    """
    if tree is None:
        return None
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` over two matching trees."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
