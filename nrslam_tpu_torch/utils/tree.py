"""Minimal pytree helpers over NamedTuples, lists and tuples of tensors, and
the packing of a tree's tensor leaves into one flat buffer."""

from __future__ import annotations

from typing import NamedTuple

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


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


# A packed leaf starts at a multiple of this many bytes: the CUDA caching
# allocator's block alignment, so a kernel that picks its vector width from
# a pointer's alignment picks the same one on a packed view as on a tensor
# of its own.
ALIGN = 512


class Packing(NamedTuple):
    """Where every tensor leaf of a tree sits in one flat uint8 buffer of
    ``nbytes``: leaf k is ``specs[k]`` = (first byte, a multiple of
    ``ALIGN``; its bytes; dtype; shape), laid out with ``strides[k]``: the
    leaf's own where it is dense (a permutation of a contiguous layout, as
    LAPACK's column-major results are), else contiguous, so an operation on
    a packed view sees the layout it sees on the leaf. ``template`` is the
    tree with its leaves replaced by their index."""

    template: object
    specs: tuple
    nbytes: int
    strides: tuple


def packing(tree) -> Packing:
    """The packing of ``tree``'s tensor leaves, in ``tree_map`` order."""
    specs, strides, at = [], [], 0
    for x in leaves(tree):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"packing: leaf of type {type(x).__name__}, "
                            "expected tensors only")
        n = x.numel() * x.element_size()
        specs.append((at, n, x.dtype, tuple(x.shape)))
        strides.append(torch.empty_like(x, device="meta").stride())
        at += -(-n // ALIGN) * ALIGN
    index = iter(range(len(specs)))
    return Packing(tree_map(lambda _: next(index), tree), tuple(specs), at,
                   tuple(strides))


def unpack(buf: torch.Tensor, p: Packing):
    """The tree of ``p``'s structure whose leaves are views into ``buf``
    (uint8 [p.nbytes])."""
    views = [buf[at:at + n].view(dtype).as_strided(shape, stride)
             for (at, n, dtype, shape), stride in zip(p.specs, p.strides)]
    return tree_map(lambda k: views[k], p.template)


def copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into the matching leaf of ``dst``; raises
    unless both trees have the same structure and each pair of leaves the
    same dtype and shape (``copy_`` would cast or broadcast)."""
    a, b = leaves(dst), leaves(src)
    if len(a) != len(b):
        raise ValueError(f"copy_: {len(b)} leaves into {len(a)}")
    for k, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise ValueError(f"copy_: leaf {k} is {y.dtype}{list(y.shape)}, "
                             f"expected {x.dtype}{list(x.shape)}")
        x.copy_(y)


def pack(tree, p: Packing, device=None) -> torch.Tensor:
    """A new buffer (uint8 [p.nbytes] on ``device``, default the first
    leaf's) holding ``tree``'s leaves as ``p`` places them; the padding
    between leaves is zero."""
    if device is None:
        device = leaves(tree)[0].device
    buf = torch.zeros(p.nbytes, dtype=torch.uint8, device=device)
    copy_(unpack(buf, p), tree)
    return buf
