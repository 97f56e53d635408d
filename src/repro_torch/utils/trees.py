"""Small tree helpers over nested dicts, lists and tuples of tensors: the
port of ``repro.utils.trees``, with the flattening it rests on.

A tree is a dict, list or tuple whose leaves are anything else (tensors,
numpy arrays, numbers). Leaves come out in the order ``jax.tree.leaves``
gives them: a dict's entries by sorted key, a list's in order. The codec
exchange encodes leaf by leaf in that order and the checkpoint names
each leaf by its path, so the two packages agree on both.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (imported
    only for a tensor that is not a plain one)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node) -> Iterator[tuple[Any, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield k, node[k]
    else:
        yield from enumerate(node)


def tree_flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order; a path joins the dict keys and
    list indices from the root with ``/`` (the reference checkpoint's
    key of that leaf)."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out += tree_flatten_with_path(child, f"{prefix}/{k}" if prefix
                                      else str(k))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; dicts come back with their keys sorted."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in _children(tree)}
    out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return out if isinstance(tree, list) else tuple(out)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure whose leaves are ``leaves`` in leaf
    order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure has")
    return out


def _numel(leaf) -> int:
    return math.prod(int(d) for d in leaf.shape)


def tree_bytes(tree) -> int:
    """Total bytes of all array leaves (tensors, numpy arrays, or any
    stand-in with ``shape`` and ``dtype``)."""
    total = 0
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            size = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                    else leaf.dtype.itemsize)
            total += _numel(leaf) * size
    return total


def tree_params(tree) -> int:
    """Total element count of all array leaves."""
    return sum(_numel(leaf) for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape"))


def tree_allfinite(tree) -> torch.Tensor:
    """A 0-dim bool tensor: every floating leaf is finite."""
    flags = [torch.all(torch.isfinite(leaf)) for leaf in tree_leaves(tree)
             if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    return torch.all(torch.stack(flags)) if flags else torch.tensor(True)
