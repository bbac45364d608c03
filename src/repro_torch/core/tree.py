"""Flat parameter vectors in the JAX package's leaf order.

The reference flattens a policy's parameters with
``jax.flatten_util.ravel_pytree``: list entries in order and, inside each
dict, keys sorted. An MLP layer ``{"w": (din, dout), "b": (dout,)}`` is
therefore ``b`` before ``w``, and θ is ``[b0, w0, b1, w1, ...]`` with each
``w`` row-major. A transformer's nested parameter dict ravels with keys
sorted at every level (``unravel_tree``).
These helpers keep that order, so a θ carried over from JAX means the
same weights here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Shapes = Sequence[Dict[str, Tuple[int, ...]]]


def ravel(params: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """List of dicts of tensors -> flat (d,) vector."""
    return torch.cat([layer[key].reshape(-1)
                      for layer in params for key in sorted(layer)])


def unravel(vec: torch.Tensor,
            shapes: Shapes) -> List[Dict[str, torch.Tensor]]:
    """Flat (..., d) -> list of dicts of views shaped (..., *shape); any
    leading dims of ``vec`` (e.g. the K agents) lead every leaf."""
    lead = vec.shape[:-1]
    out, off = [], 0
    for layer in shapes:
        views = {}
        for key in sorted(layer):
            n = math.prod(layer[key])
            views[key] = vec[..., off:off + n].reshape(*lead, *layer[key])
            off += n
        out.append(views)
    if off != vec.shape[-1]:
        raise ValueError(f"flat vector has {vec.shape[-1]} entries, the "
                         f"shapes need {off}")
    return out


def size(shapes: Shapes) -> int:
    return sum(math.prod(s) for layer in shapes for s in layer.values())


def tree_size(shapes) -> int:
    """Entries of a nested dict of shapes."""
    if isinstance(shapes, dict):
        return sum(tree_size(v) for v in shapes.values())
    return math.prod(shapes)


def unravel_tree(vec: torch.Tensor, shapes):
    """Flat (d,) -> a nested dict of tensors shaped like ``shapes`` (a
    nested dict of shapes), filled in ``ravel_pytree``'s order: keys
    sorted at every level, each leaf row-major."""
    off = 0

    def fill(node):
        nonlocal off
        if isinstance(node, dict):
            return {key: fill(node[key]) for key in sorted(node)}
        shape = tuple(node)
        n = math.prod(shape)
        out = vec[off:off + n].reshape(shape)
        off += n
        return out

    out = fill(shapes)
    if off != vec.shape[-1]:
        raise ValueError(f"flat vector has {vec.shape[-1]} entries, the "
                         f"shapes need {off}")
    return out


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf to trees of one structure: dicts, lists,
    tuples and NamedTuples are nodes, ``None`` an empty subtree, anything
    else a leaf. Leaves are visited in :func:`tree_paths`'s order (dict
    keys sorted, as ``jax.tree_util`` does)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s leaf order, each path
    the keys joined by ``/``: dict keys sorted, list and tuple indices,
    NamedTuple field names; ``None`` holds no leaf."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [p for name, x in zip(tree._fields, tree)
                for p in tree_paths(x, join(name))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree)
                for p in tree_paths(x, join(i))]
    return [(prefix, tree)]
