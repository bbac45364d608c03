"""Flat parameter vectors in the JAX package's leaf order.

The reference flattens a policy's parameters with
``jax.flatten_util.ravel_pytree``: list entries in order and, inside each
dict, keys sorted. An MLP layer ``{"w": (din, dout), "b": (dout,)}`` is
therefore ``b`` before ``w``, and θ is ``[b0, w0, b1, w1, ...]`` with each
``w`` row-major. These helpers keep that order, so a θ carried over from
JAX means the same weights here.
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
