"""Generic (supervised) PAGE estimator: the port of the JAX package's
``core/page.py``, the probabilistic-switch variance-reduced gradient
behind ByzPG and DecByzPG. For stationary data (the LLM path) the
importance weight is identically 1 and PAGE takes its original form; the
RL drivers implement the importance-sampled variant.

Parameters and gradients are pytrees of tensors (dicts, lists, tuples;
:func:`repro_torch.core.tree.tree_map`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_map


class PageState(NamedTuple):
    v: object             # running direction (a pytree like the params)
    prev_params: object


def init_page(params) -> PageState:
    return PageState(tree_map(torch.zeros_like, params), params)


def page_direction(grad_fn: Callable, params, state: PageState, batch,
                   use_large: bool) -> PageState:
    """``grad_fn(params, batch)`` -> gradient pytree.

    use_large=True: v = ĝ(θ_t) (fresh large-batch estimate).
    use_large=False: v = ĝ_B(θ_t) − ĝ_B(θ_{t-1}) + v_{t-1} (the PAGE
    correction, both estimates on the SAME small batch).
    Returns the new state; the direction is ``state.v``.
    """
    g_new = grad_fn(params, batch)
    if use_large:
        v = g_new
    else:
        g_old = grad_fn(state.prev_params, batch)
        v = tree_map(lambda a, b, c: a - b + c, g_new, g_old, state.v)
    return PageState(v, params)
