"""Adam and SGD over a (K, d) stack of per-agent parameters: the port of
the JAX package's ``optim/optimizers.py``.

``update(grads, state, params)`` returns ``(new_params, new_state)`` with
gradient-ASCENT semantics (policy gradient maximizes J); pass
``maximize=False`` for descent.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.registry import Spec, register, resolve


class AdamState(NamedTuple):
    step: torch.Tensor     # (K,) int32
    m: torch.Tensor        # (K, d)
    v: torch.Tensor        # (K, d)


class MomentumState(NamedTuple):
    m: torch.Tensor        # (K, d)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params) -> (params, state)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         maximize: bool = True) -> Optimizer:

    def init(params):
        return AdamState(
            torch.zeros(params.shape[:-1], dtype=torch.int32,
                        device=params.device),
            torch.zeros_like(params), torch.zeros_like(params))

    def update(g, s, params):
        step = s.step + 1
        m = b1 * s.m + (1 - b1) * g
        v = b2 * s.v + (1 - b2) * g * g
        # bias corrections in f32 from the integer step, per agent
        t = step.to(torch.float32)[..., None]
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        sign = 1.0 if maximize else -1.0
        upd = sign * lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return params + upd, AdamState(step, m, v)

    return Optimizer(init, update)


def sgd(lr: float, momentum: float = 0.0, maximize: bool = True) -> Optimizer:

    def init(params):
        return MomentumState(torch.zeros_like(params))

    def update(g, s, params):
        m = momentum * s.m + g
        sign = 1.0 if maximize else -1.0
        return params + sign * lr * m, MomentumState(m)

    return Optimizer(init, update)


register("optimizer", "adam")(adam)
register("optimizer", "sgd")(sgd)


def get_optimizer(name, lr, **kw) -> Optimizer:
    """Resolve an optimizer spec (``"adam"``, ``"sgd(momentum=0.9)"``, or a
    Spec) at learning rate ``lr``; extra ``kw`` merge into its kwargs."""
    spec = Spec.of(name)
    if kw:
        spec = spec.with_kwargs(**kw)
    return resolve("optimizer", spec, lr=lr)
