"""Adam and SGD over a (K, d) stack of per-agent parameters, and the
cosine schedule: the port of the JAX package's ``optim/optimizers.py``.

``update(grads, state, params)`` returns ``(new_params, new_state)`` with
gradient-ASCENT semantics (policy gradient maximizes J); pass
``maximize=False`` for descent.

The learning rate ``lr`` takes three forms:

* a number, the same for every agent;
* a callable ``lr(step)`` (e.g. :func:`cosine_schedule`), evaluated on
  Adam's int32 step, one per agent (SGD, which counts no steps, calls
  ``lr(0)`` as the reference does);
* an (R,) float32 tensor, one value per row of a lane group (the
  parameters then carry a leading row axis, (R, K, d) or (R, d)).
"""
from __future__ import annotations

import dataclasses
import math
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


def _rate(lr, step, params: torch.Tensor):
    """The learning rate to multiply an update of ``params`` by: a number
    as it is, a schedule's value at ``step`` broadcast over the last axis,
    a per-row tensor broadcast over all but the leading axis."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=params.dtype,
                               device=params.device)[..., None]
    if isinstance(lr, torch.Tensor):
        return lr.reshape(-1, *(1,) * (params.dim() - 1))
    return lr


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
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
        upd = sign * _rate(lr, step, params) * (m / bc1) \
            / (torch.sqrt(v / bc2) + eps)
        return params + upd, AdamState(step, m, v)

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.0, maximize: bool = True) -> Optimizer:

    def init(params):
        return MomentumState(torch.zeros_like(params))

    def update(g, s, params):
        m = momentum * s.m + g
        sign = 1.0 if maximize else -1.0
        rate = lr(0) if callable(lr) else _rate(lr, None, params)
        return params + sign * rate * m, MomentumState(m)

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """``lr(step)``: linear warmup to ``base_lr`` over ``warmup`` steps,
    then a cosine decay to ``min_frac · base_lr`` at ``total``, in float32
    as the reference computes it under jit. ``step`` is an int or an int
    tensor; the value is a float32 tensor of its shape."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


register("optimizer", "adam")(adam)
register("optimizer", "sgd")(sgd)


def get_optimizer(name, lr, **kw) -> Optimizer:
    """Resolve an optimizer spec (``"adam"``, ``"sgd(momentum=0.9)"``, or a
    Spec) at learning rate ``lr``; extra ``kw`` merge into its kwargs."""
    spec = Spec.of(name)
    if kw:
        spec = spec.with_kwargs(**kw)
    return resolve("optimizer", spec, lr=lr)
