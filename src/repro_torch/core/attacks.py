"""Byzantine attack library: the port of the JAX package's
``core/attacks.py`` (paper §6.2 plus standard literature attacks).

An attack is ``fn(honest (K, d), byz_mask (K,), noise) -> (K, d)``: rows
where ``byz_mask`` is True are replaced with adversarial values, the rest
are returned untouched. An attack that draws randomness (registered with
``noise=True``: ``large_noise``) takes it as an explicit standard-normal
tensor of the messages' shape; the others ignore ``noise``.
``per_receiver(attack, K)`` sends every receiver its own value, a
(K, K, d) tensor, from noise of shape (K, K, d).

Every attack also takes a leading row axis (lane batching): honest
(R, K, d) and noise (R, K, d), each row attacked on its own. The kwargs
registered as ``traced_kwargs`` (``sigma``, ``scale``, ``z``: multipliers
in the attack's arithmetic) may then be (R, 1, 1) tensors, one value per
row.

``random_action`` is environment-level: the agent acts uniformly at random
but reports its gradient honestly; the DecByzPG step zeroes its logits.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.registry import REGISTRY, Spec, register, resolve


def none_attack(honest, byz_mask, noise=None):
    return honest


def large_noise(honest, byz_mask, noise, sigma: float = 100.0):
    """Byzantines send pure noise of large variance (paper: LargeNoise)."""
    if noise is None:
        raise ValueError("large_noise needs its noise tensor")
    return torch.where(byz_mask[:, None], sigma * noise, honest)


def avg_zero(honest, byz_mask, noise=None):
    """Colluding omniscient attack: Byzantine values are chosen so the
    average over all K messages is (close to) zero (paper: AvgZero)."""
    n_byz = torch.clamp_min(byz_mask.sum(), 1)
    honest_sum = torch.where(byz_mask[:, None], 0.0, honest).sum(-2)
    byz_val = -honest_sum / n_byz
    return torch.where(byz_mask[:, None], byz_val[..., None, :], honest)


def sign_flip(honest, byz_mask, noise=None, scale: float = 3.0):
    """Byzantines send the negated (scaled) honest mean (IPM-style)."""
    n_h = torch.clamp_min((~byz_mask).sum(), 1)
    mu = torch.where(byz_mask[:, None], 0.0, honest).sum(-2) / n_h
    return torch.where(byz_mask[:, None], -scale * mu[..., None, :], honest)


def alie(honest, byz_mask, noise=None, z: float = 1.5):
    """A Little Is Enough: honest mean shifted by z std-devs per coordinate,
    crafted to hide inside the honest spread."""
    n_h = torch.clamp_min((~byz_mask).sum(), 1)
    w = (~byz_mask).to(honest.dtype)[:, None]
    mu = (w * honest).sum(-2, keepdim=True) / n_h
    var = (w * (honest - mu) ** 2).sum(-2, keepdim=True) / n_h
    byz_val = mu - z * torch.sqrt(var + 1e-12)
    return torch.where(byz_mask[:, None], byz_val, honest)


register("attack", "none")(lambda: none_attack)
register("attack", "avg_zero")(lambda: avg_zero)


@register("attack", "large_noise", noise=True, traced_kwargs=("sigma",))
def _large_noise_factory(sigma: float = 100.0):
    return functools.partial(large_noise, sigma=sigma)


@register("attack", "sign_flip", traced_kwargs=("scale",))
def _sign_flip_factory(scale: float = 3.0):
    return functools.partial(sign_flip, scale=scale)


@register("attack", "alie", traced_kwargs=("z",))
def _alie_factory(z: float = 1.5):
    return functools.partial(alie, z=z)


register("attack", "random_action", env_level=True)(lambda: none_attack)


def is_env_level(spec) -> bool:
    """True when the attack corrupts environment interaction rather than
    messages (paper: RandomAction)."""
    return bool(REGISTRY.meta("attack", spec).get("env_level", False))


def draws_noise(spec) -> bool:
    """True when the attack takes a noise tensor."""
    return bool(REGISTRY.meta("attack", spec).get("noise", False))


def get_attack(name, **kw) -> Callable:
    """Resolve an attack spec; extra ``kw`` merge into its kwargs."""
    spec = Spec.of(name)
    if kw:
        spec = spec.with_kwargs(**kw)
    return resolve("attack", spec)


def per_receiver(attack: Callable, K: int) -> Callable:
    """Lift an attack to send each receiver its own value: noise (K, K, d)
    or None -> messages (K_recv, K_send, d); with a row axis, honest
    (R, K, d) and noise (R, K, K, d) -> (R, K_recv, K_send, d)."""

    def fn(honest, byz_mask, noise=None):
        return torch.stack([
            attack(honest, byz_mask,
                   None if noise is None else noise[..., r, :, :])
            for r in range(K)], dim=-3)

    return fn
