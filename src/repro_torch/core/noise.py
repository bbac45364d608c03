"""Everything one DecByzPG or ByzPG step draws, as explicit tensors.

The JAX package threads PRNG keys through the step and draws inside it.
The port draws a step's randomness up front, on the device, in one batched
pass from a :class:`torch.Generator`, and hands the step a
:class:`StepNoise` (a federated LLM step a :class:`FedNoise`). The two frameworks' generators give different numbers,
so a parity test builds the StepNoise from the reference's own key tree
instead and feeds it to the port (``run_decbyzpg(..., noise=...)``, ``fed_train_step(..., noise)``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import attacks as attacks_lib
from repro_torch.core.registry import resolve


class StepNoise(NamedTuple):
    """One step's draws; a lane group's rows stack along a leading row
    axis (:func:`stack_noise`)."""
    coin: torch.Tensor                    # () bool, PAGE coin, 1 at t=0
    s0: torch.Tensor                      # (K, M, obs_dim) reset states
    gumbel: torch.Tensor                  # (K, M, H, A) action noise
    attack: Optional[torch.Tensor]        # (K, d) message-attack normals
    agree_attack: Optional[torch.Tensor]  # (κ, K, d) or (κ, K, K, d)
    perm: Optional[torch.Tensor]          # (R, K) bucketing permutations


def stack_noise(noises) -> StepNoise:
    """The rows' StepNoise of one step stacked along a new leading row
    axis (lane batching): each field (R, ...), a field that no row draws
    None."""
    return StepNoise(*(None if f[0] is None else torch.stack(f)
                       for f in zip(*noises)))


def draw_rows(draw, generators, cfgs, env, d: int, t: int) -> StepNoise:
    """Step ``t``'s noise of a lane group: ``draw(generator, cfg, env, d,
    t)`` (:func:`draw_step_noise` or :func:`draw_byzpg_noise`) for each
    row from the row's own generator and config, in the single run's
    order, then stacked (:func:`stack_noise`). So a row's draws are the
    bits of the single run for its seed on the same device."""
    return stack_noise([draw(g, c, env, d, t)
                        for g, c in zip(generators, cfgs)])


def _gumbel(generator, shape) -> torch.Tensor:
    """-log(-log(U)), U uniform on [tiny, 1), as ``jax.random.gumbel``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def draw_step_noise(generator: torch.Generator, cfg, env, d: int,
                    t: int) -> StepNoise:
    """Draw DecByzPG step ``t``'s :class:`StepNoise` for ``cfg`` on the
    generator's device: κ rounds of agreement noise (one per receiver with
    ``per_receiver``) and one bucketing permutation per receiver."""
    K = cfg.K
    per_round = (K, K, d) if cfg.per_receiver else (K, d)
    return _draw(generator, cfg, env, d, t, (cfg.kappa, *per_round), K)


def draw_byzpg_noise(generator: torch.Generator, cfg, env, d: int,
                     t: int) -> StepNoise:
    """Draw ByzPG step ``t``'s :class:`StepNoise`: no agreement draws, and
    one bucketing permutation (1, K), since the server aggregates once."""
    return _draw(generator, cfg, env, d, t, None, 1)


def _draw(generator, cfg, env, d: int, t: int, agree_shape,
          receivers: int) -> StepNoise:
    """M = max(N, B) trajectories per agent are always drawn; the attack
    and agreement normals only for an attack that draws noise, and the
    ``receivers`` permutations only for an aggregator that buckets."""
    dev = generator.device
    K, M, H, A = cfg.K, max(cfg.N, cfg.B), env.horizon, env.n_actions
    p = cfg.switch_p
    coin = (torch.rand((), generator=generator, device=dev) < p) | (t == 0)
    s0 = env.reset(generator, (K, M))
    gumbel = _gumbel(generator, (K, M, H, A))
    attack = agree = None
    if attacks_lib.draws_noise(cfg.attack):
        attack = torch.randn((K, d), generator=generator, device=dev)
        if agree_shape is not None:
            agree = torch.randn(agree_shape, generator=generator, device=dev)
    perm = None
    if resolve("aggregator", cfg.aggregator, K=K,
               n_byz=cfg.n_byz).bucket_size:
        perm = torch.argsort(
            torch.rand((receivers, K), generator=generator, device=dev),
            dim=1)
    return StepNoise(coin, s0, gumbel, attack, agree, perm)


class FedNoise(NamedTuple):
    """What one step of :mod:`repro_torch.distributed.fed_trainer` draws."""
    attack: Optional[torch.Tensor]  # (n_byz, D) normals, Byzantine rows
    perm: Optional[torch.Tensor]    # (1, K) bucketing permutation


def draw_fed_noise(generator: torch.Generator, fed, K: int, D: int,
                   n_byz: int, flat: bool) -> FedNoise:
    """Draw one federated step's :class:`FedNoise` on the generator's
    device: the normals of the ``n_byz`` Byzantine rows over the raveled
    parameters (D entries each) for an attack that draws noise, and, on
    the flat trainer (``flat``) with a bucketing registry aggregator, the
    one receiver's permutation. Nothing with K = 1, where the step
    neither attacks nor aggregates."""
    from repro_torch.core.registry import REGISTRY
    dev = generator.device
    attack = perm = None
    if K > 1 and n_byz > 0 and REGISTRY.meta("fed_attack",
                                             fed.attack).get("noise"):
        attack = torch.randn((n_byz, D), generator=generator, device=dev)
    if K > 1 and flat and resolve("aggregator", fed.aggregator, K=K,
                                  n_byz=fed.n_byz).bucket_size:
        perm = torch.argsort(
            torch.rand((1, K), generator=generator, device=dev), dim=1)
    return FedNoise(attack, perm)


def draw_fed_coins(generator: torch.Generator, ts, p: float) -> list:
    """The PAGE coins of a window's steps ``ts``: c_t = (t == 0) or
    u_t < p, the uniforms drawn in one call and read to the host once."""
    u = torch.rand((len(ts),), generator=generator, device=generator.device)
    # analysis: host-side (the coins pick each step's branch on the host)
    return [int(t) == 0 or bool(c) for t, c in zip(ts, (u < p).tolist())]
