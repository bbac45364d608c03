"""Everything one DecByzPG step draws, as explicit tensors.

The JAX package threads PRNG keys through the step and draws inside it.
The port draws a step's randomness up front, on the device, in one batched
pass from a :class:`torch.Generator`, and hands the step a
:class:`StepNoise`. The two frameworks' generators give different numbers,
so a parity test builds the StepNoise from the reference's own key tree
instead and feeds it to the port (``run_decbyzpg(..., noise=...)``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import attacks as attacks_lib
from repro_torch.core.registry import resolve


class StepNoise(NamedTuple):
    coin: torch.Tensor                    # () bool, PAGE coin, 1 at t=0
    s0: torch.Tensor                      # (K, M, obs_dim) reset states
    gumbel: torch.Tensor                  # (K, M, H, A) action noise
    attack: Optional[torch.Tensor]        # (K, d) message-attack normals
    agree_attack: Optional[torch.Tensor]  # (κ, K, d) or (κ, K, K, d)
    perm: Optional[torch.Tensor]          # (K, K) bucketing permutations


def _gumbel(generator, shape) -> torch.Tensor:
    """-log(-log(U)), U uniform on [tiny, 1), as ``jax.random.gumbel``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def draw_step_noise(generator: torch.Generator, cfg, env, d: int,
                    t: int) -> StepNoise:
    """Draw step ``t``'s :class:`StepNoise` for ``cfg`` on the generator's
    device. M = max(N, B) trajectories per agent are always drawn."""
    dev = generator.device
    K, M, H, A = cfg.K, max(cfg.N, cfg.B), env.horizon, env.n_actions
    p = cfg.switch_p
    coin = (torch.rand((), generator=generator, device=dev) < p) | (t == 0)
    s0 = env.reset(generator, (K, M))
    gumbel = _gumbel(generator, (K, M, H, A))
    attack = agree = None
    if attacks_lib.draws_noise(cfg.attack):
        attack = torch.randn((K, d), generator=generator, device=dev)
        per_round = (K, K, d) if cfg.per_receiver else (K, d)
        agree = torch.randn((cfg.kappa, *per_round), generator=generator,
                            device=dev)
    perm = None
    if resolve("aggregator", cfg.aggregator, K=K,
               n_byz=cfg.n_byz).bucket_size:
        perm = torch.argsort(
            torch.rand((K, K), generator=generator, device=dev), dim=1)
    return StepNoise(coin, s0, gumbel, attack, agree, perm)

