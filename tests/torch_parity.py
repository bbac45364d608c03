"""Shared helpers of the ``test_torch_*`` parity tests.

The JAX package draws inside its steps from a PRNG key tree; the port takes
a step's draws as explicit tensors (``repro_torch.core.noise.StepNoise``).
These helpers replay the reference's key tree with ``jax.random`` and hand
the port the very numbers the reference consumed, as CPU tensors.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro.core import engine
from repro_torch.core.noise import StepNoise
from repro_torch.core.registry import resolve as torch_resolve


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


@functools.partial(jax.jit, static_argnums=(0, 2))
def trajectory_draws(env, key, n: int):
    """What ``rollout.sample_batch(env, params, key, n)`` draws: the reset
    states (n, obs_dim) and the Gumbel noise of every action (n, H, A)."""

    def one(k):
        k_reset, k_steps = jax.random.split(k)
        g = jax.vmap(lambda kk: jax.random.gumbel(kk, (env.n_actions,)))(
            jax.random.split(k_steps, env.horizon))
        return env.reset(k_reset), g

    return jax.vmap(one)(jax.random.split(key, n))


def bucket_perms(key, K: int):
    """The permutations ``bucketing`` draws for K receivers keyed by
    ``split(key, K)``: each splits its key and permutes with the first."""
    return jax.vmap(lambda k: jax.random.permutation(
        jax.random.split(k)[0], K))(jax.random.split(key, K))


def agreement_draws(key, kappa: int, K: int, d: int, per_receiver: bool):
    """What ``large_noise`` draws inside ``agreement.avg_agree(...,
    key)``: ``split(key, kappa)`` rounds, each (K, d) normals, or with
    ``per_receiver`` one (K, d) draw per receiver from ``split(k, K)``."""
    rounds = jax.random.split(key, kappa)
    if per_receiver:
        return jax.vmap(lambda k: jax.vmap(
            lambda kk: jax.random.normal(kk, (K, d)))(
                jax.random.split(k, K)))(rounds)
    return jax.vmap(lambda k: jax.random.normal(k, (K, d)))(rounds)


def replay_step_noise(env, cfg, d: int, T: int):
    """The T StepNoise of ``decbyzpg.run_decbyzpg(env, cfg, T)``, replayed
    from ``engine.seed_keys(cfg.seed)``: ``split(loop, T)``, then
    ``split(key, 4)`` into trajectory, attack, aggregation and agreement
    keys, and the coin from ``fold_in(coin, t)``."""
    K, M = cfg.K, max(cfg.N, cfg.B)
    ks = engine.seed_keys(cfg.seed)
    step_keys = jax.random.split(ks.loop, T)
    noisy = cfg.attack.name == "large_noise"
    # the port's aggregator buckets exactly when the reference's does
    bucketed = torch_resolve("aggregator", str(cfg.aggregator), K=K,
                             n_byz=cfg.n_byz).bucket_size > 0

    @jax.jit
    def draws(step_key):
        k_traj, k_att, k_agg, k_agr = jax.random.split(step_key, 4)
        s0, gumbel = jax.vmap(lambda k: trajectory_draws(env, k, M))(
            jax.random.split(k_traj, K))
        attack = agree = perm = None
        if noisy:
            attack = jax.random.normal(k_att, (K, d))
            agree = agreement_draws(k_agr, cfg.kappa, K, d, cfg.per_receiver)
        if bucketed:
            perm = bucket_perms(k_agg, K)
        return s0, gumbel, attack, agree, perm

    out = []
    for t in range(T):
        coin = engine.page_coin(ks.coin, t, cfg.switch_p)
        s0, gumbel, attack, agree, perm = draws(step_keys[t])
        out.append(StepNoise(
            torch.as_tensor(bool(coin)), to_torch(s0), to_torch(gumbel),
            None if attack is None else to_torch(attack),
            None if agree is None else to_torch(agree),
            None if perm is None else to_torch(perm).long()))
    return out


def replay_byzpg_noise(env, cfg, d: int, T: int):
    """The T StepNoise of ``byzpg.run_byzpg(env, cfg, T)``, replayed from
    ``engine.seed_keys(cfg.seed)``: ``split(loop, T)``, then
    ``split(key, 3)`` into trajectory, attack and aggregation keys; the
    server's one bucketing permutation ``permutation(split(k_agg)[0], K)``;
    the coin from ``fold_in(coin, t)``. No agreement draws."""
    K, M = cfg.K, max(cfg.N, cfg.B)
    ks = engine.seed_keys(cfg.seed)
    step_keys = jax.random.split(ks.loop, T)
    noisy = cfg.attack.name == "large_noise"
    bucketed = torch_resolve("aggregator", str(cfg.aggregator), K=K,
                             n_byz=cfg.n_byz).bucket_size > 0

    @jax.jit
    def draws(step_key):
        k_traj, k_att, k_agg = jax.random.split(step_key, 3)
        s0, gumbel = jax.vmap(lambda k: trajectory_draws(env, k, M))(
            jax.random.split(k_traj, K))
        attack = perm = None
        if noisy:
            attack = jax.random.normal(k_att, (K, d))
        if bucketed:
            perm = jax.random.permutation(jax.random.split(k_agg)[0], K)[None]
        return s0, gumbel, attack, perm

    out = []
    for t in range(T):
        coin = engine.page_coin(ks.coin, t, cfg.switch_p)
        s0, gumbel, attack, perm = draws(step_keys[t])
        out.append(StepNoise(
            torch.as_tensor(bool(coin)), to_torch(s0), to_torch(gumbel),
            None if attack is None else to_torch(attack), None,
            None if perm is None else to_torch(perm).long()))
    return out
