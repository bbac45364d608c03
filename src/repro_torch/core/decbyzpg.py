"""DecByzPG: decentralized Byzantine fault-tolerant federated policy
gradient (paper Algorithm 2), the port of the JAX package's
``core/decbyzpg.py``.

Per iteration t, every agent k:
  1. reads the common coin c_t (forced to 1 at t=0);
  2. samples M = max(N, B) trajectories at its own θ_t^(k); the estimator
     weights keep the first N (c=1) or the first B (c=0);
  3. forms ṽ_t^(k): the plain estimate (c=1) or the PAGE correction with
     its realized previous step (θ_t − θ_{t−1})/η and an importance-weighted
     estimate at θ_{t−1} (c=0);
  4. robustly aggregates everyone's (possibly Byzantine) messages
     (bucketing ∘ RFA or Krum, the trimmed mean, ...);
  5. takes the optimizer step θ̃_{t+1} = θ_t + η v_t;
  6. runs Avg-Agree_κ (MDA/GDA, or the coordinate-wise cwmean, cwmed,
     cwtm) to contract the parameter diameter.

All K agents run together on (K, ...) tensors. The T iterations are a
Python loop; each step's randomness arrives as a
:class:`~repro_torch.core.noise.StepNoise`. A run is ``init`` + ``window``
over ``[0, T)`` + ``finish``; the sweep service chains windows over
slices of ``[0, T)`` with the carry and the generator's state saved
between them. The step's phases are
``torch.profiler`` ranges (``decbyzpg.noise``, ``.rollout``, ``.estimate``,
``.aggregate``, ``.agree``, ``.diameter``), six per iteration, which
``tools/profile_decbyzpg.py`` reads. With ``cfg.telemetry`` the step also
computes the honest gradient norm and the aggregator's rejection mask
(which launches kernels of its own, e.g. ``gram`` and ``krum_score`` for
Krum), taps them to the ``"decbyzpg"`` stream of :mod:`repro_torch.obs`
(one read to the host a step) and returns them; it draws nothing more, so
every other output is bit-identical to the run without it.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import obs, resolve_device
from repro_torch.core import attacks as attacks_lib
from repro_torch.core.aggregators import rejection_mask
from repro_torch.core.agreement import avg_agree, honest_diameter
from repro_torch.core.engine import (AlgoDef, add_telemetry, div_rows,
                                     history, lane_rows, seed_generator,
                                     traced_spec_kwargs, traced_value)
from repro_torch.core.noise import (StepNoise, draw_rows, draw_step_noise,
                                    stack_noise)
from repro_torch.core.registry import (normalize_spec_fields, register,
                                       resolve)
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.rl.gradient import grad_estimate, weighted_grad_estimate
from repro_torch.rl.policy import resolve_policy
from repro_torch.rl.rollout import batch_return, rollout
from repro_torch.topology import resolve_topology

_SPEC_FIELDS = ("attack", "aggregator", "agreement", "estimator",
                "optimizer", "topology", "policy")


@dataclasses.dataclass(frozen=True)
class DecByzPGConfig:
    """The reference's config: the same fields and defaults."""
    K: int = 13
    n_byz: int = 0
    attack: object = "none"
    aggregator: object = "rfa"
    agreement: object = "mda"
    kappa: int = 6
    per_receiver: bool = False
    topology: object = "complete"
    N: int = 50
    B: int = 4
    p: Optional[float] = None
    eta: float = 5e-3
    gamma: float = 0.999
    estimator: object = "gpomdp"
    policy: object = "mlp"
    activation: str = "relu"
    hidden: tuple = (16, 16)
    baseline: float = 0.0
    optimizer: object = "adam"
    seed: int = 0
    telemetry: bool = False     # taps + per-round rejected-agent masks

    def __post_init__(self):
        normalize_spec_fields(self, _SPEC_FIELDS)

    @property
    def switch_p(self) -> float:
        return self.p if self.p is not None else self.B / self.N


class Carry(NamedTuple):
    theta: torch.Tensor         # (K, d)
    theta_prev: torch.Tensor    # (K, d)
    opt_state: tuple            # the optimizer's per-agent state


def init_decbyzpg_carry(env, cfg: DecByzPGConfig,
                        generator: Optional[torch.Generator] = None,
                        theta0=None, device=None) -> Carry:
    """θ_0 (K, d) common to all agents, θ_prev = θ_0, fresh optimizer
    state. θ_0 is ``theta0`` ((d,) or (K, d)) when given, else drawn from
    ``generator`` by the policy's ``init_theta``."""
    dev = resolve_device(device)
    policy = resolve_policy(cfg, env)
    if theta0 is None:
        if generator is None:
            raise ValueError("init_decbyzpg_carry needs a generator or "
                             "theta0")
        vec = policy.init_theta(generator).to(dev)
    else:
        vec = torch.as_tensor(theta0, dtype=torch.float32, device=dev)
    if vec.shape[-1] != policy.d:
        raise ValueError(f"theta0 has {vec.shape[-1]} entries, the policy "
                         f"needs {policy.d}")
    theta = vec.expand(cfg.K, policy.d).clone()
    opt = get_optimizer(cfg.optimizer, cfg.eta)
    return Carry(theta, theta.clone(), opt.init(theta))


def build_decbyzpg_step(env, cfg: DecByzPGConfig, device, traced=None):
    """One iteration ``step(carry, noise, t) -> (carry, (ret, coin,
    diam))`` with the honest mean return, the coin and the honest diameter
    as device tensors (no host sync). With ``cfg.telemetry`` the outputs
    gain the honest mean message norm and the rejected-agent mask (K,),
    tapped to the ``"decbyzpg"`` stream.

    ``traced`` (lane batching) maps the registered ``traced_fields`` and
    the traced spec kwargs (``"attack.sigma"``, ``"aggregator.nu"``) to
    (R,) float32 tensors on ``device``, one value per row, overriding the
    config's numbers. The step then takes a carry with a leading row axis
    (θ (R, K, d)) and the rows' stacked StepNoise, folds the R·K agents
    into the agent axis of the rollout and the estimators, and every
    output gains the row axis; each kernel launches once for all rows."""
    dev = torch.device(device)
    lanes = traced is not None
    eta = traced_value(traced, "eta", cfg.eta)
    gamma = traced_value(traced, "gamma", cfg.gamma)
    baseline = traced_value(traced, "baseline", cfg.baseline)
    policy = resolve_policy(cfg, env)
    K, d = cfg.K, policy.d
    byz_mask = torch.arange(K, device=dev) < cfg.n_byz
    honest = ~byz_mask
    n_honest = max(K - cfg.n_byz, 1)
    attack = resolve("attack", cfg.attack,
                     **traced_spec_kwargs(traced, "attack", (-1, 1, 1)))
    agr_attack = (attacks_lib.per_receiver(attack, K)
                  if cfg.per_receiver else attack)
    agg = resolve("aggregator", cfg.aggregator, K=K, n_byz=cfg.n_byz,
                  **traced_spec_kwargs(traced, "aggregator"))
    env_level = attacks_lib.is_env_level(cfg.attack)
    scales = torch.where(byz_mask & env_level, 0.0, 1.0)
    opt = get_optimizer(cfg.optimizer, eta)
    topo = resolve_topology(cfg.topology, K)

    M = max(cfg.N, cfg.B)
    idx = torch.arange(M, device=dev)
    w_large = torch.where(idx < cfg.N, 1.0 / cfg.N, 0.0)
    w_small = torch.where(idx < cfg.B, 1.0 / cfg.B, 0.0)
    if lanes:
        # the rows' agents fold into the agent axis, each taking its row's
        # discount, baseline and logit scale
        R = eta.shape[0]
        gamma = gamma.repeat_interleave(K)
        baseline = baseline.repeat_interleave(K)
        scales = scales.repeat(R)

    def step(carry: Carry, noise: StepNoise, t: int):
        theta, theta_prev, opt_state = carry
        coin = noise.coin
        w = torch.where(coin[..., None], w_large, w_small)
        # per agent: the (R, M) row weights over the rows' agents
        wa = w[:, None].expand(-1, K, -1).reshape(-1, M) if lanes else w
        agents = theta.reshape(-1, d)
        with record_function("decbyzpg.rollout"):
            traj = rollout(env, policy, agents,
                           noise.s0.reshape(-1, *noise.s0.shape[-2:]),
                           noise.gumbel.reshape(-1,
                                                *noise.gumbel.shape[-3:]),
                           scales)
        with record_function("decbyzpg.estimate"):
            g = grad_estimate(policy, agents, traj, gamma, baseline,
                              cfg.estimator, sample_weights=wa
                              ).reshape(theta.shape)
            # IS-corrected estimate at θ_prev on the small-batch slice; the
            # coin select drops it on large steps
            g_old = weighted_grad_estimate(policy, theta_prev.reshape(-1, d),
                                           agents, traj, gamma, baseline,
                                           cfg.estimator,
                                           sample_weights=w_small
                                           ).reshape(theta.shape)
            rets = (wa * batch_return(traj)).sum(-1).reshape(
                theta.shape[:-1])                                # (…, K)
            page = div_rows(theta - theta_prev, eta) - g_old
            tilde_v = torch.where(coin[..., None, None] if lanes else coin,
                                  g, g + page)
        with record_function("decbyzpg.aggregate"):
            msgs = attack(tilde_v, byz_mask, noise.attack)
            # one aggregate shared by all receivers, or one per receiver
            # when each buckets with its own permutation
            v = agg(msgs, noise.perm).expand(theta.shape)
            theta_tilde, opt_state = opt.update(v, opt_state, theta)
        with record_function("decbyzpg.agree"):
            theta_new = theta_tilde if cfg.kappa == 0 else avg_agree(
                theta_tilde, cfg.kappa, cfg.n_byz, byz_mask, cfg.agreement,
                agr_attack, noise.agree_attack, topology=topo)
        with record_function("decbyzpg.diameter"):
            honest_ret = torch.where(byz_mask, 0.0, rets).sum(-1) / n_honest
            diam = honest_diameter(theta_new, honest)
        carry = Carry(theta_new, theta, opt_state)
        if not cfg.telemetry:
            return carry, (honest_ret, coin, diam)
        # observers only: nothing drawn, nothing the run's outputs read
        norms = torch.linalg.vector_norm(tilde_v, dim=-1)
        grad_norm = torch.where(byz_mask, 0.0, norms).sum(-1) / n_honest
        rejected = rejection_mask(cfg.aggregator, msgs, cfg.n_byz)
        obs.tap("decbyzpg", t=np.int32(t), coin=coin,
                honest_return=honest_ret, diameter=diam, grad_norm=grad_norm,
                rejected=rejected)
        return carry, (honest_ret, coin, diam, grad_norm, rejected)

    return step


def window_decbyzpg(env, cfg: DecByzPGConfig, carry: Carry,
                    generator, t0: int, t1: int,
                    noise: Optional[Sequence] = None, traced=None):
    """Iterations ``[t0, t1)`` from ``carry``: ``(carry, chunk)`` with the
    chunk's histories (numpy, time axis 0). Each step's draws come from
    ``generator`` in order, so chaining windows over ``[0, T)`` with one
    generator is the uninterrupted run; ``noise`` (the whole run's T
    StepNoise) replaces the draws with ``noise[t0:t1]``.

    ``traced`` (lane batching: ``{name: (R,) float32 host tensor}``, see
    :func:`build_decbyzpg_step`) runs a lane group's R rows: ``carry`` has
    a leading row axis, ``generator`` is the rows' generators, each row
    draws from its own with its own ``switch_p``
    (:func:`~repro_torch.core.noise.draw_rows`), ``noise`` holds each
    row's T StepNoise, and the histories are (R, t1 - t0, ...)."""
    dev = carry.theta.device
    policy = resolve_policy(cfg, env)
    lanes = traced is not None
    if lanes:
        cfgs, traced = lane_rows(cfg, traced, dev)
    step = build_decbyzpg_step(env, cfg, dev, traced)
    ys: List[tuple] = []
    for t in range(t0, t1):
        if noise is not None:
            nz = stack_noise([n[t] for n in noise]) if lanes else noise[t]
        else:
            with record_function("decbyzpg.noise"):
                nz = draw_rows(draw_step_noise, generator, cfgs, env,
                               policy.d, t) if lanes else \
                    draw_step_noise(generator, cfg, env, policy.d, t)
        carry, y = step(carry, nz, t)
        ys.append(y)
    return carry, history(ys, ("returns", "coins", "diameter", "grad_norm",
                               "rejected"), rows=lanes)


def finish_decbyzpg(env, cfg: DecByzPGConfig, carry: Carry,
                    chunks: Sequence[dict]) -> dict:
    """The run's output from its final carry and its windows' chunks."""
    hist = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    theta = carry.theta
    honest_idx = min(cfg.n_byz, cfg.K - 1)
    out = {"returns": hist["returns"],
           "coins": hist["coins"],
           "samples": np.cumsum(np.where(hist["coins"], cfg.N, cfg.B)),
           "diameter": hist["diameter"],
           "params": resolve_policy(cfg, env).layers(theta[honest_idx]),
           "theta": theta}
    return add_telemetry(out, hist, cfg.n_byz)


def run_decbyzpg(env, cfg: DecByzPGConfig, T: int, *, device=None,
                 theta0=None,
                 noise: Optional[Sequence[StepNoise]] = None) -> dict:
    """Run T iterations: :func:`init_decbyzpg_carry`, one
    :func:`window_decbyzpg` over ``[0, T)``, :func:`finish_decbyzpg`.
    Returns the honest mean returns, the coins, the per-agent sample
    counts, the honest diameter trace (numpy), and the final θ (K, d) with
    an honest agent's parameters; with ``cfg.telemetry`` also the honest
    gradient norms (T,), the rejected masks (T, K) and their
    ``aggregator_confusion`` tally.

    ``device=None`` means CUDA. ``theta0`` ((d,) or (K, d)) replaces the
    seeded init; ``noise`` (T StepNoise on ``device``) replaces the seeded
    draws. The tests use both to replay the reference's random streams.
    """
    dev = resolve_device(device)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if noise is not None and len(noise) != T:
        raise ValueError(f"noise holds {len(noise)} steps, T={T}")
    gen = seed_generator(cfg.seed, dev)
    carry = init_decbyzpg_carry(env, cfg, gen, theta0, dev)
    carry, chunk = window_decbyzpg(env, cfg, carry, gen, 0, T, noise)
    return finish_decbyzpg(env, cfg, carry, [chunk])


register("algo", "decbyzpg")(
    lambda: AlgoDef(DecByzPGConfig, run_decbyzpg, init_decbyzpg_carry,
                    window_decbyzpg, finish_decbyzpg, carry_hist="theta",
                    traced_fields=("eta", "gamma", "baseline", "switch_p")))
