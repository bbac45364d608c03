"""ByzPG: centralized Byzantine fault-tolerant federated policy gradient
(paper Algorithm 1), the port of the JAX package's ``core/byzpg.py``.

Per iteration t, over K agents:

* the coin c_t ~ Be(p) (forced to 1 at t=0); on c=1 every worker samples
  N trajectories at θ_t and sends its PG estimate, which the server
  robustly aggregates;
* on c=0 the **server alone** samples B trajectories and applies the PAGE
  correction ``v_t = ĝ_B(θ_t) + v_{t-1} − ĝ_B^{ω_{θ_t}}(θ_{t-1})`` with
  importance sampling;
* Byzantine agents' messages are replaced by the configured attack
  (``random_action`` corrupts their environment interaction instead);
* the optimizer (Adam by default, ``optimizer="sgd"`` for Algorithm 1's
  plain ascent) steps θ along v_t.

As in the reference, every step has the fixed (K, M = max(N, B))
trajectory shape, with estimator weights masking small steps down to B,
and the server's small-batch stream is the last agent slot (K−1 is honest
for any tolerated n_byz < K; all workers hold the same θ_t, so slot K−1's
trajectories are exactly a fresh server sample). The aggregation runs on
every step and the coin selects its result, so the step reads nothing
back to the host.

The T iterations are a Python loop over one step, each step's randomness
arriving as a :class:`~repro_torch.core.noise.StepNoise` (no agreement
draws; one bucketing permutation, since the server aggregates once). A
run is ``init`` + ``window`` over ``[0, T)`` + ``finish``, the windows
being the counterpart of the reference's ``build_byzpg_window``; its
``run_byzpg_legacy`` manages jit dispatch and has no counterpart here.
With ``cfg.telemetry`` the step also taps the honest gradient norm and
the aggregator's rejection mask to the ``"byzpg"`` stream of
:mod:`repro_torch.obs`; it draws nothing more, so the other outputs are
bit-identical to the run without it.
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
from repro_torch.core.engine import (AlgoDef, add_telemetry, history,
                                     lane_rows, seed_generator,
                                     traced_spec_kwargs, traced_value)
from repro_torch.core.noise import (StepNoise, draw_byzpg_noise, draw_rows,
                                    stack_noise)
from repro_torch.core.registry import (normalize_spec_fields, register,
                                       resolve)
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.rl.gradient import grad_estimate, weighted_grad_estimate
from repro_torch.rl.policy import resolve_policy
from repro_torch.rl.rollout import batch_return, rollout

_SPEC_FIELDS = ("attack", "aggregator", "estimator", "optimizer", "policy")


@dataclasses.dataclass(frozen=True)
class ByzPGConfig:
    """The reference's config: the same fields and defaults."""
    K: int = 13
    n_byz: int = 0
    attack: object = "none"
    aggregator: object = "rfa"
    N: int = 50                 # large batch
    B: int = 4                  # small batch
    p: Optional[float] = None   # switch probability; default B/N
    eta: float = 5e-3
    gamma: float = 0.999
    estimator: object = "gpomdp"
    policy: object = "mlp"
    activation: str = "relu"
    hidden: tuple = (16, 16)
    optimizer: object = "adam"
    baseline: float = 0.0
    seed: int = 0
    telemetry: bool = False     # taps + per-round rejected-agent masks

    def __post_init__(self):
        normalize_spec_fields(self, _SPEC_FIELDS)

    @property
    def switch_p(self) -> float:
        return self.p if self.p is not None else self.B / self.N


class ByzPGCarry(NamedTuple):
    theta: torch.Tensor         # (d,) the server's iterate θ_t
    theta_prev: torch.Tensor    # (d,) θ_{t−1}
    v_prev: torch.Tensor        # (d,) the previous direction v_{t−1}
    opt_state: tuple


def init_byzpg_carry(env, cfg: ByzPGConfig,
                     generator: Optional[torch.Generator] = None,
                     theta0=None, device=None) -> ByzPGCarry:
    """(θ_0, θ_prev = θ_0, v_prev = 0, fresh optimizer state). θ_0 is
    ``theta0`` (d,) when given, else drawn from ``generator`` by the
    policy's ``init_theta``."""
    dev = resolve_device(device)
    policy = resolve_policy(cfg, env)
    if theta0 is None:
        if generator is None:
            raise ValueError("init_byzpg_carry needs a generator or theta0")
        vec = policy.init_theta(generator).to(dev)
    else:
        vec = torch.as_tensor(theta0, dtype=torch.float32, device=dev)
    if tuple(vec.shape) != (policy.d,):
        raise ValueError(f"theta0 has shape {tuple(vec.shape)}, the policy "
                         f"needs ({policy.d},)")
    opt = get_optimizer(cfg.optimizer, cfg.eta)
    return ByzPGCarry(vec, vec.clone(), torch.zeros_like(vec), opt.init(vec))


def build_byzpg_step(env, cfg: ByzPGConfig, device, traced=None):
    """One iteration ``step(carry, noise, t) -> (carry, (ret, coin))`` with
    the iteration's return (the honest mean on large steps, the server's
    on small ones) and the coin as device tensors (no host sync). With
    ``cfg.telemetry`` the outputs gain the honest mean message norm and
    the rejected-agent mask (K,), tapped to the ``"byzpg"`` stream.

    ``traced`` (lane batching, as ``build_decbyzpg_step``'s) takes a carry
    with a leading row axis (θ (R, d)) and the rows' stacked StepNoise;
    the R·K workers fold into the agent axis."""
    dev = torch.device(device)
    lanes = traced is not None
    eta = traced_value(traced, "eta", cfg.eta)
    gamma = traced_value(traced, "gamma", cfg.gamma)
    baseline = traced_value(traced, "baseline", cfg.baseline)
    policy = resolve_policy(cfg, env)
    K, d = cfg.K, policy.d
    byz_mask = torch.arange(K, device=dev) < cfg.n_byz
    n_honest = max(K - cfg.n_byz, 1)
    attack = resolve("attack", cfg.attack,
                     **traced_spec_kwargs(traced, "attack", (-1, 1, 1)))
    agg = resolve("aggregator", cfg.aggregator, K=K, n_byz=cfg.n_byz,
                  **traced_spec_kwargs(traced, "aggregator"))
    env_level = attacks_lib.is_env_level(cfg.attack)
    scales = torch.where(byz_mask & env_level, 0.0, 1.0)
    opt = get_optimizer(cfg.optimizer, eta)

    M = max(cfg.N, cfg.B)
    idx = torch.arange(M, device=dev)
    w_large = torch.where(idx < cfg.N, 1.0 / cfg.N, 0.0)
    w_small = torch.where(idx < cfg.B, 1.0 / cfg.B, 0.0)
    server = K - 1              # honest slot backing the server's stream
    if lanes:
        R = eta.shape[0]
        gamma = gamma.repeat_interleave(K)
        baseline = baseline.repeat_interleave(K)
        scales = scales.repeat(R)

    def step(carry: ByzPGCarry, noise: StepNoise, t: int):
        vec, prev_vec, v_prev, opt_state = carry
        coin = noise.coin
        w = torch.where(coin[..., None], w_large, w_small)
        wa = w[:, None].expand(-1, K, -1).reshape(-1, M) if lanes else w
        # every worker (and the server, in slot K−1) samples at θ_t
        theta = vec[..., None, :].expand(*vec.shape[:-1], K, d)
        agents = theta.reshape(-1, d)
        with record_function("byzpg.rollout"):
            traj = rollout(env, policy, agents,
                           noise.s0.reshape(-1, *noise.s0.shape[-2:]),
                           noise.gumbel.reshape(-1,
                                                *noise.gumbel.shape[-3:]),
                           scales)
        with record_function("byzpg.estimate"):
            g = grad_estimate(policy, agents, traj, gamma, baseline,
                              cfg.estimator, sample_weights=wa
                              ).reshape(theta.shape)
            g_old = weighted_grad_estimate(
                policy, prev_vec[..., None, :].expand(theta.shape).reshape(
                    -1, d), agents, traj, gamma, baseline, cfg.estimator,
                sample_weights=w_small).reshape(theta.shape)
            rets = (wa * batch_return(traj)).sum(-1).reshape(
                theta.shape[:-1])                                # (…, K)
        with record_function("byzpg.aggregate"):
            msgs = attack(g, byz_mask, noise.attack)
            v_large = agg(msgs, noise.perm)[..., 0, :]
        # small step: w == w_small, so g[server] is exactly ĝ_B(θ_t) on the
        # server's fresh batch and g_old[server] the IS estimate at θ_prev
        v_page = g[..., server, :] + v_prev - g_old[..., server, :]
        c = coin[..., None] if lanes else coin
        v = torch.where(c, v_large, v_page)
        new_vec, opt_state = opt.update(v, opt_state, vec)
        honest_ret = torch.where(byz_mask, 0.0, rets).sum(-1) / n_honest
        ret = torch.where(coin, honest_ret, rets[..., server])
        carry = ByzPGCarry(new_vec, vec, v, opt_state)
        if not cfg.telemetry:
            return carry, (ret, coin)
        # observers only: the aggregation is live on large rounds; small
        # rounds still score the attacked messages the server would get
        norms = torch.linalg.vector_norm(g, dim=-1)
        grad_norm = torch.where(byz_mask, 0.0, norms).sum(-1) / n_honest
        rejected = rejection_mask(cfg.aggregator, msgs, cfg.n_byz)
        obs.tap("byzpg", t=np.int32(t), coin=coin, honest_return=ret,
                grad_norm=grad_norm, rejected=rejected)
        return carry, (ret, coin, grad_norm, rejected)

    return step


def window_byzpg(env, cfg: ByzPGConfig, carry: ByzPGCarry,
                 generator, t0: int, t1: int,
                 noise: Optional[Sequence] = None, traced=None):
    """Iterations ``[t0, t1)`` from ``carry``: ``(carry, chunk)`` with the
    chunk's histories (numpy, time axis 0). Each step's draws come from
    ``generator`` in order, so chaining windows over ``[0, T)`` with one
    generator is the uninterrupted run; ``noise`` (the whole run's T
    StepNoise) replaces the draws with ``noise[t0:t1]``. ``traced`` runs
    a lane group's rows, as ``window_decbyzpg``'s does."""
    dev = carry.theta.device
    policy = resolve_policy(cfg, env)
    lanes = traced is not None
    if lanes:
        cfgs, traced = lane_rows(cfg, traced, dev)
    step = build_byzpg_step(env, cfg, dev, traced)
    ys: List[tuple] = []
    for t in range(t0, t1):
        if noise is not None:
            nz = stack_noise([n[t] for n in noise]) if lanes else noise[t]
        else:
            with record_function("byzpg.noise"):
                nz = draw_rows(draw_byzpg_noise, generator, cfgs, env,
                               policy.d, t) if lanes else \
                    draw_byzpg_noise(generator, cfg, env, policy.d, t)
        carry, y = step(carry, nz, t)
        ys.append(y)
    return carry, history(ys, ("returns", "coins", "grad_norm", "rejected"),
                          rows=lanes)


def finish_byzpg(env, cfg: ByzPGConfig, carry: ByzPGCarry,
                 chunks: Sequence[dict]) -> dict:
    """The run's output from its final carry and its windows' chunks."""
    hist = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    out = {"returns": hist["returns"],
           "coins": hist["coins"],
           "samples": np.cumsum(np.where(hist["coins"], cfg.N, cfg.B)),
           "params": resolve_policy(cfg, env).layers(carry.theta),
           "vec": carry.theta}
    return add_telemetry(out, hist, cfg.n_byz)


def run_byzpg(env, cfg: ByzPGConfig, T: int, eval_every: int = 1, *,
              device=None, theta0=None,
              noise: Optional[Sequence[StepNoise]] = None) -> dict:
    """Run T iterations: :func:`init_byzpg_carry`, one
    :func:`window_byzpg` over ``[0, T)``, :func:`finish_byzpg`. Returns
    the returns and coins (numpy), the per-agent sample counts, the final
    θ (d,) as ``vec`` and as the policy's ``params``; with
    ``cfg.telemetry`` also the honest gradient norms (T,), the rejected
    masks (T, K) and their ``aggregator_confusion`` tally. The returns
    and sample counts are those of every ``eval_every``-th iteration
    (0, eval_every, ...), as the reference reports them.

    ``device=None`` means CUDA. ``theta0`` (d,) replaces the seeded init;
    ``noise`` (T StepNoise on ``device``) replaces the seeded draws. The
    tests use both to replay the reference's random streams.
    """
    dev = resolve_device(device)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if noise is not None and len(noise) != T:
        raise ValueError(f"noise holds {len(noise)} steps, T={T}")
    gen = seed_generator(cfg.seed, dev)
    carry = init_byzpg_carry(env, cfg, gen, theta0, dev)
    carry, chunk = window_byzpg(env, cfg, carry, gen, 0, T, noise)
    out = finish_byzpg(env, cfg, carry, [chunk])
    for k in ("returns", "samples"):
        out[k] = out[k][::eval_every]
    return out


register("algo", "byzpg")(
    lambda: AlgoDef(ByzPGConfig, run_byzpg, init_byzpg_carry, window_byzpg,
                    finish_byzpg, carry_hist="vec",
                    traced_fields=("eta", "gamma", "baseline", "switch_p")))
