"""Shared helpers of the ``test_torch_*`` parity tests.

The JAX package draws inside its steps from a PRNG key tree; the port takes
a step's draws as explicit tensors (``repro_torch.core.noise.StepNoise``).
These helpers replay the reference's key tree with ``jax.random`` and hand
the port the very numbers the reference consumed, as CPU tensors (a
federated LLM step's as a ``FedNoise``).
:func:`routing_margins` records how close the port's MoE layers came to a
discontinuity in their routing; :func:`shared_loss_trace` lets the
federated reference programs of a test module share one trace of the
model's loss. :func:`assert_streams_agree` holds the port's greedy token
streams to the reference's unbatched ones under the margin rule.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engine
from repro.distributed import fed_trainer as jft
from repro.models import model as jm
from repro_torch.core.noise import FedNoise, StepNoise
from repro_torch.core.registry import resolve as torch_resolve


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


@contextlib.contextmanager
def routing_margins():
    """While active, every ``repro_torch.models.moe.moe_forward`` call
    appends its smallest top-k routing margin (the gap between the k-th
    and (k+1)-th router probability over its tokens) to the yielded
    list."""
    from repro_torch.models import moe
    margins, orig = [], moe.moe_forward

    def recorded(p, cfg, x, **kw):
        with torch.no_grad():
            margins.append(moe.top_k_margin(moe.router_probs(p, x),
                                            cfg.moe.top_k).item())
        return orig(p, cfg, x, **kw)

    moe.moe_forward = recorded
    try:
        yield margins
    finally:
        moe.moe_forward = orig


#: the reference trainer's loss as one jitted function for the whole
#: session, so its trace cache outlives each program that calls it
_JIT_LOSS = jax.jit(jft._loss, static_argnums=0)


@contextlib.contextmanager
def shared_loss_trace():
    """While active, ``repro.distributed.fed_trainer`` computes its loss
    through :data:`_JIT_LOSS`: every federated step program traced under
    it (any aggregator, attack or trainer) reuses one trace of the
    model's loss, forward and gradient, per shape, instead of tracing the
    model again. XLA inlines the inner program, so the steps' results are
    the same bits (checked on the tree and flat steps with every attack
    when this was added)."""
    orig = jft._loss
    jft._loss = _JIT_LOSS
    try:
        yield
    finally:
        jft._loss = orig


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


#: jitted draw programs of :func:`replay_step_noise`, by their shape, so
#: the rows of a lane group (one config, several seeds) share one
_STEP_DRAWS: dict = {}


def _step_draws(env, K, M, d, noisy, bucketed, kappa, per_receiver):
    key = (id(env), K, M, d, noisy, bucketed, kappa, per_receiver)
    if key in _STEP_DRAWS:
        return _STEP_DRAWS[key][1]

    @jax.jit
    def draws(step_key):
        k_traj, k_att, k_agg, k_agr = jax.random.split(step_key, 4)
        s0, gumbel = jax.vmap(lambda k: trajectory_draws(env, k, M))(
            jax.random.split(k_traj, K))
        attack = agree = perm = None
        if noisy:
            attack = jax.random.normal(k_att, (K, d))
            agree = agreement_draws(k_agr, kappa, K, d, per_receiver)
        if bucketed:
            perm = bucket_perms(k_agg, K)
        return s0, gumbel, attack, agree, perm

    # the env is kept alive with its program, so its id is not reused
    _STEP_DRAWS[key] = (env, draws)
    return draws


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
    draws = _step_draws(env, K, M, d, noisy, bucketed, cfg.kappa,
                        cfg.per_receiver)

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


_BYZPG_DRAWS: dict = {}


def _byzpg_draws(env, K, M, d, noisy, bucketed):
    key = (id(env), K, M, d, noisy, bucketed)
    if key in _BYZPG_DRAWS:
        return _BYZPG_DRAWS[key][1]

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

    _BYZPG_DRAWS[key] = (env, draws)
    return draws


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
    draws = _byzpg_draws(env, K, M, d, noisy, bucketed)

    out = []
    for t in range(T):
        coin = engine.page_coin(ks.coin, t, cfg.switch_p)
        s0, gumbel, attack, perm = draws(step_keys[t])
        out.append(StepNoise(
            torch.as_tensor(bool(coin)), to_torch(s0), to_torch(gumbel),
            None if attack is None else to_torch(attack), None,
            None if perm is None else to_torch(perm).long()))
    return out


def fed_tree_normals(key, tree, byz_mask) -> torch.Tensor:
    """What the reference's ``large_noise`` fed attack draws from ``key``
    on a stacked tree (a bare (K, D) array is one leaf): ``split(key,
    n_leaves)``, one normal of each leaf's shape, of which the port takes
    the Byzantine rows, raveled and concatenated in leaf order: (n_byz,
    D)."""
    mask = np.asarray(byz_mask)
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    rows = [np.asarray(jax.random.normal(k, leaf.shape, leaf.dtype))[mask]
            .reshape(int(mask.sum()), -1) for k, leaf in zip(keys, leaves)]
    return torch.from_numpy(np.concatenate(rows, axis=1))


def replay_fed_noise(key, stacks, byz_mask, fed, flat: bool) -> FedNoise:
    """The :class:`FedNoise` of one reference federated step keyed by
    ``key`` (``k_att, k_agg = split(key)``): the attack's normals when it
    is ``large_noise``, and on the flat trainer with a bucketing registry
    aggregator the permutation ``permutation(split(k_agg)[0], K)``.
    ``stacks`` is the tree (or flat stack) the attack sees."""
    K = len(np.asarray(byz_mask))
    k_att, k_agg = jax.random.split(key)
    attack = perm = None
    if K > 1 and fed.attack.name == "large_noise":
        attack = fed_tree_normals(k_att, stacks, byz_mask)
    if K > 1 and flat and torch_resolve(
            "aggregator", str(fed.aggregator), K=K,
            n_byz=fed.n_byz).bucket_size:
        perm = to_torch(jax.random.permutation(
            jax.random.split(k_agg)[0], K))[None].long()
    return FedNoise(attack, perm)


# ---------------------------------------------------------------------------
# Greedy streams against the reference (the margin rule)
# ---------------------------------------------------------------------------

#: the two packages' f32 logits sum in other orders and differ by up to
#: this much; a greedy token whose top-1 margin is smaller may flip
STREAM_LOGIT_TOL = 2e-5


_J_PREFILL = jax.jit(jm.prefill, static_argnums=0,
                     static_argnames=("cache_len", "last_only"))
_J_DECODE = jax.jit(jm.decode_step, static_argnums=0)


def reference_margins(cfg, params, req, n_logits, bucket=None):
    """The reference's unbatched greedy stream for ``req`` and each
    token's top-1 margin over the runner-up. With ``bucket``, the prompt
    is right-padded to it as the engines pad it (the first token read at
    the true last position, the padded ring entries emptied): an MoE
    model routes pad tokens too, and the capacity follows the bucket."""
    toks = req.tokens if req.tokens is not None else np.zeros(1, np.int32)
    pe = None
    if cfg.frontend != "none":
        pe = np.zeros((1, cfg.n_prefix_embeds, cfg.d_model), np.float32)
        if req.obs is not None:
            pe[0, 0, :req.obs.shape[0]] = req.obs
        pe = jnp.asarray(pe)
    if bucket is None:
        W = cfg.n_prefix_embeds + len(toks) + req.max_new
        logits, cache = _J_PREFILL(cfg, params, jnp.asarray(toks[None]), pe,
                                  cache_len=W)
        row = logits[0, -1]
    else:
        true_len = cfg.n_prefix_embeds + len(toks)
        W = cfg.n_prefix_embeds + bucket + req.max_new
        padded = np.pad(toks, (0, bucket - len(toks)))[None]
        logits, cache = _J_PREFILL(cfg, params, jnp.asarray(padded), pe,
                                  cache_len=W, last_only=False)
        row = logits[0, true_len - 1]
        sp = cache["slot_pos"]
        cache = dict(cache, pos=jnp.asarray(true_len, jnp.int32),
                     slot_pos=jnp.where(sp < true_len, sp, -1))
    out, margins = [], []
    for i in range(req.max_new):
        top = np.sort(np.asarray(row[:n_logits]))[::-1]
        margins.append(float(top[0] - top[1]))
        tok = jnp.argmax(row[:n_logits])
        out.append(int(tok))
        if i + 1 < req.max_new:
            logits, cache = _J_DECODE(cfg, params, tok[None], cache)
            row = logits[0, 0]
    return out, margins


def assert_streams_agree(mine, ref, cfg, jparams, traffic, n_logits,
                         bucket_for=None):
    compared = 0
    for req in traffic:
        want, margins = reference_margins(
            cfg, jparams, req, n_logits,
            None if bucket_for is None else bucket_for(len(req.tokens)))
        assert ref[req.uid] == want            # the reference's engine
        n = next((i for i, m in enumerate(margins) if m <= STREAM_LOGIT_TOL),
                 len(margins))
        assert len(mine[req.uid]) == len(want)
        assert mine[req.uid][:n] == want[:n]
        compared += n
    assert compared >= len(traffic)            # the rule left work to do
