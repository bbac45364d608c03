"""The port's RL substrate against the JAX package's: environment steps,
MLP logits from carried weights, rollouts fed the reference's own draws,
and the policy-gradient estimators."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.rl import envs as jenvs  # noqa: E402
from repro.rl import gradient as jgrad  # noqa: E402
from repro.rl import policy as jpolicy  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.core.tree import ravel  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.rl import envs as tenvs  # noqa: E402
from repro_torch.rl import gradient as tgrad  # noqa: E402
from repro_torch.rl.policy import MLPPolicy  # noqa: E402
from repro_torch.rl.rollout import (  # noqa: E402
    Trajectory, batch_return, rollout)

from torch_parity import to_torch, trajectory_draws  # noqa: E402

torch.set_num_threads(2)

ENVS = {"cartpole": (jenvs.make_cartpole, tenvs.make_cartpole),
        "lunarlander": (jenvs.make_lunarlander, tenvs.make_lunarlander)}

# the reference's functions, jitted so each configuration compiles once
# instead of dispatching op by op
_sample_batch = jax.jit(jrollout.sample_batch, static_argnums=(0, 3, 4))
_grad = jax.jit(jgrad.grad_estimate, static_argnums=(2, 3, 4, 5))
_weighted_grad = jax.jit(jgrad.weighted_grad_estimate,
                         static_argnums=(3, 4, 5, 6, 8))


def _states(name, n, rng):
    if name == "cartpole":
        return (rng.uniform(-1, 1, (n, 4)) * [2.5, 2, 0.25, 2]).astype(
            np.float32)
    s = rng.uniform(-1, 1, (n, 6)) * [1.6, 0.8, 1, 1, 0.5, 1]
    s[:, 1] += 0.8
    return s.astype(np.float32)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_step_matches_jax(name):
    jenv, tenv = ENVS[name][0](horizon=10), ENVS[name][1](horizon=10)
    rng = np.random.default_rng(0)
    s = _states(name, 512, rng)
    a = rng.integers(0, jenv.n_actions, 512).astype(np.int32)
    js2, jr, jdone = jax.vmap(jenv.step)(jnp.asarray(s), jnp.asarray(a))
    ts2, tr, tdone = tenv.step(torch.from_numpy(s), torch.from_numpy(a))
    # the same f32 operations in the same order; sin/cos may differ by ulps
    np.testing.assert_allclose(ts2.numpy(), js2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.broadcast_to(jr, (512,)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert 0 < tdone.numpy().sum() < 512          # both outcomes covered
    assert (tenv.obs_dim, tenv.n_actions, tenv.horizon) == \
        (jenv.obs_dim, jenv.n_actions, jenv.horizon)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_reset_ranges(name):
    tenv = ENVS[name][1]()
    gen = torch.Generator().manual_seed(0)
    s = tenv.reset(gen, (3, 5))
    assert s.shape == (3, 5, tenv.obs_dim)
    if name == "cartpole":
        assert s.abs().max() <= 0.05
    else:
        assert (s[..., 1] == 1.4).all() and s[..., [0, 2]].abs().max() <= 0.3
        assert (s[..., 3:] == 0).all()


def _jax_params(key, sizes):
    return jpolicy.init_mlp(key, sizes)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_mlp_logits_from_carried_weights(activation):
    sizes = (6, 16, 16, 4)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    params = [_jax_params(k, sizes) for k in keys]
    theta = torch.stack([convert.theta_from_jax_params(
        jax.device_get(p), device="cpu") for p in params])
    for p, row in zip(params, theta):
        np.testing.assert_array_equal(row.numpy(), ravel(p)[0])
    obs = np.random.default_rng(2).standard_normal((3, 7, 6)).astype(
        np.float32)
    pol = MLPPolicy(sizes, activation)
    assert pol.d == theta.shape[1]
    got = pol(theta, torch.from_numpy(obs)).numpy()
    for k in range(3):
        want = jpolicy.mlp_logits(params[k], jnp.asarray(obs[k]), activation)
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6)


def test_mlp_init_layout():
    pol = MLPPolicy((4, 16, 16, 2), "relu")
    assert pol.d == 386                      # the paper's CartPole policy
    vec = pol.init_theta(torch.Generator().manual_seed(0))
    layers = pol.layers(vec)
    assert [tuple(l["w"].shape) for l in layers] == [(4, 16), (16, 16),
                                                    (16, 2)]
    assert all((l["b"] == 0).all() for l in layers)
    assert abs(float(layers[0]["w"].std()) - 0.5) < 0.15     # din^-1/2


@functools.lru_cache(maxsize=None)
def _sampled(name, activation="relu", M=6, K=2, horizon=40):
    """K agents' batches sampled by the reference, plus the port's rollout
    of the same draws (shared by the tests, which only read them)."""
    jenv, tenv = ENVS[name][0](horizon=horizon), ENVS[name][1](horizon=horizon)
    sizes = (jenv.obs_dim, 8, jenv.n_actions)
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * K)
    params = [_jax_params(keys[k], sizes) for k in range(K)]
    scales = [1.0] * (K - 1) + [0.0]        # the last agent acts at random
    jtraj = [_sample_batch(jenv, params[k], keys[K + k], M, activation,
                           scales[k])
             for k in range(K)]
    draws = [trajectory_draws(jenv, keys[K + k], M) for k in range(K)]
    theta = torch.stack([convert.theta_from_jax_params(jax.device_get(p),
                                                       device="cpu")
                         for p in params])
    pol = MLPPolicy(sizes, activation)
    ttraj = rollout(tenv, pol, theta,
                    torch.stack([to_torch(d[0]) for d in draws]),
                    torch.stack([to_torch(d[1]) for d in draws]),
                    torch.tensor(scales))
    return jenv, params, jtraj, pol, theta, ttraj


@pytest.mark.parametrize("name", sorted(ENVS))
def test_rollout_matches_sample_batch(name):
    _, _, jtraj, _, _, ttraj = _sampled(name)
    for k, jt in enumerate(jtraj):
        np.testing.assert_array_equal(ttraj.actions[k].numpy(), jt.actions)
        np.testing.assert_array_equal(ttraj.mask[k].numpy(), jt.mask)
        np.testing.assert_allclose(ttraj.obs[k].numpy(), jt.obs, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ttraj.rewards[k].numpy(), jt.rewards,
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(batch_return(ttraj)[k].numpy(),
                                   jrollout.batch_return(jt), rtol=1e-5,
                                   atol=1e-3)
    assert (ttraj.mask[..., -1] == 0).any()   # some episodes terminate


def _trajectory_of(jt_list) -> Trajectory:
    return Trajectory(*(torch.stack([to_torch(getattr(jt, f))
                                     for jt in jt_list])
                        for f in Trajectory._fields))


@pytest.mark.parametrize("estimator", ["gpomdp", "reinforce"])
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_estimate_matches_jax(estimator, weighted):
    jenv, params, jtraj, pol, theta, _ = _sampled("cartpole", "tanh")
    traj = _trajectory_of(jtraj)
    M = traj.actions.shape[1]
    sw = np.where(np.arange(M) < 4, 0.25, 0.0).astype(np.float32) \
        if weighted else None
    got = tgrad.grad_estimate(pol, theta, traj, 0.99, 0.5, estimator,
                              None if sw is None else torch.from_numpy(sw))
    for k, jt in enumerate(jtraj):
        want = ravel(_grad(params[k], jt, 0.99, 0.5, estimator, "tanh",
                           None if sw is None else jnp.asarray(sw)))[0]
        # sums over M·H terms in another order
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got[k].numpy(), want, atol=2e-5 * scale)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("self_normalized", [False, True])
def test_weighted_grad_estimate_matches_jax(weighted, self_normalized):
    jenv, params, jtraj, pol, theta, _ = _sampled("cartpole", "relu")
    traj = _trajectory_of(jtraj)
    M = traj.actions.shape[1]
    # θ_old: a perturbed copy, so the importance weights are not all 1
    noise = np.random.default_rng(4).standard_normal(theta.shape).astype(
        np.float32)
    theta_old = theta + 0.3 * torch.from_numpy(noise)
    sw = np.where(np.arange(M) < 4, 0.25, 0.0).astype(np.float32) \
        if weighted else None
    got = tgrad.weighted_grad_estimate(
        pol, theta_old, theta, traj, 0.999, 0.0, "gpomdp",
        None if sw is None else torch.from_numpy(sw), self_normalized)
    w = tgrad.importance_weights(pol, theta_old, theta, traj)
    assert (w <= 10 + 1e-5).all() and (w >= 0.1 - 1e-6).all()
    for k, jt in enumerate(jtraj):
        p_old = pol.layers(theta_old[k])
        jold = [{"w": jnp.asarray(l["w"].numpy()),
                 "b": jnp.asarray(l["b"].numpy())} for l in p_old]
        want_w = jgrad.importance_weights(jold, params[k], jt, "relu")
        np.testing.assert_allclose(w[k].numpy(), want_w, rtol=1e-4)
        want = ravel(_weighted_grad(
            jold, params[k], jt, 0.999, 0.0, "gpomdp", "relu",
            None if sw is None else jnp.asarray(sw), self_normalized))[0]
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-4 * scale)
