"""The transformer policy trained by the port's DecByzPG and ByzPG, against
the JAX package on the CPU: the flat θ layout, the policy's size and
specs, the one-step gradient, which attention route each phase takes,
and whole runs under the reference's replayed draws (``torch_parity``).

Tolerances: the gradient is an f32 sum over M·H log-probabilities taken
in other orders on the two sides, so it agrees to 1e-5 of max|g|. θ after
T Adam steps agrees to 1e-5 (``_assert_theta_close`` says why Adam could
widen that, and what is checked exactly)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.core import byzpg as jbz  # noqa: E402
from repro.core import decbyzpg as jdb  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.rl import gradient as jgrad  # noqa: E402
from repro.rl.envs import make_cartpole as jax_cartpole  # noqa: E402
from repro.rl.policy import policy_unraveler  # noqa: E402
from repro.rl.policy import resolve_policy as jresolve_policy  # noqa: E402
from repro.rl.rollout import Trajectory as JTrajectory  # noqa: E402

from repro_torch.convert import (model_params_from_jax,  # noqa: E402
                                 theta_from_jax_tree)
from repro_torch.core import byzpg as tbz  # noqa: E402
from repro_torch.core import decbyzpg as tdb  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.noise import draw_step_noise  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.rl import gradient as tgrad  # noqa: E402
from repro_torch.rl.envs import make_cartpole  # noqa: E402
from repro_torch.rl.policy import resolve_policy  # noqa: E402
from repro_torch.rl.rollout import rollout  # noqa: E402
from repro_torch.sweep import SweepRunner  # noqa: E402

from torch_parity import replay_byzpg_noise, replay_step_noise  # noqa: E402

torch.set_num_threads(2)

#: the reference's own tiny transformer policy (tests/test_policy.py)
TINY_TF = ("transformer(arch='qwen2.5-3b', d_model=32, n_layers=1, "
           "n_heads=2, d_ff=64)")
#: every transformer spec string the reference's code and tests use
SPECS = ["transformer", "transformer(arch='qwen2.5-3b')", TINY_TF,
         "transformer(arch='llama3.2-1b', n_layers=2, d_model=64, "
         "n_heads=2)",
         "transformer(arch='qwen2.5-3b', n_layers=2, d_model=64, n_heads=2)",
         "transformer(arch='qwen2.5-3b', n_layers=1, remat=True)"]
H = 10
JENV, ENV = jax_cartpole(horizon=H), make_cartpole(horizon=H)
T = 2
#: the reference's end-to-end transformer test (tests/test_policy.py)
DEC_KW = dict(K=3, n_byz=1, attack="large_noise(sigma=10)",
              aggregator="rfa", agreement="gda", kappa=1, N=3, B=2,
              policy=TINY_TF)
BYZ_KW = dict(K=3, n_byz=1, attack="large_noise(sigma=10)",
              aggregator="rfa", N=3, B=2, policy=TINY_TF)
#: share of max|g| within which the gradients agree
GRAD_RTOL = 1e-5


def _policies(spec=TINY_TF):
    cfg = tdb.DecByzPGConfig(policy=spec)
    return (jresolve_policy(jdb.DecByzPGConfig(policy=spec), JENV),
            resolve_policy(cfg, ENV))


def test_ravel_tree_matches_ravel_pytree():
    jpol, tpol = _policies()
    params = jpol.init(jax.random.PRNGKey(3))
    vec, _ = ravel_pytree(params)
    numpy_tree = jax.tree.map(np.asarray, params)
    theta = theta_from_jax_tree(numpy_tree, device="cpu")
    np.testing.assert_array_equal(theta.numpy(), np.asarray(vec))
    # layers() is the inverse: views of θ equal to the carried-over tree
    layers = tpol.layers(theta)
    carried = model_params_from_jax(numpy_tree, tpol.model_cfg, device="cpu")
    assert [p for p, _ in tree.tree_paths(layers)] == \
        [p for p, _ in tree.tree_paths(carried)]
    for (_, a), (_, b) in zip(tree.tree_paths(layers),
                              tree.tree_paths(carried)):
        assert torch.equal(a, b)
    assert torch.equal(tree.ravel_tree(layers), theta)
    # the flat init draws the serving init's parameters, raveled
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    assert torch.equal(tpol.init_theta(g1), tree.ravel_tree(tpol.init(g2)))


@pytest.mark.parametrize("spec", SPECS)
def test_every_reference_spec_resolves_with_the_reference_size(spec):
    jpol, tpol = _policies(spec)
    assert tpol.d == policy_unraveler(jpol)[1]
    assert dataclasses.asdict(tpol.model_cfg) == \
        dataclasses.asdict(jpol.model_cfg)
    assert tpol.remat == ("remat=True" in spec)


def test_small_model_raises_the_reference_error():
    spec = "transformer(arch='qwen2.5-3b', d_model=2, n_heads=2)"
    with pytest.raises(ValueError, match="d_model") as ours:
        resolve_policy(tdb.DecByzPGConfig(policy=spec), ENV)
    with pytest.raises(ValueError, match="d_model") as ref:
        jresolve_policy(jdb.DecByzPGConfig(policy=spec), JENV)
    assert str(ours.value) == str(ref.value)


def _trajectories(tpol, theta, seed=0):
    cfg = tdb.DecByzPGConfig(**dict(DEC_KW, K=theta.shape[0]))
    gen = torch.Generator()
    gen.manual_seed(seed)
    nz = draw_step_noise(gen, cfg, ENV, tpol.d, 0)
    return rollout(ENV, tpol, theta, nz.s0, nz.gumbel)


def test_grad_estimate_matches_jax_grad():
    """The one-step GPOMDP estimate on the same trajectories against
    ``jax.grad`` of the reference surrogate, each agent within 1e-5 of
    max|g|; embedding rows that no token reads get exactly zero on both
    sides."""
    jpol, tpol = _policies()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jparams = [jpol.init(k) for k in keys]
    theta = torch.stack([theta_from_jax_tree(
        jax.tree.map(np.asarray, p), device="cpu") for p in jparams])
    traj = _trajectories(tpol, theta)
    M = traj.obs.shape[1]
    w = np.where(np.arange(M) < DEC_KW["N"], 1.0 / DEC_KW["N"], 0.0)
    got = tgrad.grad_estimate(tpol, theta, traj, 0.999,
                              sample_weights=torch.tensor(w,
                                                          dtype=torch.float32))
    j_grad = jax.jit(lambda p, t, sw: ravel_pytree(jgrad.grad_estimate(
        p, t, 0.999, 0.0, "gpomdp", jpol.logits, sample_weights=sw))[0])
    for k in range(theta.shape[0]):
        jt = JTrajectory(*(jnp.asarray(x[k].numpy()) for x in traj))
        want = np.asarray(j_grad(jparams[k], jt,
                                 jnp.asarray(w, jnp.float32)))
        err = np.abs(got[k].numpy() - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (k, err)
        np.testing.assert_array_equal(got[k].numpy() == 0, want == 0)
        assert (want == 0).sum() > 0       # the unread embedding rows


def test_rollouts_take_the_flash_route_and_gradients_the_chunked(
        monkeypatch):
    """The routes on the CPU, counted per call of each op: every pass the
    algorithms make (rollout, gradient, importance weights) takes the
    chunked route, one call per layer per agent and pass, and none calls
    the flash op; serving's ``logits`` keeps flash."""
    calls = {"flash": 0, "chunked": 0}
    flash, chunked = tattn.flash_attention, tattn.chunked_causal_attention

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tattn, "flash_attention", count("flash", flash))
    monkeypatch.setattr(tattn, "chunked_causal_attention",
                        count("chunked", chunked))
    _, tpol = _policies()
    K, L = 3, tpol.model_cfg.n_layers
    gen = torch.Generator()
    gen.manual_seed(1)
    theta = torch.stack([tpol.init_theta(gen) for _ in range(K)])
    traj = _trajectories(tpol, theta)
    assert calls == {"flash": 0, "chunked": H * K * L}
    tgrad.grad_estimate(tpol, theta, traj, 0.999)
    assert calls == {"flash": 0, "chunked": (H + 1) * K * L}
    tgrad.weighted_grad_estimate(tpol, theta, theta.flip(0), traj, 0.999)
    assert calls == {"flash": 0, "chunked": (H + 4) * K * L}
    tpol.logits(tpol.layers(theta[0]), traj.obs[0, :, 0])
    assert calls == {"flash": L, "chunked": (H + 4) * K * L}


def _jax_run(algo, kw):
    """The reference's fused loop under ``pallas-interpret`` (RFA in Gram
    space, as the port's), and its θ₀."""
    mod = jdb if algo == "decbyzpg" else jbz
    cfg = (mod.DecByzPGConfig if algo == "decbyzpg" else mod.ByzPGConfig)(
        **kw)
    ks = jeng.seed_keys(cfg.seed)
    if algo == "decbyzpg":
        carry = mod.init_decbyzpg_carry(JENV, cfg, ks.init)
        build = mod.build_decbyzpg_loop
    else:
        carry = mod.init_byzpg_carry(JENV, cfg, ks.init)
        build = mod.build_byzpg_loop
    theta0 = np.array(carry[0][0] if algo == "decbyzpg" else carry[0])
    with jdispatch.use_backend("pallas-interpret"):
        loop = jax.jit(build(JENV, cfg, T))
        hist = loop(*carry, jax.random.split(ks.loop, T), ks.coin)
    return cfg, jax.device_get(hist), theta0


def _assert_theta_close(got, want, theta0):
    """θ after T steps of per-agent Adam, within 1e-5 (measured: 3.6e-7 at
    most). Adam divides each coordinate's step by the root of its own
    second moment, so a coordinate whose aggregated direction sat at
    rounding level would move by up to η a step whichever way either side
    rounded it; none does in these runs, and every coordinate that stays
    at θ₀ in one package stays there in the other."""
    np.testing.assert_allclose(got, want, atol=1e-5)
    theta0 = np.broadcast_to(theta0, got.shape)
    np.testing.assert_array_equal(got == theta0, want == theta0)


def test_run_decbyzpg_matches_the_reference():
    jcfg, hist, theta0 = _jax_run("decbyzpg", DEC_KW)
    noise = replay_step_noise(JENV, jcfg, theta0.shape[0], T)
    cfg = tdb.DecByzPGConfig(**DEC_KW)
    out = tdb.run_decbyzpg(ENV, cfg, T, device="cpu", theta0=theta0,
                           noise=noise)
    np.testing.assert_array_equal(out["coins"], np.asarray(hist["coins"]))
    np.testing.assert_allclose(out["returns"], hist["returns"], rtol=1e-5)
    _assert_theta_close(out["theta"].numpy(), hist["theta"], theta0)
    np.testing.assert_allclose(out["diameter"], hist["diameter"], atol=1e-5)
    again = tdb.run_decbyzpg(ENV, cfg, T, device="cpu", theta0=theta0,
                             noise=noise)
    assert torch.equal(again["theta"], out["theta"])
    np.testing.assert_array_equal(again["diameter"], out["diameter"])
    params = out["params"]
    assert set(params) == set(resolve_policy(cfg, ENV).shapes)
    assert torch.equal(tree.ravel_tree(params), out["theta"][cfg.n_byz])


def test_run_byzpg_matches_the_reference():
    jcfg, hist, theta0 = _jax_run("byzpg", BYZ_KW)
    noise = replay_byzpg_noise(JENV, jcfg, theta0.shape[0], T)
    cfg = tbz.ByzPGConfig(**BYZ_KW)
    out = tbz.run_byzpg(ENV, cfg, T, device="cpu", theta0=theta0,
                        noise=noise)
    np.testing.assert_array_equal(out["coins"], np.asarray(hist["coins"]))
    np.testing.assert_allclose(out["returns"], hist["returns"], rtol=1e-5)
    _assert_theta_close(out["vec"].numpy(), hist["vec"], theta0)
    again = tbz.run_byzpg(ENV, cfg, T, device="cpu", theta0=theta0,
                          noise=noise)
    assert torch.equal(again["vec"], out["vec"])
    assert torch.equal(tree.ravel_tree(out["params"]), out["vec"])


def test_run_grid_and_sweep_take_the_transformer_spec():
    """``run_grid`` over ``policy`` {mlp, the tiny transformer} equals the
    single runs bit for bit, and so does a 2-window sweep."""
    base = {k: v for k, v in DEC_KW.items() if k != "policy"}
    base["hidden"] = (8,)
    axes = {"policy": ("mlp", TINY_TF)}
    seeds = (0, 1)
    grid = teng.ScenarioGrid(seeds=seeds, axes=axes)
    res = teng.run_grid(ENV, grid, T, algo="decbyzpg", device="cpu", **base)
    assert len(res) == 2
    for scn, out in res.items():
        cfg = tdb.DecByzPGConfig(**base, **scn._asdict())
        for i, s in enumerate(seeds):
            single = tdb.run_decbyzpg(ENV, dataclasses.replace(cfg, seed=s),
                                      T, device="cpu")
            np.testing.assert_array_equal(out["returns"][i],
                                          single["returns"])
            np.testing.assert_array_equal(out["diameter"][i],
                                          single["diameter"])
            np.testing.assert_array_equal(out["theta"][i],
                                          single["theta"].numpy())
        assert out["theta"].shape[-1] == resolve_policy(cfg, ENV).d
    swept = SweepRunner(algo="decbyzpg", env=f"cartpole(horizon={H})", T=T,
                        seeds=seeds, axes=axes, windows=2, device="cpu",
                        **base).run()
    for scn, want in res.items():
        got = swept[tuple(scn)]
        for k in ("returns", "samples", "diameter", "theta"):
            np.testing.assert_array_equal(got[k], want[k])
