"""ByzPG (paper Algorithm 1): the port's ``run_byzpg`` against the JAX
package's fused loop, fed the reference's own θ₀ and draws (replayed from
its key tree), plus the generic PAGE estimator and the port's boundaries
(seeded determinism, no implicit CPU)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import byzpg as jbz  # noqa: E402
from repro.core import engine  # noqa: E402
from repro.core import page as jpage  # noqa: E402
from repro.kernels import dispatch  # noqa: E402
from repro.rl.envs import make_cartpole as jax_cartpole  # noqa: E402

from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import byzpg as tbz  # noqa: E402
from repro_torch.core import page as tpage  # noqa: E402
from repro_torch.core.registry import resolve  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels.krum_score import krum_scores  # noqa: E402
from repro_torch.rl.envs import make_cartpole, make_env  # noqa: E402

from torch_parity import replay_byzpg_noise  # noqa: E402

torch.set_num_threads(2)

T = 5
BASE = dict(K=6, n_byz=1, N=4, B=2, eta=1e-2, hidden=(8,), seed=3)
# K=7, n_byz=1: Lemma-3 buckets of int(0.5 / (1/7)) = 3, so the server
# draws one permutation a step; Krum at K=6, n_byz=1 has buckets of
# int(0.25 / (1/6)) = 1 (no bucketing, n_near = 3)
CONFIGS = {
    "rfa_bucketed_large_noise": dict(BASE, K=7,
                                     attack="large_noise(sigma=10)"),
    "krum": dict(BASE, aggregator="krum", attack="large_noise(sigma=10)"),
    "trimmed_mean_sign_flip": dict(BASE, aggregator="trimmed_mean",
                                   attack="sign_flip"),
    "mean_random_action": dict(BASE, aggregator="mean",
                               attack="random_action"),
}
#: Krum's scores agree with the reference's to this share of the largest
SCORE_RTOL = 1e-5


def _jax_run(env, cfg, T):
    """The reference's fused loop, traced under ``pallas-interpret`` so its
    RFA runs in Gram space as the port's does (jitted here: ``fused_byzpg``
    caches by a key that ignores the backend)."""
    ks = engine.seed_keys(cfg.seed)
    carry = jbz.init_byzpg_carry(env, cfg, ks.init)
    theta0 = np.array(carry[0])
    with dispatch.use_backend("pallas-interpret"):
        loop = jax.jit(jbz.build_byzpg_loop(env, cfg, T))
        hist = loop(*carry, jax.random.split(ks.loop, T), ks.coin)
    return jax.device_get(hist), theta0


def run_both(kw, T=T):
    """(reference history, port output) for one configuration under the
    reference's draws and θ₀."""
    jenv = jax_cartpole(horizon=32)
    jcfg = jbz.ByzPGConfig(**kw)
    hist, theta0 = _jax_run(jenv, jcfg, T)
    noise = replay_byzpg_noise(jenv, jcfg, theta0.shape[0], T)
    out = tbz.run_byzpg(make_cartpole(horizon=32), tbz.ByzPGConfig(**kw), T,
                        device="cpu", theta0=theta0, noise=noise)
    return hist, out


@pytest.mark.parametrize("kw", list(CONFIGS.values()), ids=list(CONFIGS))
def test_run_byzpg_matches_jax(kw, monkeypatch):
    scores = []

    def recording_scores(x, n_near):
        scores.append(krum_scores(x, n_near))
        return scores[-1]

    monkeypatch.setattr(tagg, "krum_scores", recording_scores)
    hist, out = run_both(kw)
    # the server aggregates on every step (the coin selects the result);
    # Krum's argmin is discontinuous, so each step's winner must beat the
    # runner-up by more than the scores' tolerance
    assert len(scores) == (T if kw.get("aggregator") == "krum" else 0)
    for s in scores:
        top = torch.sort(s, dim=1).values
        assert (top[:, 1] - top[:, 0]).min() > SCORE_RTOL * top.abs().max()
    assert hist["coins"][0] and not hist["coins"].all() and \
        hist["coins"].any()
    np.testing.assert_array_equal(out["coins"], hist["coins"])
    np.testing.assert_allclose(out["returns"], hist["returns"], rtol=1e-5)
    np.testing.assert_allclose(out["vec"].numpy(), hist["vec"], atol=1e-5)
    assert out["samples"].tolist() == np.cumsum(
        np.where(hist["coins"], kw["N"], kw["B"])).tolist()
    layers = out["params"]
    assert [sorted(p) for p in layers] == [["b", "w"], ["b", "w"]]
    assert torch.equal(torch.cat([layers[0]["b"], layers[0]["w"].reshape(-1),
                                  layers[1]["b"], layers[1]["w"].reshape(-1)]),
                       out["vec"])


def test_config_fields_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(tbz.ByzPGConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jbz.ByzPGConfig)}
    assert ours == ref
    assert list(ours) == list(ref)
    assert tbz.ByzPGConfig(N=20, B=4).switch_p == 0.2
    assert str(tbz.ByzPGConfig(attack="large_noise(sigma=10)").attack) \
        == "large_noise(sigma=10)"


def test_seeded_run_is_deterministic_and_starts_with_coin():
    cfg = tbz.ByzPGConfig(K=4, n_byz=1, attack="large_noise(sigma=10)",
                          N=3, B=2, hidden=(4,))
    env = make_cartpole(horizon=8)
    a = tbz.run_byzpg(env, cfg, 3, device="cpu")
    b = tbz.run_byzpg(env, cfg, 3, device="cpu")
    assert a["coins"][0]
    np.testing.assert_array_equal(a["returns"], b["returns"])
    np.testing.assert_array_equal(a["coins"], b["coins"])
    assert torch.equal(a["vec"], b["vec"])
    assert [p["w"].shape for p in a["params"]] == [(4, 4), (4, 2)]
    c = tbz.run_byzpg(env, dataclasses.replace(cfg, seed=1), 3,
                      device="cpu")
    assert not torch.equal(a["vec"], c["vec"])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = make_cartpole(horizon=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbz.run_byzpg(env, tbz.ByzPGConfig(K=2, N=2, B=1), 1)


def test_byzpg_noise_shapes():
    """One permutation a step (the server aggregates once), no agreement
    draws, attack normals only for an attack that draws noise."""
    from repro_torch.core.noise import draw_byzpg_noise
    env = make_cartpole(horizon=5)
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = tbz.ByzPGConfig(K=7, n_byz=1, attack="large_noise", N=3, B=2)
    nz = draw_byzpg_noise(gen, cfg, env, 11, 0)
    assert bool(nz.coin) and nz.agree_attack is None
    assert tuple(nz.s0.shape) == (7, 3, 4)
    assert tuple(nz.gumbel.shape) == (7, 3, 5, 2)
    assert tuple(nz.attack.shape) == (7, 11)
    assert tuple(nz.perm.shape) == (1, 7)
    assert sorted(nz.perm[0].tolist()) == list(range(7))
    plain = draw_byzpg_noise(gen, dataclasses.replace(
        cfg, attack="none", aggregator="mean"), env, 11, 1)
    assert plain.attack is None and plain.perm is None


def test_make_env_resolves_specs_like_the_reference():
    from repro.rl.envs import make_env as jax_make_env
    for spec in ("cartpole", "cartpole(horizon=100)", "lunarlander"):
        ours, ref = make_env(spec), jax_make_env(spec)
        assert (ours.name, ours.obs_dim, ours.n_actions, ours.horizon) == \
            (ref.name, ref.obs_dim, ref.n_actions, ref.horizon)
    assert make_env("cartpole", horizon=7).horizon == 7
    env = make_cartpole(horizon=3)
    assert make_env(env) is env
    with pytest.raises(TypeError, match="already-built"):
        make_env(env, horizon=4)
    assert resolve("algo", "byzpg").config_cls is tbz.ByzPGConfig


@pytest.mark.parametrize("use_large", [True, False])
def test_page_direction_matches_reference(use_large):
    """PAGE over pytrees with a closed-form gradient: grad of
    ½‖A w − y‖² over a batch (A, y) is Aᵀ(A w − y), per leaf."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 3)).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32)
    p0 = {"w": rng.standard_normal(3).astype(np.float32),
          "layers": [rng.standard_normal((2, 3)).astype(np.float32)]}
    p1 = {"w": rng.standard_normal(3).astype(np.float32),
          "layers": [rng.standard_normal((2, 3)).astype(np.float32)]}

    def jgrad(params, batch):
        a, t = batch
        return jax.tree.map(lambda w: (w @ a.T - t) @ a, params)

    def tgrad(params, batch):
        a, t = batch
        return tree_map(lambda w: (w @ a.T - t) @ a, params)

    jb = (jnp.asarray(A), jnp.asarray(y))
    tb = (torch.from_numpy(A), torch.from_numpy(y))
    jp0, jp1 = (jax.tree.map(jnp.asarray, p) for p in (p0, p1))
    tp0, tp1 = (tree_map(torch.from_numpy, p) for p in (p0, p1))
    js = jpage.page_direction(jgrad, jp1, jpage.page_direction(
        jgrad, jp0, jpage.init_page(jp0), jb, True), jb, use_large)
    ts = tpage.page_direction(tgrad, tp1, tpage.page_direction(
        tgrad, tp0, tpage.init_page(tp0), tb, True), tb, use_large)
    assert ts.prev_params is tp1
    for want, got in zip(jax.tree.leaves(js.v), [ts.v["layers"][0],
                                                 ts.v["w"]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    zero = tpage.init_page(tp0)
    assert zero.prev_params is tp0
    assert torch.equal(zero.v["w"], torch.zeros(3))
