"""The port's core against the JAX package's: registry, attacks,
optimizers, aggregators (bucketing with the reference's permutations),
agreement and topologies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import agreement as jagree  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.core import attacks as jattacks  # noqa: E402
from repro.core.registry import REGISTRY as JREGISTRY  # noqa: E402
from repro.core.registry import Spec as JSpec  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.topology import resolve_topology as jax_topology  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import agreement as tagree  # noqa: E402
from repro_torch.core import attacks as tattacks  # noqa: E402
from repro_torch.core.registry import REGISTRY, Spec, resolve  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.topology import resolve_topology  # noqa: E402

from torch_parity import agreement_draws, bucket_perms, to_torch  # noqa: E402

torch.set_num_threads(2)

K, D = 7, 33
BYZ = np.arange(K) < 2


def _x(seed=0, shape=(K, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["krum", "rfa(n_iter=64, nu=1e-05)",
                                  "bucketing(s=2, inner=rfa(n_iter=64))",
                                  "ring(k=-4)", "mlp(hidden=(32,))"])
def test_spec_parses_as_reference(text):
    assert Spec.parse(text).canonical() == JSpec.parse(text).canonical()
    assert hash(Spec.of(text)) == hash(Spec.of(Spec.parse(text)))


def test_registered_names_are_the_reference_names():
    for ns in ("aggregator", "attack", "agreement", "estimator",
               "optimizer", "env", "topology", "policy"):
        ours = set(REGISTRY.names(ns))
        assert ours and ours <= set(JREGISTRY.names(ns)), ns
    # every robust aggregator and agreement rule of the reference is ported
    for ns in ("aggregator", "agreement"):
        assert REGISTRY.names(ns) == JREGISTRY.names(ns), ns
    with pytest.raises(KeyError, match="registered: .*krum"):
        resolve("aggregator", "bogus", K=5, n_byz=1)
    with pytest.raises(TypeError, match="unexpected"):
        resolve("aggregator", "rfa(bogus=1)", K=5, n_byz=1)


# ---------------------------------------------------------------------------
# Attacks
# ---------------------------------------------------------------------------

ATTACKS = ["none", "large_noise(sigma=10.0)", "avg_zero",
           "sign_flip(scale=2.0)", "alie", "random_action"]


@pytest.mark.parametrize("spec", ATTACKS)
def test_attacks_match_reference(spec):
    honest = _x(1)
    key = jax.random.PRNGKey(4)
    want = jattacks.get_attack(spec)(jnp.asarray(honest), jnp.asarray(BYZ),
                                     key)
    noise = to_torch(jax.random.normal(key, (K, D))) \
        if tattacks.draws_noise(spec) else None
    got = tattacks.get_attack(spec)(torch.from_numpy(honest),
                                    torch.from_numpy(BYZ), noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tattacks.is_env_level(spec) == jattacks.is_env_level(spec)
    assert tattacks.draws_noise(spec) == (spec.startswith("large_noise"))


def test_per_receiver_attack_matches_reference():
    honest = _x(2)
    key = jax.random.PRNGKey(5)
    att = jattacks.get_attack("large_noise", sigma=3.0)
    want = jattacks.per_receiver(att, K)(jnp.asarray(honest),
                                         jnp.asarray(BYZ), key)
    noise = to_torch(jax.vmap(lambda k: jax.random.normal(k, (K, D)))(
        jax.random.split(key, K)))
    got = tattacks.per_receiver(tattacks.get_attack("large_noise", sigma=3.0),
                                K)(torch.from_numpy(honest),
                                   torch.from_numpy(BYZ), noise)
    assert got.shape == (K, K, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["adam", "sgd", "sgd(momentum=0.9)",
                                  "adam(maximize=False)"])
def test_optimizers_match_reference(spec):
    jo, to = jopt.get_optimizer(spec, 5e-3), topt.get_optimizer(spec, 5e-3)
    params = _x(3)
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    js, ts = jax.vmap(jo.init)(jp), to.init(tp)
    for i in range(4):
        g = _x(10 + i)
        jp, js = jax.vmap(jo.update)(jnp.asarray(g), js, jp)
        tp, ts = to.update(torch.from_numpy(g), ts, tp)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-7)


def test_adam_continues_from_carried_state():
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    theta = jnp.asarray(_x(4))
    state = jax.vmap(jo.init)(theta)
    prev = theta
    for i in range(3):
        prev = theta
        theta, state = jax.vmap(jo.update)(jnp.asarray(_x(20 + i)), state,
                                           theta)
    carry = convert.carry_from_jax(theta, prev, jax.device_get(state),
                                   device="cpu")
    assert carry.opt_state.step.tolist() == [3] * K
    g = _x(30)
    want, _ = jax.vmap(jo.update)(jnp.asarray(g), state, theta)
    got, _ = to.update(torch.from_numpy(g), carry.opt_state, carry.theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(carry.theta_prev.numpy(), prev)


# ---------------------------------------------------------------------------
# Aggregators
# ---------------------------------------------------------------------------


def test_converters_default_to_cuda():
    """Without a device argument the converters place tensors on CUDA;
    without a card each raises resolve_device's own error."""
    if torch.cuda.is_available():
        pytest.skip("this checks the error without a CUDA device")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    cfg = reduced(get_config("llama3.2-1b"))
    x = _x(40)
    for call in (
            lambda: convert.theta_from_jax_params([{"w": x, "b": x[0]}]),
            lambda: convert.carry_from_jax(x, x, (np.zeros(K), x, x)),
            lambda: convert.model_params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,tol", [("mean", 1e-6), ("cwmed", 1e-6),
                                      ("centered_clip(tau=0.5)", 1e-5)])
def test_unbucketed_aggregators_match_reference(spec, tol):
    x = _x(5, (8, D))
    want = jagg.get_aggregator(spec, 8, 0)(jnp.asarray(x), None)
    got = resolve("aggregator", spec, K=8, n_byz=0)(torch.from_numpy(x))
    assert got.shape == (1, D)
    np.testing.assert_allclose(got[0].numpy(), want, atol=tol)


@pytest.mark.parametrize("spec,K_,n_byz", [
    ("rfa", 13, 3), ("rfa", 7, 1), ("bucketing(inner=mean, s=3)", 7, 1),
    ("bucketing(inner=rfa(n_iter=16), s=2)", 9, 0),
    ("bucketing(inner=cwmed, s=2)", 6, 2)])
def test_bucketing_with_the_reference_permutations(spec, K_, n_byz):
    x = _x(6, (K_, D)) + 2.0
    key = jax.random.PRNGKey(7)
    jfn = jagg.get_aggregator(spec, K_, n_byz)
    with jdispatch.use_backend("pallas-interpret"):   # Gram-space RFA
        want = jax.vmap(lambda k: jfn(jnp.asarray(x), k))(
            jax.random.split(key, K_))
    agg = resolve("aggregator", spec, K=K_, n_byz=n_byz)
    assert agg.bucket_size == (Spec.of(spec).name == "bucketing" and
                               dict(Spec.of(spec).kwargs)["s"]
                               or int(0.5 / (n_byz / K_)))
    perm = to_torch(bucket_perms(key, K_)).long()
    got = agg(torch.from_numpy(x), perm)
    assert got.shape == (K_, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_rfa_factory_without_byzantines_does_not_bucket():
    agg = resolve("aggregator", "rfa", K=13, n_byz=0)
    assert agg.bucket_size == 0
    with pytest.raises(ValueError, match="permutations"):
        resolve("aggregator", "rfa", K=13, n_byz=3)(torch.zeros(13, 4))


# ---------------------------------------------------------------------------
# Agreement
# ---------------------------------------------------------------------------


# n_keep=1 is left out: every singleton has diameter 0, and the reference's
# oracle breaks that tie on the rounding of sq_i + sq_i − 2 G_ii
@pytest.mark.parametrize("n_keep", [2, 4, 6])
def test_mda_and_gda_select_as_reference(n_keep):
    recv = _x(8, (3, 7, D))
    recv[1, 3] = recv[1, 5]                   # a duplicate row
    recv[2, 0] += 50.0                        # a far outlier
    own = recv[:, 2]
    mda = tagree.mda_mean(torch.from_numpy(recv), n_keep)
    gda = tagree.gda_mean(torch.from_numpy(recv), torch.from_numpy(own),
                          n_keep)
    for b in range(3):
        np.testing.assert_allclose(
            mda[b].numpy(), jagree.mda_mean(jnp.asarray(recv[b]), n_keep),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            gda[b].numpy(), jagree.gda_mean(jnp.asarray(recv[b]),
                                            jnp.asarray(own[b]), n_keep),
            rtol=1e-6, atol=1e-6)


AGREE = [("mda", "complete", None, False), ("gda", "complete", None, False),
         ("mda", "ring(k=4)", None, False),
         ("mda", "complete", "large_noise(sigma=5.0)", False),
         ("gda", "ring(k=4)", "large_noise(sigma=5.0)", True),
         ("mda", "ring(k=4)", "large_noise(sigma=5.0)", True),
         ("gda", "complete", "sign_flip", False)]


@pytest.mark.parametrize("method,topology,attack,per_receiver", AGREE)
def test_avg_agree_matches_reference(method, topology, attack,
                                     per_receiver):
    theta = _x(9, (K, D))
    kappa, n_byz = 3, 1
    byz = np.arange(K) < n_byz
    key = jax.random.PRNGKey(11)
    jatt = tatt = noise = None
    if attack is not None:
        jatt = jattacks.get_attack(attack)
        tatt = tattacks.get_attack(attack)
        if per_receiver:
            jatt = jattacks.per_receiver(jatt, K)
            tatt = tattacks.per_receiver(tatt, K)
        if tattacks.draws_noise(attack):
            noise = to_torch(agreement_draws(key, kappa, K, D, per_receiver))
    want = jagree.avg_agree(jnp.asarray(theta), kappa, n_byz,
                            jnp.asarray(byz), method, jatt,
                            key if jatt is not None else None,
                            topology=topology)
    got = tagree.avg_agree(torch.from_numpy(theta), kappa, n_byz,
                           torch.from_numpy(byz), method, tatt, noise,
                           topology=topology)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    honest = torch.from_numpy(~byz)
    np.testing.assert_allclose(
        tagree.honest_diameter(got, honest).numpy(),
        jagree.honest_diameter(want, jnp.asarray(~byz)), rtol=1e-3,
        atol=1e-4)


@pytest.mark.parametrize("method,alpha_bar", [("gda", 0.4), ("mda", 0.5),
                                              ("gda", 0.6)])
def test_avg_agree_alpha_bar_matches_reference(method, alpha_bar):
    """``alpha_bar`` overrides the method's tolerated fraction (how many
    neighbours an agent keeps): the port against the reference under one
    ``large_noise`` attack, and unlike the method's own fraction."""
    theta = _x(12, (K, D))
    kappa, n_byz = 2, 1
    byz = np.arange(K) < n_byz
    key = jax.random.PRNGKey(13)
    noise = to_torch(agreement_draws(key, kappa, K, D, False))
    att = "large_noise(sigma=5.0)"
    want = jagree.avg_agree(jnp.asarray(theta), kappa, n_byz,
                            jnp.asarray(byz), method,
                            jattacks.get_attack(att), key,
                            alpha_bar=alpha_bar)
    got = tagree.avg_agree(torch.from_numpy(theta), kappa, n_byz,
                           torch.from_numpy(byz), method,
                           tattacks.get_attack(att), noise,
                           alpha_bar=alpha_bar)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    own = tagree.avg_agree(torch.from_numpy(theta), kappa, n_byz,
                           torch.from_numpy(byz), method,
                           tattacks.get_attack(att), noise)
    assert not torch.allclose(got, own, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sigma,differs", [(5.0, False), (0.3, True)])
def test_per_receiver_equivocation_against_consistent_attack(sigma,
                                                             differs):
    """Per-receiver noise on a ring against one consistent message, with
    the draws of ``tests/test_topology.py``'s equivocation check. At
    sigma=5 GDA (n_keep=3 of 5) drops every Byzantine message, so the two
    agree exactly, in the reference as here; noise inside the honest
    spread is kept, and then the per-receiver values show."""
    K_, n_byz = 8, 2
    key = jax.random.PRNGKey(5)
    theta = to_torch(jax.random.normal(key, (K_, 4)))
    byz = torch.arange(K_) < n_byz
    att = tattacks.get_attack("large_noise", sigma=sigma)
    consistent = tagree.avg_agree(
        theta, 1, n_byz, byz, "gda", att,
        to_torch(agreement_draws(key, 1, K_, 4, False)),
        topology="ring(k=4)")
    equivocal = tagree.avg_agree(
        theta, 1, n_byz, byz, "gda", tattacks.per_receiver(att, K_),
        to_torch(agreement_draws(key, 1, K_, 4, True)),
        topology="ring(k=4)")
    assert torch.equal(consistent, equivocal) is not differs


def test_mda_limit_and_n_keep():
    theta = torch.zeros((17, 3))
    with pytest.raises(ValueError, match="deg_max=17"):
        tagree.avg_agree(theta, 1, 0, method="mda")
    # ring(k=4) keeps every neighbourhood at 5, so MDA runs at K=17
    out = tagree.avg_agree(theta, 1, 0, method="mda", topology="ring(k=4)")
    assert out.shape == (17, 3)


# ---------------------------------------------------------------------------
# Topologies
# ---------------------------------------------------------------------------

TOPOLOGIES = ["complete", "ring(k=4)", "torus", "erdos_renyi(p=0.4, seed=3)",
              "small_world(k=4, beta=0.5, seed=1)", "star(center=2)"]


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_topologies_match_reference(spec):
    ours, ref = resolve_topology(spec, 12), jax_topology(spec, 12)
    np.testing.assert_array_equal(ours.nbr_idx, ref.nbr_idx)
    np.testing.assert_array_equal(ours.adjacency, ref.adjacency)
    assert (ours.min_in_degree, ours.deg_max, ours.name) == \
        (ref.min_in_degree, ref.deg_max, ref.name)
    assert ours.spectral_gap == pytest.approx(ref.spectral_gap)
    assert ours.algebraic_connectivity == \
        pytest.approx(ref.algebraic_connectivity)
