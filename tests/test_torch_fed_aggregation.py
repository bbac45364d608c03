"""``repro_torch.distributed.aggregation`` against the JAX package's
``repro.distributed.aggregation`` on the CPU: the stacked-tree algebra,
the ``fed_aggregator`` rules, GDA and the ``fed_attack`` rules, on random
stacked trees of three leaves made from a numpy seed (the JAX side
jitted).

Tolerances: every product is an f32 sum over a few hundred entries taken
in other orders on the two sides, so Gram matrices, distances, weighted
sums and mixes agree to 1e-6 of their largest entry (the gaps measured
here are below 2e-7); RFA's weights go through 8 Weiszfeld steps on those
Gram entries, 1e-5. Selections (Krum's winner, GDA's neighbours, the
trimmed ranks) are exact, and the tests that depend on a selection assert
its margin first; the attacks' Byzantine rows agree to 1e-6 of the
largest entry, the honest rows are untouched."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attacks as jattacks  # noqa: E402
from repro.core.registry import REGISTRY as JREGISTRY  # noqa: E402
from repro.distributed import aggregation as jagg  # noqa: E402

from repro_torch.core import attacks as tattacks  # noqa: E402
from repro_torch.core.registry import REGISTRY as TREGISTRY  # noqa: E402
from repro_torch.distributed import aggregation as tagg  # noqa: E402

from torch_parity import fed_tree_normals, to_torch  # noqa: E402

#: three leaves, nested, with two and three trailing axes
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
#: share of the largest entry within which plain f32 products agree
LIN_RTOL = 1e-6


def _tree(K, seed=0, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(node[k]) for k in sorted(node)}
        return (scale * rng.standard_normal((K,) + node)).astype(np.float32)

    return make(shapes)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(want, got, rtol=LIN_RTOL):
    """Leaf by leaf, within ``rtol`` of the largest entry of the tree."""
    w_leaves = [np.asarray(x) for x in jax.tree.leaves(want)]
    g_leaves = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in jax.tree.leaves(got)]
    assert len(w_leaves) == len(g_leaves)
    scale = max(float(np.abs(w).max()) for w in w_leaves) or 1.0
    for w, g in zip(w_leaves, g_leaves):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)


def test_registry_names_equal_the_reference():
    for ns in ("fed_aggregator", "fed_attack"):
        assert TREGISTRY.names(ns) == JREGISTRY.names(ns)
    assert TREGISTRY.meta("fed_attack", "large_noise")["noise"]


@pytest.mark.parametrize("block", [0, 2, 3, 4, 6])
def test_stacked_gram_and_blocked(block):
    """Blocked at K = 6 with blocks of 2 and 3; the fallbacks at block 0,
    4 (does not divide K) and 6 (K <= block)."""
    tree = _tree(6, seed=block)
    want = jax.jit(lambda t: jagg.stacked_gram_blocked(t, block))(
        _jax(tree))
    got = tagg.stacked_gram_blocked(_torch(tree), block)
    _close(want, got)
    _close(jax.jit(jagg.stacked_gram)(_jax(tree)),
           tagg.stacked_gram(_torch(tree)))
    _close(jax.jit(jagg.stacked_sq_dists)(_jax(tree)),
           tagg.stacked_sq_dists(_torch(tree)))


@pytest.mark.parametrize("mix_dtype", [None, "bfloat16"])
def test_stacked_weighted_sum(mix_dtype):
    tree = _tree(5, seed=3)
    w = np.random.default_rng(4).random(5).astype(np.float32)
    jd = None if mix_dtype is None else jnp.bfloat16
    td = None if mix_dtype is None else torch.bfloat16
    want = jax.jit(lambda w, t: jagg.stacked_weighted_sum(w, t, jd))(
        jnp.asarray(w), _jax(tree))
    got = tagg.stacked_weighted_sum(torch.from_numpy(w), _torch(tree), td)
    _close(want, got)


@pytest.mark.parametrize("mix_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block", [0, 2, 4])
def test_stacked_mix(mix_dtype, block):
    """Row-stochastic mixing at K = 6: plain, in blocks of 2, and the
    fallback at 4; bf16 operands with an f32 accumulator."""
    K = 6
    tree = _tree(K, seed=5 + block)
    W = np.random.default_rng(6).random((K, K)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    jd = None if mix_dtype is None else jnp.bfloat16
    td = None if mix_dtype is None else torch.bfloat16
    want = jax.jit(lambda W, t: jagg.stacked_mix(W, t, jd, block))(
        jnp.asarray(W), _jax(tree))
    got = tagg.stacked_mix(torch.from_numpy(W), _torch(tree), td, block)
    _close(want, got)
    for leaf in jax.tree.leaves(got):
        assert leaf.dtype == torch.float32


def _krum_margin(tree, n_byz):
    """The gap between Krum's best score and the next one above it, as a
    share of the largest score. With one neighbour (n_near = 1) the two
    agents of the closest pair tie exactly by construction (d2 is
    symmetric on both sides, which this asserts of the port), and the
    first wins; the margin is then to the next pair."""
    d2 = tagg.stacked_sq_dists(_torch(tree)).numpy()
    assert np.array_equal(d2, d2.T)
    K = d2.shape[0]
    n_near = max(K - n_byz - 2, 1)
    scores = np.sort(np.sort(d2, axis=1)[:, 1:n_near + 1].sum(1))
    above = scores[scores > scores[0]]
    return (above[0] - scores[0]) / scores[-1]


@pytest.mark.parametrize("spec,K,n_byz", [
    ("mean", 5, 1), ("krum", 6, 1), ("krum", 5, 2), ("rfa", 5, 1),
    ("rfa(n_iter=16, nu=0.001)", 4, 0), ("trimmed_mean", 6, 2),
    ("trimmed_mean", 3, 2), ("trimmed_mean", 5, 0)])
def test_fed_aggregators(spec, K, n_byz):
    """Each ``fed_aggregator`` through ``aggregate``; the trimmed mean
    with n = min(n_byz, (K − 1)//2) at K = 3, n_byz = 2 (n = 1) and its
    n = 0 path (the mean)."""
    tree = _tree(K, seed=K + n_byz)
    if spec == "krum":
        assert _krum_margin(tree, n_byz) > 1e-3
    want = jax.jit(lambda t: jagg.aggregate(spec, t, n_byz))(_jax(tree))
    got = tagg.aggregate(spec, _torch(tree), n_byz)
    _close(want, got, 1e-5 if spec.startswith("rfa") else LIN_RTOL)
    for leaf in jax.tree.leaves(got):     # the aggregate is in every row
        assert torch.equal(leaf, leaf[:1].expand_as(leaf))


def test_krum_picks_the_reference_winner_exactly():
    tree = _tree(6, seed=9)
    assert _krum_margin(tree, 1) > 1e-3
    want = jagg.agg_krum(_jax(tree), 1)
    got = tagg.agg_krum(_torch(tree), 1)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gda_mix_matrix_keeps_the_lower_index_on_ties():
    """All-zero rows (the aggregate broadcast to every honest row) and
    partial ties: ``lax.top_k``'s choice, exactly."""
    K = 6
    d2 = np.zeros((K, K), np.float32)
    d2[0, 3] = d2[3, 0] = 1.0
    d2[1, 2:] = 2.0
    d2[2, 0] = d2[2, 5] = 0.5
    for n_keep in (1, 3, 4, 6):
        want = np.asarray(jax.jit(jagg.gda_mix_matrix, static_argnums=1)(
            jnp.asarray(d2), n_keep))
        got = tagg.gda_mix_matrix(torch.from_numpy(d2), n_keep).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kappa", [0, 1, 3, 9])
def test_gda_agree(kappa):
    """κ = 9 is the reference's ``lax.scan`` branch. alpha_bar = 0.4 at
    K = 6 keeps 4 of 6, so the selection matters; the test asserts each
    round's selection margin: the 4th and 5th nearest stand apart, or
    they are copies of each other (after a round, agents that kept the
    same neighbours are equal, and which copy is kept changes nothing).
    Copies are told by their distance from the Gram identity G_aa + G_bb
    − 2 G_ab, whose cancellation leaves a few ulps of max‖θ_i‖² in place
    of 0 (``tests/test_torch_decbyzpg.py`` holds Δ² to 8 of them), in an
    order the host BLAS picks: the guard takes 8 ulps of max‖θ_i‖²."""
    K, alpha_bar = 6, 0.4
    tree = _tree(K, seed=20 + kappa)
    want = jax.jit(lambda t: jagg.gda_agree(t, kappa, alpha_bar))(
        _jax(tree))
    t = _torch(tree)
    n_keep = max(int((1.0 - alpha_bar) * K + 0.999), 1)
    for _ in range(kappa):          # every round's 4th/5th nearest apart
        d2 = tagg.stacked_sq_dists(t).numpy()
        copies = 8 * np.finfo(np.float32).eps \
            * tagg.stacked_sq_norms(t).max().item()
        order = np.argsort(d2, axis=1, kind="stable")
        for k in range(K):
            a, b = order[k, n_keep - 1], order[k, n_keep]
            assert d2[k, b] - d2[k, a] > 1e-4 * d2.max() \
                or d2[a, b] <= copies
        W = tagg.gda_mix_matrix(tagg.stacked_sq_dists(t), n_keep)
        t = tagg.stacked_mix(W, t)
    got = tagg.gda_agree(_torch(tree), kappa, alpha_bar)
    _close(want, got)
    _close(want, t)


@pytest.mark.parametrize("mix_dtype,block", [("bfloat16", 0), (None, 2),
                                             ("bfloat16", 3)])
def test_gda_agree_mix_options(mix_dtype, block):
    K, kappa = 6, 2
    tree = _tree(K, seed=31)
    jd = None if mix_dtype is None else jnp.bfloat16
    td = None if mix_dtype is None else torch.bfloat16
    want = jax.jit(lambda t: jagg.gda_agree(t, kappa, 0.2, jd, block))(
        _jax(tree))
    got = tagg.gda_agree(_torch(tree), kappa, 0.2, td, block)
    _close(want, got)


def test_gda_agree_single_agent_is_identity():
    tree = _torch(_tree(1, seed=2))
    assert tagg.gda_agree(tree, 3) is tree


@pytest.mark.parametrize("spec", ["none", "large_noise(sigma=10)",
                                  "avg_zero", "sign_flip(scale=2)",
                                  "sign_flip"])
def test_fed_attacks(spec):
    """Each ``fed_attack`` at K = 6 with 2 Byzantine rows; large_noise on
    the reference's own normals (one key per leaf, its Byzantine rows),
    within an ulp (the jitted reference fuses ``sigma ×`` into its
    draw); the honest rows untouched."""
    K = 6
    tree = _tree(K, seed=40)
    mask = np.arange(K) < 2
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda t, m, k: jagg.attack_stacked(spec, t, m, k))(
        _jax(tree), jnp.asarray(mask), key)
    noise = fed_tree_normals(key, _jax(tree), mask)
    got = tagg.attack_stacked(spec, _torch(tree), torch.from_numpy(mask),
                              noise)
    _close(want, got)
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(g[2:].numpy(), w[2:])  # honest kept


def test_attack_none_spec_and_missing_noise():
    tree = _torch(_tree(4, seed=1))
    mask = torch.tensor([True, False, False, False])
    assert tagg.attack_stacked(None, tree, mask) is tree
    with pytest.raises(ValueError, match="noise"):
        tagg.attack_stacked("large_noise", tree, mask)


def test_stacked_avg_zero_equals_the_flat_attack():
    """Per-leaf avg_zero equals ``core.attacks.avg_zero`` on the ravel (a
    coordinate-wise attack), in the port as in the reference
    (``tests/test_page_attacks.py``)."""
    K = 8
    tree = _torch(_tree(K, seed=50))
    mask = torch.from_numpy(np.arange(K) < 2)
    out = tagg.attack_stacked("avg_zero", tree, mask)
    flat = torch.cat([leaf.reshape(K, -1) for leaf in jax.tree.leaves(out)],
                     dim=1)
    x = torch.cat([leaf.reshape(K, -1) for leaf in jax.tree.leaves(tree)],
                  dim=1)
    torch.testing.assert_close(flat, tattacks.avg_zero(x, mask),
                               rtol=0, atol=1e-6)
    want = jattacks.avg_zero(jnp.asarray(x.numpy()), jnp.asarray(
        mask.numpy()), None)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_bare_tensor_is_a_one_leaf_tree():
    x = _tree(5, seed=60, shapes={"x": (7,)})["x"]
    _close(jagg.stacked_gram(jnp.asarray(x)),
           tagg.stacked_gram(torch.from_numpy(x)))
    assert to_torch(x).shape == (5, 7)
