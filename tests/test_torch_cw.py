"""The port's Krum, trimmed-mean and coordinate-wise agreement path against
the JAX package: the plain versions of the ``krum_score``,
``trimmed_mean``, ``gossip_reduce`` and ``neighbor_reduce`` kernels
against the Pallas bodies in interpret mode, and the aggregators,
forensics and ``avg_agree`` built on them against ``repro.core``. The
CUDA kernels themselves are held against the plain versions on a GPU by
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import agreement as jagree  # noqa: E402
from repro.core import attacks as jattacks  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.gossip_reduce import ref as jref  # noqa: E402
from repro.kernels.gossip_reduce.gossip_reduce import (  # noqa: E402
    gossip_reduce_pallas, neighbor_reduce_pallas)
from repro.kernels.krum_score.krum_score import (  # noqa: E402
    krum_scores_pallas)
from repro.kernels.trimmed_mean.trimmed_mean import (  # noqa: E402
    trimmed_mean_pallas)
from repro.topology import resolve_topology  # noqa: E402

from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import agreement as tagree  # noqa: E402
from repro_torch.core import attacks as tattacks  # noqa: E402
from repro_torch.core.registry import Spec, resolve  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.gossip_reduce import (  # noqa: E402
    check_mode, cw_reduce_plain, gossip_reduce, gossip_reduce_plain,
    neighbor_reduce, neighbor_reduce_plain)
from repro_torch.kernels.gossip_reduce import cw_reduce  # noqa: E402
from repro_torch.kernels.krum_score import (  # noqa: E402
    krum_score, krum_score_plain, krum_scores)
from repro_torch.kernels.pairwise_dist import gram_plain  # noqa: E402
from repro_torch.kernels.trimmed_mean import (  # noqa: E402
    trimmed_mean, trimmed_mean_plain)

from torch_parity import agreement_draws, bucket_perms, to_torch  # noqa: E402

torch.set_num_threads(2)

MODES = [("mean", 0), ("median", 0), ("trimmed", 1), ("trimmed", 2)]
#: Krum scores are sums of squared distances from the Gram identity, summed
#: in another order than the reference's: relative to the largest score
SCORE_RTOL = 1e-5


def _x(seed, shape, grid=False):
    rng = np.random.default_rng(seed)
    if grid:                      # small integers: every sum is exact
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _nbr(topology, K):
    return resolve_topology(topology, K).nbr_idx


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas bodies (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,d,n_trim", [(5, 33, 1), (13, 300, 3),
                                        (16, 129, 5)])
def test_trimmed_mean_matches_pallas(K, d, n_trim):
    x = _x(0, (2, K, d))
    x[1, 2] = x[1, 4]                                    # a duplicate row
    got = trimmed_mean(torch.from_numpy(x), n_trim).numpy()
    for b in range(2):
        want = trimmed_mean_pallas(jnp.asarray(x[b]), n_trim, interpret=True)
        # the kept values summed in slot order against XLA's order, and
        # the reference divides by n - 2 n_trim through a reciprocal
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K,d,n_near", [(4, 33, 1), (5, 386, 2),
                                        (13, 386, 8), (13, 300, 12)])
def test_krum_scores_match_pallas(K, d, n_near):
    x = _x(1, (K, d)) + 1.0
    got = krum_scores(torch.from_numpy(x)[None], n_near)[0].numpy()
    want = np.asarray(krum_scores_pallas(jnp.asarray(x), n_near,
                                         interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SCORE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("topology,K", [("complete", 9), ("ring(k=4)", 9)])
@pytest.mark.parametrize("mode,n_trim", MODES)
def test_gossip_and_neighbor_reduce_match_pallas(topology, K, mode, n_trim):
    nbr = _nbr(topology, K)
    P = nbr.shape[1]
    msgs = _x(2, (K, 300))
    recv = _x(3, (K, P, 300))
    recv[:, 1] = recv[:, 3]                              # tied neighbours
    got = gossip_reduce(torch.from_numpy(msgs),
                        torch.as_tensor(nbr, dtype=torch.int64), mode,
                        n_trim).numpy()
    want = gossip_reduce_pallas(jnp.asarray(msgs), jnp.asarray(nbr),
                                mode=mode, n_trim=n_trim, interpret=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got = neighbor_reduce(torch.from_numpy(recv), mode, n_trim).numpy()
    want = neighbor_reduce_pallas(jnp.asarray(recv), mode=mode,
                                  n_trim=n_trim, interpret=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


#: the slot counts of the CUDA rank network's instances and their edges:
#: exact 5 and 13, padded heights 8, 16 and 32, and P = 1, 2
SWEEP_P = (1, 2, 5, 7, 8, 9, 13, 16, 17, 31, 32)


def _slots_with_specials(P, shape, seed):
    """(P, *shape) normal values with tied slots, and a +inf, a -inf and
    a NaN slot in some coordinates."""
    v = _x(seed, (P,) + shape)
    v[P // 2] = v[0]                                     # tied slots
    v[P - 1, 0, :8] = np.inf
    v[0, 0, 4:12] = -np.inf
    v[(P - 1) // 3, 1, 2:6] = np.nan
    v[P // 3, 1, 5:7] = np.inf
    return v


@pytest.mark.parametrize("P", SWEEP_P)
@pytest.mark.parametrize("mode", ["mean", "median", "trimmed"])
def test_cw_reduce_plain_matches_reference_at_every_height(P, mode):
    """The plain reduce against the reference's ``cw_reduce`` and the
    Pallas body in interpret mode at the slot counts of every compiled
    rank network and its edges, with ties, infinities and NaN slots.
    Both sum the kept values, the plain version in slot order and the
    reference in XLA's order: P·eps·max|finite v| (NaN in the same
    places, infinities equal)."""
    n_trim = (P - 1) // 3 if mode == "trimmed" else 0
    v = _slots_with_specials(P, (3, 40), 20 + P)
    got = cw_reduce_plain(torch.from_numpy(v), mode, n_trim).numpy()
    tol = P * np.finfo(np.float32).eps * np.abs(v[np.isfinite(v)]).max()
    want = np.asarray(jref.cw_reduce(jnp.asarray(v), mode, n_trim))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    pallas = neighbor_reduce_pallas(jnp.asarray(v.transpose(1, 0, 2)),
                                    mode=mode, n_trim=n_trim, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=tol)
    if mode == "mean":                  # every slot is kept
        assert np.isnan(got[1, 2:5]).all() and np.isinf(got).any()


def test_cw_instance_takes_the_smallest_height():
    """Every P in 1..32 runs on the smallest compiled rank network that
    holds it: its exact instance where one exists, else a padded one."""
    heights = cw_reduce.EXACT_HEIGHTS + cw_reduce.PADDED_HEIGHTS
    for p in range(1, 33):
        h = cw_reduce.cw_instance(p)
        holds = [x for x in cw_reduce.PADDED_HEIGHTS if x >= p] + [
            x for x in cw_reduce.EXACT_HEIGHTS if x == p]
        assert h in heights and h == min(holds), (p, h)
        assert h == p or h in cw_reduce.PADDED_HEIGHTS
    assert [cw_reduce.cw_instance(p) for p in (1, 5, 6, 9, 13, 14, 17)] == \
        [8, 5, 8, 16, 13, 16, 32]
    with pytest.raises(ValueError, match="P <= 32"):
        cw_reduce.cw_instance(33)


# divisors are powers of two (or the reduce picks), so the reference's
# reciprocal and the port's division agree bit for bit: the selection and
# the tie rule are checked exactly
EXACT = [("complete", 8, "mean", 0), ("complete", 8, "median", 0),
         ("complete", 8, "trimmed", 2), ("complete", 9, "median", 0),
         ("ring(k=4)", 9, "median", 0), ("ring(k=4)", 9, "trimmed", 2)]


@pytest.mark.parametrize("topology,K,mode,n_trim", EXACT)
def test_reduces_are_exact_on_an_integer_grid(topology, K, mode, n_trim):
    nbr = _nbr(topology, K)
    msgs = _x(4, (K, 200), grid=True)
    msgs[2] = msgs[5]                                    # duplicate rows
    got = gossip_reduce(torch.from_numpy(msgs),
                        torch.as_tensor(nbr, dtype=torch.int64), mode,
                        n_trim).numpy()
    want = gossip_reduce_pallas(jnp.asarray(msgs), jnp.asarray(nbr),
                                mode=mode, n_trim=n_trim, interpret=True)
    np.testing.assert_array_equal(got, want)
    recv = msgs[nbr]
    np.testing.assert_array_equal(
        neighbor_reduce(torch.from_numpy(recv), mode, n_trim).numpy(),
        neighbor_reduce_pallas(jnp.asarray(recv), mode=mode, n_trim=n_trim,
                               interpret=True))


@pytest.mark.parametrize("K,n_trim", [(8, 2), (10, 1), (13, 6)])
def test_trimmed_mean_and_krum_are_exact_on_an_integer_grid(K, n_trim):
    x = _x(5, (K, 150), grid=True)
    x[1] = x[K - 1]                                      # duplicate rows
    np.testing.assert_array_equal(
        trimmed_mean(torch.from_numpy(x)[None], n_trim)[0].numpy(),
        trimmed_mean_pallas(jnp.asarray(x), n_trim, interpret=True))
    # equal distances tie: the column index decides, as in the reference
    np.testing.assert_array_equal(
        krum_scores(torch.from_numpy(x)[None], K - 3)[0].numpy(),
        krum_scores_pallas(jnp.asarray(x), K - 3, interpret=True))


def test_krum_score_plain_semantics():
    """Rank 0 is the exact-zero self distance; the kept ranks are summed."""
    x = torch.tensor([[[0.0], [1.0], [3.0], [7.0], [7.0]]])
    g = gram_plain(x)
    scores = krum_score_plain(g, 2)[0]
    d = (x[0] - x[0].T) ** 2
    want = torch.sort(d, dim=1).values[:, 1:3].sum(1)
    assert torch.equal(scores, want)
    assert torch.equal(krum_score(g, 2), krum_score_plain(g, 2))


def test_plain_versions_check_their_arguments():
    with pytest.raises(ValueError, match="unknown gossip reduce mode"):
        check_mode("sum", 5, 0)
    msgs = torch.zeros((4, 8))
    nbr = torch.zeros((4, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="deg_max > 2\\*n_trim"):
        gossip_reduce_plain(msgs, nbr, "trimmed", 3)
    with pytest.raises(ValueError, match="deg_max"):
        neighbor_reduce_plain(torch.zeros((4, 5, 8)), "trimmed", 3)
    with pytest.raises(ValueError, match="K > 2\\*n_trim"):
        trimmed_mean_plain(torch.zeros((1, 6, 8)), 3)


def test_cpu_tensors_take_the_plain_route():
    names = ("krum_score", "trimmed_mean", "gossip_reduce",
             "neighbor_reduce")
    before = dispatch.launch_counts()
    x = torch.from_numpy(_x(6, (1, 7, 40)))
    nbr = torch.as_tensor(_nbr("ring(k=4)", 7), dtype=torch.int64)
    assert torch.equal(trimmed_mean(x, 2), trimmed_mean_plain(x, 2))
    g = gram_plain(x)
    assert torch.equal(krum_score(g, 3), krum_score_plain(g, 3))
    assert torch.equal(gossip_reduce(x[0], nbr, "median"),
                       gossip_reduce_plain(x[0], nbr, "median"))
    recv = x[0][nbr]
    assert torch.equal(neighbor_reduce(recv, "trimmed", 1),
                       neighbor_reduce_plain(recv, "trimmed", 1))
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in names} == dict.fromkeys(names, 0)


# ---------------------------------------------------------------------------
# Aggregators and forensics against repro.core.aggregators
# ---------------------------------------------------------------------------


def _assert_krum_margin(x, n_byz, m):
    """Krum's selection is discontinuous: assert that the m-th lowest score
    beats the next by more than the score tolerance, so that rounding
    cannot swap the selected set."""
    s = torch.sort(krum_scores(x, max(x.shape[1] - n_byz - 2, 1)),
                   dim=1).values
    margin = (s[:, m] - s[:, m - 1]).min().item()
    assert margin > SCORE_RTOL * s.abs().max().item(), margin


@pytest.mark.parametrize("spec,K_,n_byz", [
    ("krum", 13, 3), ("krum(m=3)", 13, 3), ("krum", 13, 1),
    ("krum(m=2)", 13, 1), ("trimmed_mean", 13, 3), ("trimmed_mean", 7, 0)])
def test_krum_and_trimmed_mean_match_reference(spec, K_, n_byz):
    x = _x(7, (K_, 40)) + 2.0
    x[:n_byz] *= 10.0                                    # the Byzantine rows
    # a key whose buckets leave every receiver's Krum a clear winner
    key = jax.random.PRNGKey(11)
    jfn = jagg.get_aggregator(spec, K_, n_byz)
    with jdispatch.use_backend("pallas-interpret"):
        want = np.asarray(jax.vmap(lambda k: jfn(jnp.asarray(x), k))(
            jax.random.split(key, K_)))
    agg = resolve("aggregator", spec, K=K_, n_byz=n_byz)
    perm = to_torch(bucket_perms(key, K_)).long() if agg.bucket_size \
        else None
    got = agg(torch.from_numpy(x), perm).expand(K_, -1).numpy()
    if spec.startswith("krum"):
        # Lemma 3 with alpha_max 1/4: 13 agents and 1 Byzantine give
        # buckets of 3, and the inner Krum tolerates max(1, 5 // 4) = 1
        assert agg.bucket_size == (3 if n_byz == 1 else 0)
        m = dict(Spec.of(spec).kwargs).get("m", 1)
        if agg.bucket_size:
            _assert_krum_margin(tagg.bucket_means(torch.from_numpy(x), perm,
                                                  3), 1, m)
        else:
            _assert_krum_margin(torch.from_numpy(x)[None], n_byz, m)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", ["krum", "trimmed_mean", "cwtm", "rfa",
                                  "mean"])
@pytest.mark.parametrize("n_byz", [0, 2])
def test_suspicion_scores_and_rejection_mask_match_reference(spec, n_byz):
    x = _x(9, (9, 30))
    x[4] += 6.0                                          # a far sender
    with jdispatch.use_backend("pallas-interpret"):
        want = np.asarray(jagg.suspicion_scores(spec, jnp.asarray(x),
                                                n_byz))
        want_mask = np.asarray(jagg.rejection_mask(spec, jnp.asarray(x),
                                                   n_byz))
    got = tagg.suspicion_scores(spec, torch.from_numpy(x), n_byz).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    mask = tagg.rejection_mask(spec, torch.from_numpy(x), n_byz).numpy()
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.sum() == n_byz and (n_byz == 0 or mask[4])


def test_resilient_momentum_update_matches_reference():
    m, g = _x(10, (7, 20)), _x(11, (7, 20))
    jm, jdir = jagg.resilient_momentum_update(
        jagg.get_aggregator("trimmed_mean", 7, 1), jnp.asarray(m), 0.9,
        jnp.asarray(g))
    tm, tdir = tagg.resilient_momentum_update(
        resolve("aggregator", "trimmed_mean", K=7, n_byz=1),
        torch.from_numpy(m), 0.9, torch.from_numpy(g))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdir[0].numpy(), jdir, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Coordinate-wise agreement against repro.core.agreement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["cwmean", "cwmed", "cwtm",
                                    "cwtm(n_trim=2)"])
@pytest.mark.parametrize("topology", ["complete", "ring(k=4)"])
@pytest.mark.parametrize("attack,per_receiver", [
    (None, False), ("large_noise(sigma=5.0)", False),
    ("large_noise(sigma=5.0)", True)],
    ids=["honest", "consistent", "per_receiver"])
def test_cw_avg_agree_matches_reference(method, topology, attack,
                                        per_receiver):
    K, D, kappa, n_byz = 7, 33, 3, 1
    theta = _x(12, (K, D))
    byz = np.arange(K) < n_byz
    key = jax.random.PRNGKey(13)
    jatt = tatt = noise = None
    if attack is not None:
        jatt, tatt = jattacks.get_attack(attack), tattacks.get_attack(attack)
        if per_receiver:
            jatt = jattacks.per_receiver(jatt, K)
            tatt = tattacks.per_receiver(tatt, K)
        noise = to_torch(agreement_draws(key, kappa, K, D, per_receiver))
    # the reference's default route on the CPU: its jnp oracle, which runs
    # the same cw_reduce body as its Pallas kernels
    want = jagree.avg_agree(jnp.asarray(theta), kappa, n_byz,
                            jnp.asarray(byz), method, jatt,
                            key if jatt is not None else None,
                            topology=topology)
    got = tagree.avg_agree(torch.from_numpy(theta), kappa, n_byz,
                           torch.from_numpy(byz), method, tatt, noise,
                           topology=topology)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cwtm_needs_more_neighbours_than_it_trims():
    """ring(k=4) gives every receiver 5 neighbours: cwtm with n_byz=3
    would trim 6 of them, and both packages refuse it."""
    theta = _x(14, (9, 4))
    with pytest.raises(ValueError, match="deg_max > 2\\*n_trim"):
        jagree.avg_agree(jnp.asarray(theta), 1, 3, method="cwtm",
                         topology="ring(k=4)")
    with pytest.raises(ValueError, match="deg_max > 2\\*n_trim"):
        tagree.avg_agree(torch.from_numpy(theta), 1, 3, method="cwtm",
                         topology="ring(k=4)")
