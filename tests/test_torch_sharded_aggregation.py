"""The D-sharded flat layer of ``repro_torch.distributed.aggregation``
(``dim_sharded``, ``flat_*``), the ``sharded=`` routes of
``repro_torch.core.aggregators`` and ``avg_agree``, and the flat
federated trainer on a mesh, on the CPU.

One process: the flat layer on plain tensors (the route with one shard)
against the port's one-process aggregators, bit for bit where the route
promises it (Krum m = 1, RFA, the trimmed mean), and against the JAX
package's ``flat_*`` at its own tests' tolerances
(``tests/test_flat_aggregation.py``); the ``sharded=True`` specs routed
onto the flat layer; ``avg_agree(sharded=True)`` against the reference's.

Several processes: gloo ranks spawned once per mesh, in one module
fixture, for 2 ranks, 4 ranks and a (2, 2) ("data", "model") mesh from
``make_debug_mesh``. Each rank runs every case on its columns of a ragged
D (1001 over 4 ranks: 251, 251, 251, 248; 3 over 4: an empty shard) and
returns its results; the parent puts the columns back together and
holds them against the one-process route and the reference:

* the combined Gram matrix per entry within ``GRAM_TOL`` of √(G_ii G_jj)
  (the ranks' partials summed in another order than one ``gram``);
* Krum (its margins asserted first) and the trimmed mean bit for bit;
  RFA's weights come from that Gram matrix and centered clipping's
  factors from norms summed over the ranks, so their results within
  ``RFA_TOL`` of the inputs' largest entry;
* the cw agreement rounds bit for bit, MDA and GDA within ``AGREE_TOL``;
* the flat federated step (``sharded=True``) against the reference's
  sharded step at the flat parity test's tolerances, and against the
  port's one-process step;
* under ``CommDebugMode`` only ``all_gather``s, and no operator
  dispatched on a DTensor.

Krum and the trimmed mean carry ``large_noise``; RFA runs without an
attack, since under ``large_noise(sigma=10)`` its weights depend on the
Gram matrix's rounding order at the attacked row.
"""
import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import agreement as jagree  # noqa: E402
from repro.core import attacks as jattacks  # noqa: E402
from repro.core.registry import resolve as jresolve  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.distributed import aggregation as jagg  # noqa: E402
from repro.distributed import fed_trainer as jft  # noqa: E402
from repro.optim.optimizers import AdamState as JAdamState  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.convert import fed_state_from_jax  # noqa: E402
from repro_torch.core import aggregators as taggs  # noqa: E402
from repro_torch.core import agreement as tagree  # noqa: E402
from repro_torch.core.attacks import large_noise, per_receiver  # noqa: E402
from repro_torch.core.registry import resolve  # noqa: E402
from repro_torch.core.tree import tree_paths, unravel_tree  # noqa: E402
from repro_torch.distributed import aggregation as tagg  # noqa: E402
from repro_torch.carriers import columns as tcols  # noqa: E402
from repro_torch.distributed import fed_trainer as tft  # noqa: E402
from repro_torch.kernels.pairwise_dist import pairwise_sq_dists  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402

from torch_parity import (agreement_draws, replay_fed_noise,  # noqa: E402
                          shared_loss_trace)
from torch_ranks import CollectiveWatch, run_meshes  # noqa: E402

#: the meshes: ranks and the ("data", "model") shape
MESHES = {"2": (2, (1, 2)), "4": (4, (1, 4)), "2x2": (4, (2, 2))}

K, D = 8, 1001
AGG_CASES = [("krum", 0), ("krum", 1), ("krum(m=3)", 0), ("rfa", 0),
             ("rfa", 1), ("trimmed_mean", 2),
             ("bucketing(inner=trimmed_mean, s=2)", 0), ("centered_clip", 0)]
#: the cases whose result follows sums over the ranks (RFA's weights from
#: the Gram matrix, centered clipping's norms), held within RFA_TOL
SUMMED = ("rfa", "centered_clip")
#: receivers' permutations of the bucketing cases (R = 2)
PERM = np.array([[3, 0, 6, 1, 7, 2, 5, 4], [5, 1, 0, 7, 2, 6, 4, 3]])
AGREE_K, KAPPA, AGREE_BYZ = 6, 2, 1
#: method -> attack: none, a consistent large_noise, or one per receiver
AGREE_CASES = {"cwmean": None, "gda": None, "cwtm": "consistent",
               "mda": "consistent", "cwmed": "per_receiver"}
#: the federated steps: aggregator -> attack
FED_CASES = {"rfa": "none", "krum": "large_noise(sigma=10)",
             "trimmed_mean": "large_noise(sigma=10)"}
FED_K, FED_B, FED_S = 4, 2, 16
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=128, head_dim=16)

#: the combined Gram matrix per entry, over √(G_ii G_jj): f32 sums of
#: 1001 products in two orders
GRAM_TOL = 1e-6
#: RFA and centered clipping over ranks against one process, as a share
#: of max|x|: RFA's weights come from Gram entries that differ by
#: GRAM_TOL, the clipping factors from norms summed in another order
RFA_TOL = 1e-5
#: MDA and GDA over ranks against one process, as a share of the largest
#: entry: a mean of the same rows, rounded at another width
AGREE_TOL = 1e-6
#: the flat parity test's (tests/test_torch_fed_trainer.py) tolerances
STATE_RTOL, LOSS_RTOL = 2e-6, 1e-6


def _stack(k, d, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((k, d))
    return (scale * x).astype(np.float32)


def _agg_input(d):
    x = _stack(K, d, 1)
    x[0] *= 10.0                    # one far row, as a Byzantine's
    return x


def _agree_inputs(d):
    theta = _stack(AGREE_K, d, 2)
    rng = np.random.default_rng(3)
    return theta, {
        "consistent": rng.standard_normal((KAPPA, AGREE_K, d)).astype(
            np.float32),
        "per_receiver": rng.standard_normal(
            (KAPPA, AGREE_K, AGREE_K, d)).astype(np.float32)}


def _agree(method, theta, noise, sharded=None):
    """The port's ``avg_agree`` of one case; ``theta`` a tensor (plain or
    DTensor), ``noise`` the case's numpy draws."""
    attack = AGREE_CASES[method]
    mask = torch.arange(AGREE_K) < AGREE_BYZ
    fn = nz = None
    if attack is not None:
        fn = functools.partial(large_noise, sigma=10.0)
        if attack == "per_receiver":
            fn = per_receiver(fn, AGREE_K)
        nz = torch.tensor(noise[attack])
    return tagree.avg_agree(theta, KAPPA, AGREE_BYZ, mask, method, fn, nz,
                            sharded=sharded)


def _cfgs():
    jc = dataclasses.replace(jreduced(jget_config("llama3.2-1b")), **TINY)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), **TINY)
    return jc, tc


def _feds(agg, attack):
    """The reference's and the port's FedConfig of one federated case."""
    kw = dict(aggregator=agg, attack=attack, kappa=2, n_byz=1, lr=1e-3,
              telemetry=True)
    return jft.FedConfig(**kw), tft.FedConfig(**kw)


# ---------------------------------------------------------------------------
# The ranks' side (run in spawned processes)
# ---------------------------------------------------------------------------

def _columns(t, mesh):
    from repro_torch.distributed.fed_trainer import flat_param_sharding
    return tcols.shard_columns(t, mesh, flat_param_sharding(mesh))


def _local(t):
    local, sh = tcols.local_columns(t)
    return local.detach().clone(), (None if sh is None else (sh.lo, sh.hi))


def _rank_cases(mesh, inputs):
    """Every case on this rank; returns its results as CPU tensors with
    the columns they hold."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh)
    import torch.distributed as dist
    out = {"agg": {}, "agree": {}, "fed": {}, "empty": {}}
    world = dist.get_world_size()

    # detection, on every case of a DTensor
    x = torch.from_numpy(_agg_input(D))
    xs = _columns(x, mesh)
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    flat = make_debug_mesh(world, 1, device_type="cpu")      # model of 1
    prod = make_production_mesh(device_type="cpu")
    out["production"] = (prod.mesh_dim_names, tuple(prod.shape))
    one = DTensor.from_local(x, flat, [Replicate(), Shard(1)],
                             run_check=False)
    out["dim_sharded"] = [tagg.dim_sharded(x), tagg.dim_sharded(xs),
                          tagg.dim_sharded(xs, axis=0),
                          tagg.dim_sharded(rep), tagg.dim_sharded(one)]

    with CollectiveWatch(out):
        out["gram"] = tagg.flat_gram(xs)
        perm = torch.from_numpy(PERM)
        for spec, n_byz in AGG_CASES:
            agg = resolve("aggregator", spec, K=K, n_byz=n_byz)
            out["agg"][spec, n_byz] = _local(agg(xs, perm))
        agg = resolve("aggregator", "krum(sharded=True)", K=K, n_byz=0)
        out["agg"]["krum(sharded=True)", 0] = _local(agg(xs, perm))
        scores = taggs.suspicion_scores
        out["scores"] = {name: scores(name, xs, 2) for name in
                         ("krum", "trimmed_mean", "rfa")}

        theta, noise = _agree_inputs(D)
        for method in AGREE_CASES:
            out["agree"][method] = _local(
                _agree(method, _columns(torch.from_numpy(theta), mesh),
                       noise))

        jstate, batch, mask, noises = (inputs[k] for k in
                                       ("state", "batch", "mask", "noise"))
        _, tcfg = _cfgs()
        unravel = functools.partial(unravel_tree, shapes=param_shapes(tcfg))
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for agg_name, attack in FED_CASES.items():
            _, tfed = _feds(agg_name, attack)
            state = fed_state_from_jax(jstate, "cpu", mesh)
            for large in (True, False):
                new, m = tft.fed_train_step_flat(
                    tcfg, tfed, state, unravel, tbatch,
                    torch.from_numpy(mask), noises[agg_name], large=large,
                    sharded=True)
                out["fed"][agg_name, large] = (
                    [_local(t) for _, t in tree_paths(new)],
                    {k: v.clone() for k, v in m.items()})
        specs = tft.flat_fed_state_shardings(mesh, state)
        fields = lambda st: [st.theta, st.prev, st.v,  # noqa: E731
                             *st.opt_state, st.step]
        out["placements"] = [
            (tuple(t.placements) if isinstance(t, DTensor) else None, p)
            for t, p in zip(fields(state), fields(specs))]

    # an empty shard (3 columns over 4 ranks: 1, 1, 1, 0)
    small = _columns(torch.from_numpy(_agg_input(3)), mesh)
    out["empty"]["cols"] = _local(small)[1]
    for spec, n_byz in AGG_CASES:
        agg = resolve("aggregator", spec, K=K, n_byz=n_byz)
        out["empty"][spec, n_byz] = _local(agg(small, torch.from_numpy(PERM)))
    theta, noise = _agree_inputs(3)
    for method in AGREE_CASES:
        out["empty"][method] = _local(
            _agree(method, _columns(torch.from_numpy(theta), mesh), noise))
    return out


def _rank_main(rank, world, port, kind, inp, dst):
    """One spawned rank: join the gloo group, build the mesh, run every
    case, write the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        n_data, n_model = MESHES[kind][1]
        mesh = make_debug_mesh(n_data, n_model, device_type="cpu")
        with open(inp, "rb") as f:
            inputs = pickle.load(f)
        out = _rank_cases(mesh, inputs)
        out["coords"] = tuple(mesh.get_coordinate())
        torch.save(out, dst)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

def _mid_state(jcfg, jfed, seed=0):
    """A reference flat state as it stands mid-run (the trainer tests'
    recipe): θ around the common init, prev near θ, a running v, Adam at
    step 3; numpy leaves."""
    st, unravel = jft.init_flat_fed_state(jcfg, jfed, FED_K,
                                          jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    like = lambda scale, base=0.0: (np.asarray(base) + scale *  # noqa: E731
                                    rng.standard_normal(st.theta.shape)
                                    ).astype(np.float32)
    theta = like(0.02, st.theta)
    prev, v, m = like(0.01, theta), like(0.1), like(0.05)
    vv = (like(0.05) ** 2 + 1e-4).astype(np.float32)
    opt = JAdamState(np.full((FED_K,), 3, np.int32), m, vv)
    return jft.FlatFedState(theta, prev, v, opt, np.int32(3)), unravel


@functools.lru_cache(maxsize=None)
def _fed_inputs():
    """The federated cases' inputs (numpy, for the ranks) and the
    reference's sharded steps: one jitted program for every case, with a
    traced coin."""
    jcfg, _ = _cfgs()
    jfeds = {a: _feds(a, att)[0] for a, att in FED_CASES.items()}
    jstate, unravel = _mid_state(jcfg, jfeds["rfa"])
    batch = {k: np.array(v) for k, v in JPipeline(JDataConfig(
        jcfg.vocab_size, FED_S, FED_B, FED_K, seed=3)).batch(0).items()}
    mask = np.arange(FED_K) < 1
    key = jax.random.PRNGKey(11)
    noises = {a: replay_fed_noise(key, jstate.theta, mask, _feds(a, att)[1],
                                  True) for a, att in FED_CASES.items()}

    def run(s, b, m, kk, large):
        return {a: jft.fed_train_step_flat(jcfg, f, s, unravel, b, m, kk,
                                           large=large, sharded=True)
                for a, f in jfeds.items()}

    with shared_loss_trace():
        step = jax.jit(run)
        want = {}
        for large in (True, False):
            js = jax.tree.map(jnp.asarray, jstate)
            for a, res in step(js, batch, jnp.asarray(mask), key,
                               jnp.asarray(large)).items():
                want[a, large] = res
    inputs = {"state": jstate, "batch": batch, "mask": mask,
              "noise": noises}
    return inputs, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's ranks, spawned once, all meshes at a time: mesh kind
    -> the ranks' results, in rank order. No rank outlives the
    fixture."""
    inputs, _ = _fed_inputs()
    return run_meshes("test_torch_sharded_aggregation",
                      {kind: m[0] for kind, m in MESHES.items()},
                      dict.fromkeys(MESHES, inputs),
                      str(tmp_path_factory.mktemp("sharded")))


def _assemble(results, get):
    """The whole tensor from the ranks' (local, cols) pieces, data row 0;
    every other data row must hold the same bits."""
    rows = {}
    for res in results:
        local, cols = get(res)
        rows.setdefault(res["coords"][0], []).append((cols[0], local))
    whole = [torch.cat([t for _, t in sorted(parts, key=lambda p: p[0])],
                       dim=-1) for _, parts in sorted(rows.items())]
    for other in whole[1:]:
        assert torch.equal(other, whole[0])
    return whole[0]


def _krum_margin(x, n_near, m=1):
    """The gap that decides Krum's pick, over the largest score, from
    the one-process distances: above the winner's score (ties at n_near 1
    are exact and go to the first), or with m > 1 between the m-th and
    the next."""
    d2 = tagg.flat_sq_dists(x).numpy()
    s = np.sort(np.sort(d2, axis=1)[:, 1:n_near + 1].sum(1))
    if m > 1:
        return (s[m] - s[m - 1]) / s[-1]
    return (s[s > s[0]][0] - s[0]) / s[-1]


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_flat_layer_on_one_shard_is_the_one_process_route():
    """Plain tensors: Krum (m 1), RFA and the trimmed mean bit for bit,
    multi-Krum and the distances too (the same kernels in the same
    order); blocked Grams within 1e-6 of the kernel's."""
    x = torch.from_numpy(_agg_input(600))
    x3 = x[None]
    assert torch.equal(tagg.flat_sq_dists(x), pairwise_sq_dists(x3)[0])
    for m in (1, 3):
        assert torch.equal(tagg.flat_krum(x, 2, m=m),
                           taggs.krum(x3, 2, m=m)[0])
    assert torch.equal(tagg.flat_rfa(x, n_iter=16),
                       taggs.rfa(x3, n_iter=16)[0])
    assert torch.equal(tagg.flat_trimmed_mean(x, 2),
                       taggs.trimmed_mean(x3, 2)[0])
    g = tagg.flat_gram(x)
    for block in (2, 4):
        np.testing.assert_allclose(tagg.flat_gram(x, block=block), g,
                                   rtol=0, atol=1e-6 * g.abs().max().item())
    assert not tagg.dim_sharded(x)


@pytest.mark.parametrize("K_,D_", [(5, 37), (8, 512), (13, 1000)])
def test_flat_layer_matches_the_reference(K_, D_):
    """Against ``repro.distributed.aggregation.flat_*`` at the
    reference's test tolerances (``tests/test_flat_aggregation.py``)."""
    x = _stack(K_, D_, K_)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tagg.flat_sq_dists(tx),
                               jagg.flat_sq_dists(jx), rtol=1e-4, atol=1e-3)
    for m in (1, 3):
        assert _krum_margin(tx, max(K_ - 2 - 2, 1), m) > 1e-4
        np.testing.assert_allclose(tagg.flat_krum(tx, 2, m=m),
                                   jagg.flat_krum(jx, 2, m=m),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tagg.flat_rfa(tx, n_iter=16),
                               jagg.flat_rfa(jx, n_iter=16),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tagg.flat_trimmed_mean(tx, 2),
                                  jagg.flat_trimmed_mean(jx, 2))


def test_sharded_specs_route_to_the_flat_layer(monkeypatch):
    """``"krum(sharded=True)"``, ``"rfa(sharded=True)"`` and
    ``"trimmed_mean(sharded=True)"`` (and the bucketing factory's inner
    spec) resolve onto the rule whose body the flat layer runs, with
    ``sharded=True`` handed on, and agree bit for bit with the dense spec
    and within 1e-4 with the reference's sharded specs."""
    calls = []
    for name in ("krum", "rfa", "trimmed_mean"):
        orig = getattr(taggs, name)
        monkeypatch.setattr(taggs, name, functools.partial(
            lambda f, n, *a, **kw: calls.append((n, kw.get("sharded")))
            or f(*a, **kw), orig, name))
    x = _stack(8, 512, 4)
    assert _krum_margin(torch.from_numpy(x), 8 - 1 - 2) > 1e-4
    perm = torch.from_numpy(PERM[:1])
    key = jax.random.PRNGKey(1)
    for spec, n_byz, rule in (
            ("krum(sharded=True)", 0, "krum"),
            ("rfa(sharded=True)", 0, "rfa"),
            ("trimmed_mean(sharded=True)", 1, "trimmed_mean"),
            ("rfa(sharded=True)", 1, "rfa"),
            ("bucketing(inner=rfa, s=2, sharded=True)", 0, "rfa")):
        calls.clear()
        agg = resolve("aggregator", spec, K=8, n_byz=n_byz)
        got = agg(torch.from_numpy(x), perm)
        assert calls == [(rule, True)], spec
        dense = resolve("aggregator", spec.replace(", sharded=True", "")
                        .replace("(sharded=True)", ""), K=8, n_byz=n_byz)
        assert torch.equal(got, dense(torch.from_numpy(x), perm))
        if agg.bucket_size:
            continue    # the reference draws its permutation from its key
        want = jax.jit(lambda a, k: jresolve(
            "aggregator", spec, K=8, n_byz=n_byz)(a, k))(jnp.asarray(x), key)
        np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", list(AGREE_CASES))
def test_avg_agree_sharded_matches_the_reference(method):
    """``avg_agree(sharded=True)`` on one process: the ``sharded=None``
    rounds bit for bit, and the reference's ``avg_agree(sharded=True)``
    (its ``jnp`` oracles) on the same draws."""
    theta = _stack(AGREE_K, 64, 2)
    tt = torch.from_numpy(theta)
    attack = AGREE_CASES[method]
    fn = key = noise = None
    if attack is not None:
        key = jax.random.PRNGKey(5)
        fn = jattacks.get_attack("large_noise(sigma=10)")
        if attack == "per_receiver":
            fn = jattacks.per_receiver(fn, AGREE_K)
        # the reference's own draws, for the port
        noise = {attack: np.asarray(agreement_draws(
            key, KAPPA, AGREE_K, 64, attack == "per_receiver"))}
    got = _agree(method, tt, noise, sharded=True)
    assert torch.equal(got, _agree(method, tt, noise))
    want = jagree.avg_agree(jnp.asarray(theta), KAPPA, AGREE_BYZ,
                            jnp.arange(AGREE_K) < AGREE_BYZ, method, fn, key,
                            sharded=True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(theta).max())


# ---------------------------------------------------------------------------
# Several processes: the spawned ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_detection_and_gram(ranks, kind):
    """``dim_sharded``: False for a plain tensor, True split along D,
    False along K, False replicated, False over a dimension of size 1.
    ``make_production_mesh`` puts every rank on "model". The combined
    Gram matrix is the same on every rank and within GRAM_TOL of the
    one-process one per entry."""
    x = torch.from_numpy(_agg_input(D))
    want = tagg.flat_gram(x)
    scale = torch.sqrt(torch.outer(torch.diagonal(want),
                                   torch.diagonal(want)))
    for res in ranks[kind]:
        assert res["dim_sharded"] == [False, True, False, False, False]
        assert res["production"] == (("data", "model"),
                                     (1, MESHES[kind][0]))
        assert torch.equal(res["gram"], ranks[kind][0]["gram"])
        assert ((res["gram"] - want).abs() / scale).max() <= GRAM_TOL


@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_aggregators_match_one_process(ranks, kind):
    """Each aggregator case on D = 1001 split over the ranks, with and
    without bucketing: Krum and the trimmed mean bit for bit (Krum's
    margins asserted), RFA and centered clipping within RFA_TOL of
    max|x|; the suspicion scores within 1e-6."""
    x = torch.from_numpy(_agg_input(D))
    perm = torch.from_numpy(PERM)
    for spec, n_byz in AGG_CASES + [("krum(sharded=True)", 0)]:
        agg = resolve("aggregator", spec, K=K, n_byz=n_byz)
        want = agg(x, perm)
        got = _assemble(ranks[kind], lambda r: r["agg"][spec, n_byz])
        assert got.shape == want.shape
        if spec.startswith(SUMMED):
            assert (got - want).abs().max() <= RFA_TOL * x.abs().max()
            continue
        if spec.startswith("krum"):
            bucketed = agg.bucket_size > 0
            rows = (taggs.bucket_means(x, perm, agg.bucket_size) if bucketed
                    else x[None])
            n_near = max(rows.shape[1] - (1 if bucketed else
                                          max(n_byz, 1)) - 2, 1)
            m = 3 if "m=3" in spec else 1
            for r in rows:
                assert _krum_margin(r, n_near, m) > 1e-4
        assert torch.equal(got, want), spec
    for name, score in ranks[kind][0]["scores"].items():
        want = taggs.suspicion_scores(name, x, 2)
        np.testing.assert_allclose(score, want, rtol=1e-6)


@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_agreement_matches_one_process(ranks, kind):
    """``avg_agree`` on a D-sharded θ for every method against the
    one-process rounds: the cw reduces bit for bit (coordinate-wise); MDA
    and GDA select from distances summed over the ranks (the same choices
    here) and average the selected rows' local columns, within AGREE_TOL
    of the largest entry (the CPU's mean over the selected rows rounds
    differently at another width)."""
    theta, noise = _agree_inputs(D)
    tt = torch.from_numpy(theta)
    for method in AGREE_CASES:
        got = _assemble(ranks[kind], lambda r: r["agree"][method])
        want = _agree(method, tt, noise)
        if method.startswith("cw"):
            assert torch.equal(got, want), method
        else:
            assert (got - want).abs().max() <= \
                AGREE_TOL * want.abs().max(), method


@pytest.mark.parametrize("kind", list(MESHES))
def test_empty_shard_runs(ranks, kind):
    """D = 3 over the ranks: on 4 model ranks the last holds no column,
    launches nothing and still joins every sum; the results equal the
    one-process route (RFA and centered clipping within RFA_TOL)."""
    x = torch.from_numpy(_agg_input(3))
    cols = [r["empty"]["cols"] for r in ranks[kind]]
    if MESHES[kind][1][1] == 4:
        assert (3, 3) in cols
    perm = torch.from_numpy(PERM)
    for spec, n_byz in AGG_CASES:
        want = resolve("aggregator", spec, K=K, n_byz=n_byz)(x, perm)
        got = _assemble(ranks[kind], lambda r: r["empty"][spec, n_byz])
        if spec.startswith(SUMMED):
            assert (got - want).abs().max() <= RFA_TOL * x.abs().max()
        else:
            assert torch.equal(got, want), spec
    theta, noise = _agree_inputs(3)
    for method in ("cwmean", "cwtm", "cwmed"):
        got = _assemble(ranks[kind], lambda r: r["empty"][method])
        assert torch.equal(got, _agree(method, torch.from_numpy(theta),
                                       noise)), method


def _fed_field(results, agg, large, i):
    return _assemble(results, lambda r: r["fed"][agg, large][0][i])


@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_fed_step_matches_the_reference(ranks, kind):
    """``fed_train_step_flat(sharded=True)`` on the mesh, coin 1 and 0,
    from a mid-run state carried by ``fed_state_from_jax(mesh=)``,
    telemetry on: θ, prev, v and Adam's moments within STATE_RTOL of
    their largest entry of the reference's ``sharded=True`` step
    (replayed draws), the losses within LOSS_RTOL, the rejection mask
    equal; and the same against the port's one-process step."""
    inputs, want = _fed_inputs()
    _, tcfg = _cfgs()
    unravel = functools.partial(unravel_tree, shapes=param_shapes(tcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    for agg, attack in FED_CASES.items():
        _, tfed = _feds(agg, attack)
        for large in (True, False):
            wstate, wm = want[agg, large]
            fields = [wstate.theta, wstate.prev, wstate.v,
                      wstate.opt_state.m, wstate.opt_state.v]
            idx = {"theta": 0, "prev": 1, "v": 2, "m": 4, "adam v": 5}
            one, om = tft.fed_train_step_flat(
                tcfg, tfed, fed_state_from_jax(inputs["state"], "cpu"),
                unravel, tbatch, torch.from_numpy(inputs["mask"]),
                inputs["noise"][agg], large=large)
            ones = [one.theta, one.prev, one.v, one.opt_state.m,
                    one.opt_state.v]
            for (what, i), w, o in zip(idx.items(), fields, ones):
                got = _fed_field(ranks[kind], agg, large, i)
                w = np.asarray(w)
                scale = max(np.abs(w).max(),
                            np.abs(np.asarray(wstate.opt_state.m)).max())
                np.testing.assert_allclose(got, w, rtol=0,
                                           atol=STATE_RTOL * scale,
                                           err_msg=f"{agg} {large} {what}")
                np.testing.assert_allclose(got, o, rtol=0,
                                           atol=STATE_RTOL * scale,
                                           err_msg=f"{agg} {large} {what}")
            for res in ranks[kind]:
                m = res["fed"][agg, large][1]
                np.testing.assert_allclose(float(m["loss"]),
                                           float(wm["loss"]), rtol=LOSS_RTOL)
                np.testing.assert_allclose(float(m["grad_norm"]),
                                           float(wm["grad_norm"]), rtol=1e-5)
                np.testing.assert_array_equal(m["rejected"],
                                              np.asarray(wm["rejected"]))
                np.testing.assert_array_equal(m["rejected"], om["rejected"])
                np.testing.assert_allclose(float(m["diameter"]),
                                           float(wm["diameter"]), rtol=1e-5)


@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_route_collectives(ranks, kind):
    """Over every case of a rank: ``CommDebugMode`` counts only
    ``all_gather``s (no ``all_reduce``, no ``reduce_scatter``), and no
    operator was dispatched on a DTensor. The state carried onto the
    mesh (``fed_state_from_jax(mesh=)``, as ``init_flat_fed_state(mesh=)``
    places it) has ``flat_fed_state_shardings``' placements: Shard(1) on
    "model" for every (K, D) stack, the counters replicated (plain
    tensors, the same on every rank)."""
    from torch.distributed.tensor import Replicate, Shard
    stack, rep = (Replicate(), Shard(1)), (Replicate(), Replicate())
    for res in ranks[kind]:
        assert res["dtensor_ops"] == []
        assert set(res["comm"]) == {"c10d.allgather_"}, res["comm"]
        assert res["placements"] == [(stack, stack)] * 3 + [(None, rep)] \
            + [(stack, stack)] * 2 + [(None, rep)]
