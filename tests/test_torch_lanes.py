"""Lane batching in the port (``run_grid(lanes=True)``, the default): the
static/traced split and the lane groups against the reference's, the lane
route against the per-scenario route and against the JAX package's own
``run_grid(lanes=True)``, launch counts per iteration in place of the
reference's compile counts, chained windows, the lane functions over two
gloo ranks, and the sweep's lane-grouped manifest. The counterpart of the
lane tests of ``tests/test_engine.py``, at the reference's tolerances:
returns atol 1e-5, samples exact, the diameter 1e-3, θ 1e-5."""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.byzpg import ByzPGConfig as JByzPGConfig
from repro.core.decbyzpg import DecByzPGConfig as JDecByzPGConfig
from repro.core.tree import ravel
from repro.kernels import dispatch as jdispatch
from repro.rl.envs import make_cartpole as jax_cartpole
from repro.rl.policy import resolve_policy as jax_resolve_policy

from repro_torch.analysis.retrace import LaunchWatch
from repro_torch.core import engine as teng
from repro_torch.core.byzpg import ByzPGConfig
from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
from repro_torch.core.registry import REGISTRY, Spec
from repro_torch.distributed import sharding
from repro_torch.kernels.rfa import weiszfeld_plain
from repro_torch.rl.envs import make_cartpole
from repro_torch.sweep import SweepMismatch, SweepRunner
from repro_torch.sweep import manifest as mf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity import replay_byzpg_noise, replay_step_noise  # noqa: E402

H = 8
ENV = make_cartpole(horizon=H)
ENV_SPEC = f"cartpole(horizon={H})"
T = 3
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
#: every spawned rank's wall limit: a hung rank fails its test
TIMEOUT_S = 300


def tiny_dec(**kw):
    base = dict(K=3, n_byz=1, attack="sign_flip", aggregator="rfa",
                agreement="gda", kappa=2, N=4, B=2, eta=1e-2, hidden=(8,),
                seed=11)
    base.update(kw)
    return base


def _assert_rows_close(lanes, per, carry="theta"):
    assert list(map(tuple, lanes)) == list(map(tuple, per))
    for scn in per:
        np.testing.assert_allclose(lanes[scn]["returns"],
                                   per[scn]["returns"], atol=1e-5)
        np.testing.assert_array_equal(lanes[scn]["samples"],
                                      per[scn]["samples"])
        if "diameter" in per[scn]:
            np.testing.assert_allclose(lanes[scn]["diameter"],
                                       per[scn]["diameter"], atol=1e-3)
        np.testing.assert_allclose(lanes[scn][carry], per[scn][carry],
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The static/traced split and the groups, against the reference's
# ---------------------------------------------------------------------------


def _both_splits(algo, kw):
    port = teng.lane_split(
        (DecByzPGConfig if algo == "decbyzpg" else ByzPGConfig)(**kw),
        teng._algo(algo).traced_fields)
    ref = jeng.lane_split(
        (JDecByzPGConfig if algo == "decbyzpg" else JByzPGConfig)(**kw),
        jeng._algo(algo).traced_fields)
    assert port[1] == ref[1] and port[2] == ref[2]
    assert repr(port[0]) == repr(ref[0])
    return port


def test_lane_split_static_traced():
    """Scenarios differing only in traced scalars (eta, a traced attack
    sigma, an explicit p equal to the B/N default) share one static
    representative; names and values equal the reference's."""
    s1, n1, v1 = _both_splits("decbyzpg", tiny_dec(
        eta=1e-2, attack="large_noise(sigma=10)", seed=3))
    s2, n2, v2 = _both_splits("decbyzpg", tiny_dec(
        eta=5e-3, attack="large_noise(sigma=50)", seed=7))
    s3, n3, v3 = _both_splits("decbyzpg", tiny_dec(
        eta=1e-2, attack="large_noise", p=0.5))
    assert s1 == s2 == s3 and hash(s1) == hash(s3) and n1 == n2 == n3
    assert s1.attack == Spec("large_noise") and s1.seed == 0
    assert s1.p is None
    tr1, tr2, tr3 = (dict(zip(n, v)) for n, v in
                     ((n1, v1), (n2, v2), (n3, v3)))
    assert tr1["eta"] == 1e-2 and tr2["eta"] == 5e-3
    assert tr1["attack.sigma"] == 10.0 and tr2["attack.sigma"] == 50.0
    assert tr3["attack.sigma"] == 100.0        # factory default filled in
    assert tr1["switch_p"] == 0.5 and tr3["switch_p"] == 0.5
    s4, _, _ = _both_splits("decbyzpg", tiny_dec(K=4))
    assert s4 != s1
    sb, nb, _ = _both_splits("byzpg", dict(K=3, n_byz=1, eta=2e-2,
                                           attack="alie(z=2.0)"))
    assert nb == ("eta", "gamma", "baseline", "switch_p", "attack.z",
                  "aggregator.nu")


def test_lane_split_traced_aggregator_kwargs():
    """rfa's nu and centered_clip's tau batch into lanes like an attack's
    sigma; a static kwarg (n_iter) splits the group."""
    s1, n1, v1 = _both_splits("decbyzpg", tiny_dec(aggregator="rfa(nu=1e-6)"))
    s2, n2, v2 = _both_splits("decbyzpg", tiny_dec(aggregator="rfa(nu=1e-2)"))
    s3, n3, v3 = _both_splits("decbyzpg", tiny_dec(aggregator="rfa"))
    assert s1 == s2 == s3 and n1 == n2 == n3
    assert s1.aggregator == Spec("rfa")
    assert dict(zip(n2, v2))["aggregator.nu"] == 1e-2
    assert dict(zip(n3, v3))["aggregator.nu"] == 1e-6
    sa, na, va = _both_splits("decbyzpg",
                              tiny_dec(aggregator="centered_clip(tau=0.5)"))
    sb, _, _ = _both_splits("decbyzpg",
                            tiny_dec(aggregator="centered_clip(tau=2.0)"))
    assert sa == sb and sa.aggregator == Spec("centered_clip")
    assert dict(zip(na, va))["aggregator.tau"] == 0.5
    sc, _, _ = _both_splits("decbyzpg", tiny_dec(aggregator="rfa(n_iter=8)"))
    assert sc != s1


@pytest.mark.parametrize("algo", ["decbyzpg", "byzpg"])
def test_lane_groups_match_reference(algo):
    """The same groups, in the same order, with the same members, traced
    names and values as the reference's ``lane_groups``."""
    axes = {"eta": (1e-2, 5e-3),
            "attack": ("none", "large_noise(sigma=10)",
                       "large_noise(sigma=50)", "sign_flip(scale=2.0)"),
            "aggregator": ("rfa", "rfa(nu=1e-3)", "krum")}
    base = dict(K=5, n_byz=1, N=4, B=2, hidden=(8,))
    grid = dict(seeds=(0, 1), axes=axes)
    _, tscn = teng.grid_scenarios(teng.ScenarioGrid(**grid), algo=algo,
                                  base=base)
    _, jscn = jeng.grid_scenarios(jeng.ScenarioGrid(**grid), algo=algo,
                                  base=base)
    ours = list(teng.lane_groups(tscn, algo=algo).items())
    ref = list(jeng.lane_groups(jscn, algo=algo).items())
    assert len(ours) == len(ref) == 6
    for ((s, n), m), ((rs, rn), rm) in zip(ours, ref):
        assert repr(s) == repr(rs) and n == rn
        assert [(tuple(a), v) for a, _, v in m] == \
            [(tuple(a), v) for a, _, v in rm]


# ---------------------------------------------------------------------------
# The lane route against the per-scenario route
# ---------------------------------------------------------------------------


def test_lane_grid_matches_per_scenario():
    """Honest and attacked configs, lane for lane."""
    grid = teng.ScenarioGrid(seeds=(0, 1), axes={
        "eta": (1e-2, 5e-3), "attack": ("none", "large_noise(sigma=10)")})
    kw = dict(algo="decbyzpg", K=3, n_byz=1, N=4, B=2, kappa=2,
              hidden=(8,), device="cpu")
    lanes = teng.run_grid(ENV, grid, T, lanes=True, **kw)
    per = teng.run_grid(ENV, grid, T, lanes=False, **kw)
    _assert_rows_close(lanes, per)


def test_lane_grid_matches_per_scenario_byzpg():
    grid = teng.ScenarioGrid(seeds=(0, 1), axes={"eta": (1e-2, 2e-2),
                                                 "p": (0.25, 0.75)})
    kw = dict(algo="byzpg", K=3, n_byz=1, attack="sign_flip", N=4, B=2,
              hidden=(8,), device="cpu")
    lanes = teng.run_grid(ENV, grid, T, lanes=True, **kw)
    per = teng.run_grid(ENV, grid, T, lanes=False, **kw)
    _assert_rows_close(lanes, per, carry="vec")


def test_lane_grid_lane_matches_single_run():
    """A lane inside a lane-batched sweep replays ``run_decbyzpg`` for the
    matching (config, seed)."""
    single = run_decbyzpg(ENV, DecByzPGConfig(**tiny_dec(seed=2, eta=5e-3)),
                          T, device="cpu")
    kw = tiny_dec()
    for k in ("seed", "eta"):
        kw.pop(k)
    res = teng.run_grid(ENV, teng.ScenarioGrid(seeds=(2,), axes={
        "eta": (1e-2, 5e-3)}), T, algo="decbyzpg", device="cpu", **kw)
    out = res[(5e-3,)]
    np.testing.assert_allclose(out["returns"][0], single["returns"],
                               atol=1e-5)
    np.testing.assert_array_equal(out["samples"][0], single["samples"])
    np.testing.assert_allclose(out["theta"][0], single["theta"].numpy(),
                               atol=1e-5)


def test_experiment_takes_lanes():
    """``Experiment(lanes=...)`` is accepted, as in the reference, and
    both routes give the same grid."""
    kw = dict(algo="byzpg", env=ENV_SPEC, T=2, seeds=(0, 1),
              axes={"eta": (1e-2, 2e-2)}, K=3, n_byz=1, N=4, B=2,
              hidden=(8,), device="cpu")
    on = teng.Experiment(**kw).run()
    off = teng.Experiment(lanes=False, **kw).run()
    assert teng.Experiment(**kw).lanes is True
    _assert_rows_close(on.results, off.results, carry="vec")


KWARG_SWEEPS = {
    "rfa_nu": ("aggregator", ("rfa(nu=1e-6)", "rfa(nu=1e-3)",
                              "rfa(nu=1e-1)"), dict(attack="sign_flip")),
    "sign_flip_scale": ("attack", ("sign_flip(scale=1.0)",
                                   "sign_flip(scale=3.0)",
                                   "sign_flip(scale=5.0)"), {}),
    "alie_z": ("attack", ("alie(z=0.5)", "alie(z=1.5)", "alie(z=3.0)"), {}),
    "large_noise_sigma": ("attack", ("large_noise(sigma=1)",
                                     "large_noise(sigma=10)"), {}),
}


@pytest.mark.parametrize("name", sorted(KWARG_SWEEPS))
def test_lane_kwarg_sweep_launches_one_run(name):
    """A sweep of a traced kwarg is one lane group: over its L lanes × 2
    seeds it launches, per iteration, exactly what one run of a member
    launches (the reference's ``compile_count() == 1``), and each lane
    matches its per-scenario run."""
    axis, values, extra = KWARG_SWEEPS[name]
    kw = dict(K=5, n_byz=1, agreement="mda", kappa=2, N=4, B=2,
              hidden=(8,), **{"aggregator": "rfa", **extra})
    kw.pop(axis, None)
    grid = teng.ScenarioGrid(seeds=(0, 1), axes={axis: values})
    _, scenarios = teng.grid_scenarios(grid, base=kw)
    assert len(teng.lane_groups(scenarios)) == 1
    with LaunchWatch() as lanes_watch:
        lanes = teng.run_grid(ENV, grid, T, device="cpu", **kw)
    with LaunchWatch() as one:
        run_decbyzpg(ENV, scenarios[0][1], T, device="cpu")
    assert lanes_watch.counts == one.counts and one.counts
    per = teng.run_grid(ENV, grid, T, lanes=False, device="cpu", **kw)
    _assert_rows_close(lanes, per)


#: one spec per registered component, for the no-fallback test
COMPONENTS = {
    "attack": ("none", "avg_zero", "large_noise(sigma=3)", "sign_flip",
               "alie", "random_action"),
    "aggregator": ("mean", "krum", "rfa", "cwmed", "trimmed_mean",
                   "centered_clip(tau=0.5)", "bucketing(inner=rfa, s=2)"),
    "agreement": ("mda", "gda", "cwmean", "cwmed", "cwtm"),
    "estimator": ("gpomdp", "reinforce"),
    "optimizer": ("adam", "sgd(momentum=0.9)"),
    "topology": ("complete", "ring(k=2)", "torus", "erdos_renyi(p=0.9)",
                 "small_world(k=2, beta=0.3)", "star"),
    "policy": ("mlp", "transformer(arch='qwen2.5-3b', d_model=16, "
               "n_layers=1, n_heads=2, d_ff=32)"),
}


@pytest.mark.parametrize("ns, spec", [(ns, s) for ns, specs in
                                      COMPONENTS.items() for s in specs])
def test_no_component_runs_its_rows_one_at_a_time(ns, spec):
    """Every registered component takes the row axis: a 2-lane × 2-seed
    group launches per iteration what one run launches, and its lanes
    match the per-scenario runs."""
    names = set(REGISTRY.names(ns))
    assert Spec.of(spec).name in names
    kw = dict(K=4, n_byz=1, attack="large_noise(sigma=3)", aggregator="rfa",
              agreement="gda", kappa=1, N=3, B=2, hidden=(4,))
    kw[ns] = spec
    env = make_cartpole(horizon=4)
    grid = teng.ScenarioGrid(seeds=(0, 1), axes={"eta": (1e-2, 2e-2)})
    _, scenarios = teng.grid_scenarios(grid, base=kw)
    with LaunchWatch() as lanes_watch:
        lanes = teng.run_grid(env, grid, 2, device="cpu", **kw)
    with LaunchWatch() as one:
        run_decbyzpg(env, scenarios[0][1], 2, device="cpu")
    assert lanes_watch.counts == one.counts
    per = teng.run_grid(env, grid, 2, lanes=False, device="cpu", **kw)
    _assert_rows_close(lanes, per)


def test_registered_components_all_covered():
    for ns, specs in COMPONENTS.items():
        assert {Spec.of(s).name for s in specs} == set(REGISTRY.names(ns))


def test_registry_kwarg_audit_is_exhaustive():
    """Every numeric factory kwarg of the sweepable namespaces is
    classified traced or static, as in the reference."""
    import repro_torch.distributed.aggregation  # noqa: F401  fed_*
    for ns in ("attack", "aggregator", "fed_attack", "fed_aggregator"):
        assert REGISTRY.unclassified_kwargs(ns) == {}, ns
    assert "s" in REGISTRY.meta("aggregator", "bucketing")["static_kwargs"]
    assert "scale" in REGISTRY.meta("attack", "sign_flip")["traced_kwargs"]
    from repro.core.registry import REGISTRY as JREG
    import repro.distributed.aggregation  # noqa: F401
    for ns in ("attack", "aggregator", "fed_attack", "fed_aggregator"):
        for name in REGISTRY.names(ns):
            for key in ("traced_kwargs", "static_kwargs"):
                assert set(REGISTRY.meta(ns, name).get(key, ())) == \
                    set(JREG.meta(ns, name).get(key, ())), (ns, name, key)


# ---------------------------------------------------------------------------
# Windows, carries, pad rows
# ---------------------------------------------------------------------------


def _one_group(algo, base, axes, seeds=(0, 1)):
    grid = teng.ScenarioGrid(seeds=seeds, axes=axes)
    _, scenarios = teng.grid_scenarios(grid, algo=algo, base=base)
    ((static_cfg, names), members), = \
        teng.lane_groups(scenarios, algo=algo).items()
    n_rows = len(members) * len(seeds)
    vals, seeds_flat = teng.lane_operands(members, seeds, n_rows)
    return static_cfg, names, n_rows, vals, seeds_flat


@pytest.mark.parametrize("algo, base, axes", [
    ("decbyzpg", dict(K=3, n_byz=1, N=4, B=2, kappa=2, hidden=(8,)),
     {"eta": (1e-2, 5e-3),
      "attack": ("large_noise(sigma=10)", "large_noise(sigma=50)")}),
    ("byzpg", dict(K=3, n_byz=1, attack="sign_flip", N=4, B=2,
                   hidden=(8,)), {"eta": (1e-2, 2e-2)})],
    ids=["decbyzpg", "byzpg"])
def test_lane_windows_chain_bit_identical(algo, base, axes):
    """Chaining the window functions over ``window_slices`` replays the
    one-shot lane run bit for bit: same draws, same carry, same
    history."""
    static_cfg, names, n, vals, seeds = _one_group(algo, base, axes)
    T_ = 5
    ref = teng.lane_batch_loop(ENV, static_cfg, T_, names, n, algo,
                               "cpu")(vals, seeds)
    carry, gens = teng.lane_init_loop(ENV, static_cfg, n, algo,
                                      "cpu")(seeds)
    chunks = []
    for start, stop in teng.window_slices(T_, 3):
        window = teng.lane_window_loop(ENV, static_cfg, T_, names,
                                       stop - start, n, algo, "cpu")
        carry, ch = window(carry, gens, vals, range(start, stop))
        chunks.append(ch)
    got = teng.assemble_hist(carry, chunks, algo)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_lane_carry_struct_matches_init_loop():
    """The meta-device skeleton names the same leaves, shapes and dtypes
    as the real init's rows: the sweep's restore template."""
    a = teng._algo("decbyzpg")
    static_cfg, _, _ = teng.lane_split(DecByzPGConfig(**tiny_dec()),
                                       a.traced_fields)
    struct = teng.lane_carry_struct(ENV, static_cfg, 4, "decbyzpg")
    real, gens = teng.lane_init_loop(ENV, static_cfg, 4, "decbyzpg",
                                     "cpu")(range(4))
    assert len(gens) == 4
    s_leaves = jax.tree_util.tree_leaves(struct)
    r_leaves = jax.tree_util.tree_leaves(real)
    assert type(struct) is type(real) and len(s_leaves) == len(r_leaves)
    for s, r in zip(s_leaves, r_leaves):
        assert s.shape == r.shape and s.dtype == r.dtype
        assert s.device.type == "meta"


def test_pad_rows_repeats_last_row_and_slices_clean():
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    padded = teng._pad_rows(x, 5)
    assert padded.shape == (5, 2)
    assert torch.equal(padded[:3], x)
    assert torch.equal(padded[3:], x[-1:].expand(2, 2))
    assert teng._pad_rows(x, 3) is x
    vals, seeds = teng.lane_operands(
        [(None, None, (1e-2, 0.5)), (None, None, (2e-2, 0.5))], (4, 5), 5)
    assert seeds.tolist() == [4, 5, 4, 5, 5]
    assert vals.dtype == torch.float32
    assert vals[:, 0].tolist() == torch.tensor(
        [1e-2, 1e-2, 2e-2, 2e-2, 2e-2]).tolist()


def test_page_direction_takes_a_coin_per_row():
    """``page_direction`` with one coin per row gives each row the
    direction its own Python coin gives."""
    from repro_torch.core.page import init_page, page_direction
    rng = np.random.default_rng(3)
    params = {"w": torch.tensor(rng.normal(size=(3, 4)).astype(np.float32))}
    state = init_page({"w": params["w"] * 0.5})
    state = state._replace(v={"w": torch.ones(3, 4)})

    def grad_fn(p, batch):
        return {"w": p["w"] * batch}

    coins = torch.tensor([True, False, True])
    rows = page_direction(grad_fn, params, state, 2.0, coins)
    for r, c in enumerate(coins.tolist()):
        one = page_direction(
            grad_fn, {"w": params["w"][r]},
            init_page({"w": state.prev_params["w"][r]})._replace(
                v={"w": state.v["w"][r]}), 2.0, c)
        assert torch.equal(rows.v["w"][r], one.v["w"])


def test_lane_grid_telemetry_matches_per_scenario():
    """``telemetry=True`` takes the row axis too: the rejected masks and
    gradient norms of every row are the per-scenario runs'."""
    grid = teng.ScenarioGrid(seeds=(0, 1), axes={"eta": (1e-2, 5e-3)})
    kw = dict(algo="decbyzpg", K=5, n_byz=1, N=4, B=2, kappa=1,
              hidden=(8,), aggregator="krum", attack="large_noise(sigma=3)",
              telemetry=True, device="cpu")
    lanes = teng.run_grid(ENV, grid, 2, **kw)
    per = teng.run_grid(ENV, grid, 2, lanes=False, **kw)
    _assert_rows_close(lanes, per)
    for scn in per:
        np.testing.assert_array_equal(lanes[scn]["rejected"],
                                      per[scn]["rejected"])
        np.testing.assert_allclose(lanes[scn]["grad_norm"],
                                   per[scn]["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_bias_gradient_is_a_fixed_tree(n):
    """The MLP's bias gradient sums its rows by ``column_tree_sum``: the
    plain sum's value to rounding, and each agent's bits whatever the
    number of agents beside it."""
    from repro_torch.rl.policy import _BiasAdd, column_tree_sum
    rng = np.random.default_rng(n)
    g = torch.tensor(rng.normal(size=(3, n, 5)).astype(np.float32))
    tree = column_tree_sum(g)
    torch.testing.assert_close(tree, g.sum(1), rtol=1e-5, atol=1e-5)
    assert torch.equal(column_tree_sum(torch.cat([g] * 4))[:3], tree)
    x = torch.zeros(3, n, 5, requires_grad=True)
    b = torch.zeros(3, 5, requires_grad=True)
    out = _BiasAdd.apply(x, b)
    assert torch.equal(out, x + b[:, None, :])
    out.backward(g)
    assert torch.equal(b.grad, tree) and torch.equal(x.grad, g)


def test_weiszfeld_plain_per_row_nu_equals_scalar_calls():
    """A (Bt,) ``nu`` gives, bit for bit, each batch element's scalar
    call."""
    g = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, 7, 16)).astype(np.float32))
    g = g @ g.transpose(1, 2)
    nus = torch.tensor([1e-6, 1e-3, 1e-1, 5.0])
    w = weiszfeld_plain(g, nus, 32)
    for b, nu in enumerate([1e-6, 1e-3, 1e-1, 5.0]):
        assert torch.equal(w[b], weiszfeld_plain(g[b:b + 1], nu, 32)[0])
    with pytest.raises(ValueError, match="every nu"):
        weiszfeld_plain(g, torch.tensor([1e-6, 0.0, 1e-1, 5.0]), 4)


# ---------------------------------------------------------------------------
# The port's lane route against the JAX package's run_grid(lanes=True)
# ---------------------------------------------------------------------------


BACKEND = os.environ.get("LANES_BACKEND", "pallas-interpret")


def _plain(v):
    return v.canonical() if isinstance(v, Spec) else v


@pytest.mark.parametrize("algo, base, axes", [
    ("decbyzpg", dict(K=3, n_byz=1, N=4, B=2, kappa=2, agreement="gda",
                      hidden=(8,)),
     {"eta": (1e-2, 5e-3),
      "attack": ("large_noise(sigma=1)", "large_noise(sigma=10)")}),
    ("byzpg", dict(K=3, n_byz=0, N=4, B=2, hidden=(8,)),
     {"eta": (1e-2, 2e-2)})],
    ids=["decbyzpg_attacked", "byzpg_honest"])
def test_lane_route_matches_jax_run_grid(algo, base, axes):
    """``repro.core.engine.run_grid(lanes=True)`` (its RFA in Gram space,
    under ``pallas-interpret``) against the port's lane route fed each
    row's θ₀ and StepNoise replayed from the reference's key tree."""
    seeds = (0, 1)
    jenv = jax_cartpole(horizon=H)
    jeng.clear_cache()
    try:
        with jdispatch.use_backend(BACKEND):
            ref = jeng.run_grid(jenv, jeng.ScenarioGrid(seeds=seeds,
                                                        axes=axes),
                                T, algo=algo, lanes=True, **base)
    finally:
        jeng.clear_cache()
    grid = teng.ScenarioGrid(seeds=seeds, axes=axes)
    _, scenarios = teng.grid_scenarios(grid, algo=algo, base=base)
    jcls = JDecByzPGConfig if algo == "decbyzpg" else JByzPGConfig
    replay = replay_step_noise if algo == "decbyzpg" else replay_byzpg_noise
    carry = teng._algo(algo).carry_hist
    for (static_cfg, names), members in teng.lane_groups(
            scenarios, algo=algo).items():
        n = len(members) * len(seeds)
        vals, seeds_flat = teng.lane_operands(members, seeds, n)
        theta0, noise = [], []
        for scn, cfg, _ in members:
            for s in seeds:
                jcfg = jcls(**{f.name: _plain(getattr(cfg, f.name))
                               for f in dataclasses.fields(cfg)})
                jcfg = dataclasses.replace(jcfg, seed=s)
                ks = jeng.seed_keys(s)
                th = np.array(ravel(jax_resolve_policy(jcfg, jenv).init(
                    ks.init))[0])
                theta0.append(th)
                noise.append(replay(jenv, jcfg, th.shape[0], T))
        hist = teng.lane_batch_loop(ENV, static_cfg, T, names, n, algo,
                                    "cpu")(vals, seeds_flat, noise=noise,
                                           theta0=np.stack(theta0))
        for i, (scn, cfg, _) in enumerate(members):
            want, rows = ref[scn], slice(i * len(seeds),
                                         (i + 1) * len(seeds))
            np.testing.assert_array_equal(np.cumsum(np.where(
                hist["coins"][rows], cfg.N, cfg.B), -1), want["samples"])
            np.testing.assert_allclose(hist["returns"][rows],
                                       want["returns"], atol=1e-5)
            np.testing.assert_allclose(hist[carry][rows],
                                       np.asarray(want[carry]), atol=1e-5)
            if "diameter" in want:
                np.testing.assert_allclose(hist["diameter"][rows],
                                           want["diameter"], atol=1e-3)


# ---------------------------------------------------------------------------
# The sweep's lane groups and manifest
# ---------------------------------------------------------------------------

SWEEP_BASE = dict(K=3, n_byz=1, N=4, B=2, kappa=1, hidden=(4,))
SWEEP_AXES = {"eta": (5e-3, 1e-2), "attack": ("none", "sign_flip")}


def test_sweep_manifest_has_the_reference_entries(tmp_path):
    """A sweep with a traced axis writes one entry per lane group, with
    the reference's fields: lanes, rows, n_pad, the signature
    ``f"{static_cfg!r}|{names!r}"`` and the scenario names, as the
    reference's ``lane_groups`` gives them."""
    out = str(tmp_path / "s")
    res = SweepRunner(algo="decbyzpg", env=ENV_SPEC, T=T, seeds=(0, 1, 2),
                      axes=SWEEP_AXES, windows=2, out_dir=out,
                      device="cpu", **SWEEP_BASE).run()
    with open(os.path.join(out, mf.MANIFEST)) as f:
        groups = json.load(f)["groups"]
    _, jscn = jeng.grid_scenarios(
        jeng.ScenarioGrid(seeds=(0, 1, 2), axes=SWEEP_AXES), base=SWEEP_BASE)
    want = [{"gid": gi, "signature": f"{s!r}|{n!r}", "lanes": len(m),
             "rows": 3 * len(m), "n_pad": 3 * len(m),
             "scenarios": [jeng.ExperimentResult.scenario_name(x)
                           for x, _, _ in m]}
            for gi, ((s, n), m) in enumerate(jeng.lane_groups(jscn).items())]
    assert groups == want and len(groups) == 2
    ref = teng.run_grid(ENV, teng.ScenarioGrid(seeds=(0, 1, 2),
                                               axes=SWEEP_AXES), T,
                        device="cpu", **SWEEP_BASE)
    for scn, r in ref.items():
        np.testing.assert_array_equal(res[tuple(scn)]["returns"],
                                      r["returns"])
        np.testing.assert_array_equal(res[tuple(scn)]["theta"], r["theta"])


def test_sweep_refuses_a_per_scenario_manifest(tmp_path):
    """A directory whose manifest has the earlier one-scenario groups is
    refused with SweepMismatch, not resumed wrongly."""
    out = str(tmp_path / "old")
    kw = dict(algo="decbyzpg", env=ENV_SPEC, T=T, seeds=(0, 1),
              axes=SWEEP_AXES, windows=2, out_dir=out, device="cpu",
              **SWEEP_BASE)
    runner = SweepRunner(**kw)
    _, scenarios = teng.grid_scenarios(
        teng.ScenarioGrid(seeds=(0, 1), axes=SWEEP_AXES), base=SWEEP_BASE)
    entries = [{"gid": gi, "signature": repr(dataclasses.replace(cfg,
                                                                  seed=0)),
                "lanes": 1, "rows": 2, "n_pad": 2,
                "scenarios": [teng.ExperimentResult.scenario_name(scn)]}
               for gi, (scn, cfg) in enumerate(scenarios)]
    mf.load_or_init(out, mf.build_manifest(
        runner._meta(), teng.window_slices(T, 2), entries))
    with pytest.raises(SweepMismatch, match="group count: 4 != 2"):
        SweepRunner(**kw).run()


# ---------------------------------------------------------------------------
# The lane functions over two gloo ranks
# ---------------------------------------------------------------------------

RANK_GRID = dict(seeds=(0, 1, 2), axes={"eta": (1e-2,)})
RANK_BASE = dict(K=3, n_byz=1, attack="large_noise(sigma=3)", N=4, B=2,
                 kappa=1, hidden=(4,))


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    """One of two gloo ranks: the lane mesh's row arithmetic, a spanning
    ``run_grid(lanes=True)`` over 3 rows (padded to 4), and a span sweep
    stopped after its first window."""
    torch.set_num_threads(1)
    sharding.init_distributed(f"localhost:{port}", 2, rank, timeout_s=240,
                              device="cpu")
    mesh = sharding.lane_mesh(spanning=True)
    facts = {"mesh": tuple(mesh), "local": sharding.lane_mesh(),
             "padded": sharding.padded_rows(mesh, 3),
             "block": sharding.lane_sharding(mesh, 4),
             "odd": sharding.lane_sharding(mesh, 3),
             "out": sharding.lane_out_sharding(mesh, 4),
             "spans": sharding.spans_processes(mesh),
             "global": sharding.global_rows(mesh, np.arange(4)).tolist()}
    with sharding.use_lane_mesh(mesh):
        res = teng.run_grid(ENV, teng.ScenarioGrid(**RANK_GRID), T,
                            device="cpu", **RANK_BASE)
    facts["grid"] = {tuple(s): {k: r[k] for k in ("returns", "theta",
                                                  "diameter")}
                     for s, r in res.items()}
    paused = SweepRunner(algo="decbyzpg", env=ENV_SPEC, T=4, seeds=(0, 1),
                         axes=SWEEP_AXES, windows=2, device="cpu",
                         out_dir=os.path.join(out_dir, "span"), mode="span",
                         **SWEEP_BASE).run(max_windows=1)
    facts["paused"] = paused is None
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(facts, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def rank_procs(tmp_path_factory):
    """Start the two ranks when the module starts, so they run beside the
    module's other tests; :func:`two_ranks` collects them."""
    out = str(tmp_path_factory.mktemp("lanes_ranks"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, here]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_lanes as t; "
         "t._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])",
         str(r), str(port), out], env=env, cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def two_ranks(rank_procs):
    out, procs = rank_procs
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-3000:]
    facts = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            facts.append(pickle.load(f))
    return out, facts


def test_lane_mesh_rows_over_two_ranks(two_ranks):
    _, (f0, f1) = two_ranks
    assert f0["mesh"] == (2, 0) and f1["mesh"] == (2, 1)
    assert f0["local"] is None and f0["spans"] and f1["spans"]
    assert f0["padded"] == f1["padded"] == 4
    assert f0["block"] == range(0, 2) and f1["block"] == range(2, 4)
    assert f0["odd"] is None and f0["out"] == range(4)
    assert f0["global"] == [0, 1] and f1["global"] == [2, 3]
    assert sharding.lane_mesh() is None and sharding.padded_rows(None, 3) == 3


def test_spanning_run_grid_equals_one_process(two_ranks):
    """Each rank runs its block of the 4 (padded) rows and ends with every
    row: both ranks hold the one-process grid, bit for bit."""
    _, facts = two_ranks
    ref = teng.run_grid(ENV, teng.ScenarioGrid(**RANK_GRID), T,
                        device="cpu", **RANK_BASE)
    for f in facts:
        for scn, r in ref.items():
            for k in ("returns", "theta", "diameter"):
                np.testing.assert_array_equal(f["grid"][tuple(scn)][k],
                                              r[k], err_msg=k)


def test_span_sweep_resumed_by_one_local_process(two_ranks):
    """A lane-grouped sweep stopped under ``span`` after one window, then
    resumed by one ``local`` process, equals ``run_grid(lanes=True)``."""
    out, facts = two_ranks
    assert all(f["paused"] for f in facts)
    res = SweepRunner.resume(os.path.join(out, "span"), mode="local",
                             device="cpu").run()
    ref = teng.run_grid(ENV, teng.ScenarioGrid(seeds=(0, 1),
                                               axes=SWEEP_AXES), 4,
                        device="cpu", **SWEEP_BASE)
    for scn, r in ref.items():
        for k in ("returns", "theta", "diameter", "samples"):
            np.testing.assert_array_equal(res[tuple(scn)][k], r[k],
                                          err_msg=k)
