"""The port's experiment engine against the JAX package's: scenario
construction, summaries and the result object on the same inputs, and
``run_grid`` seed by seed against the single runs (both algorithms)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.decbyzpg import DecByzPGConfig as JDecConfig  # noqa: E402

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.byzpg import ByzPGConfig, run_byzpg  # noqa: E402
from repro_torch.core.decbyzpg import (DecByzPGConfig,  # noqa: E402
                                       run_decbyzpg)
from repro_torch.rl.envs import make_cartpole  # noqa: E402

torch.set_num_threads(2)


def _kappa_by_k(c):
    return dataclasses.replace(c, kappa=4 if c.K > 1 else 0)


def _kappa_by_aggregator(c):
    return dataclasses.replace(
        c, kappa=0 if c.aggregator.name == "mean" else 4)


def _mutates_k(c):
    return dataclasses.replace(c, K=c.K + 1)


# (algo, grid kwargs, base, override): the legacy default axes, a base that
# pins a legacy axis, fig1's K axis with its override, fig2's and fig5's
# attack × aggregator grids
GRIDS = {
    "legacy_defaults": ("decbyzpg", dict(), dict(N=20, B=4), None),
    "legacy_k_pinned_n_byz": ("decbyzpg", dict(K=(5, 13)), dict(n_byz=1),
                              None),
    "byzpg_legacy_drops_agreement": ("byzpg", dict(K=(4, 13)),
                                     dict(eta=2e-2), None),
    "fig1": ("decbyzpg", dict(axes={"K": (1, 5, 13)}),
             dict(N=20, B=4, eta=2e-2), _kappa_by_k),
    "fig2": ("decbyzpg", dict(axes={
        "attack": ("random_action", "large_noise", "avg_zero"),
        "aggregator": ("rfa", "mean")}),
        dict(K=13, n_byz=3, N=20, B=4, eta=2e-2), _kappa_by_aggregator),
    "fig5": ("byzpg", dict(axes={"attack": ("large_noise", "avg_zero"),
                                 "aggregator": ("rfa", "mean")}),
             dict(K=13, n_byz=3, N=20, B=4, eta=2e-2), None),
    "mixed_eta_and_legacy": ("byzpg", dict(n_byz=(0, 3), axes={
        "eta": (1e-3, 5e-3)}), dict(), None),
}


def _canon(v):
    return v.canonical() if hasattr(v, "canonical") else v


def _scenarios(mod, algo, grid_kw, base, override):
    grid = mod.ScenarioGrid(seeds=(0,), **grid_kw)
    axes, scns = mod.grid_scenarios(grid, algo=algo, override=override,
                                    base=base)
    return ({k: [_canon(v) for v in vals] for k, vals in axes.items()},
            [(key._fields, tuple(_canon(v) for v in key),
              type(cfg).__name__,
              {f.name: _canon(getattr(cfg, f.name))
               for f in dataclasses.fields(cfg)}) for key, cfg in scns])


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_scenarios_match_reference(name):
    algo, grid_kw, base, override = GRIDS[name]
    assert _scenarios(teng, algo, grid_kw, base, override) == \
        _scenarios(jeng, algo, grid_kw, base, override)


@pytest.mark.parametrize("algo, grid_kw, base, override, error", [
    ("byzpg", dict(axes={"kappa": (1, 2)}), {}, None, TypeError),
    ("decbyzpg", dict(), {"not_a_field": 1}, None, TypeError),
    ("decbyzpg", dict(axes={"K": (5,)}), {"K": 5}, None, TypeError),
    ("decbyzpg", dict(axes={"K": (5, 13)}), {}, _mutates_k, ValueError),
], ids=["unknown_axis", "unknown_base", "swept_and_fixed",
        "override_mutates_axis"])
def test_grid_scenarios_raise_like_reference(algo, grid_kw, base, override,
                                             error):
    for mod in (jeng, teng):
        with pytest.raises(error) as err:
            _scenarios(mod, algo, grid_kw, base, override)
        if mod is jeng:
            ref_msg = str(err.value)
    assert str(err.value) == ref_msg


def _histories(seed, S=3, T=6, K=5, d=7, diameter=True, rejected=True):
    rng = np.random.default_rng(seed)
    hist = {"returns": rng.standard_normal((S, T)).astype(np.float32) * 20,
            "coins": rng.random((S, T)) < 0.3,
            "theta": rng.standard_normal((S, K, d)).astype(np.float32)}
    hist["coins"][:, 0] = True
    if diameter:
        hist["diameter"] = rng.random((S, T)).astype(np.float32)
    if rejected:
        hist["grad_norm"] = rng.random((S, T)).astype(np.float32)
        hist["rejected"] = rng.random((S, T, K)) < 0.4
    return hist


def _assert_same(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("S, diameter, rejected", [
    (3, True, True), (3, False, False), (1, True, False), (4, False, True)])
def test_summarize_matches_reference(S, diameter, rejected):
    hist = _histories(S, S=S, diameter=diameter, rejected=rejected)
    tcfg, jcfg = DecByzPGConfig(N=20, B=4, n_byz=2), JDecConfig(N=20, B=4,
                                                                n_byz=2)
    _assert_same(teng.summarize(dict(hist), tcfg),
                 jeng.summarize(dict(hist), jcfg))


def _results(mod, keys, telemetry):
    cfg = (DecByzPGConfig if mod is teng else JDecConfig)(N=20, B=4,
                                                          n_byz=2)
    return {key: mod.summarize(_histories(i, rejected=telemetry), cfg)
            for i, key in enumerate(keys)}


@pytest.mark.parametrize("telemetry", [False, True])
def test_experiment_result_matches_reference(telemetry):
    axes = {"attack": ("large_noise", "avg_zero"),
            "aggregator": ("rfa", "mean")}
    meta = {"algo": "byzpg", "env": "cartpole(horizon=100)", "T": 6,
            "seeds": [0, 1, 2], "axes": {k: list(v) for k, v in axes.items()},
            "base": {"K": 13}, "override": None}
    docs, sels = [], []
    for mod in (teng, jeng):
        key = mod.scenario_key(axes)
        keys = [key(a, g) for a in axes["attack"] for g in axes["aggregator"]]
        res = mod.ExperimentResult(meta, axes, _results(mod, keys, telemetry))
        docs.append((res.to_json(), res.to_json(curves=False),
                     res.summary(), [res.scenario_name(k) for k in keys],
                     mod.ExperimentResult.scenario_name(())))
        picked = res.sel(attack="avg_zero", aggregator="rfa")
        sels.append(picked["final_return_mean"])
        msgs = []
        for query in (dict(attack="avg_zero"), dict(attack="alie"),
                      dict(K=13)):
            with pytest.raises(KeyError) as err:
                res.sel(**query)
            msgs.append(str(err.value))
        docs.append(msgs)
    assert docs[0] == docs[2] and docs[1] == docs[3]
    assert sels[0] == sels[1]
    assert "attack=avg_zero,aggregator=rfa" in docs[0][2]


def test_experiment_meta_matches_reference(monkeypatch):
    """The Experiment's own bookkeeping (meta, axes, seeds), both packages'
    grids replaced by an empty run."""
    monkeypatch.setattr(teng, "run_grid", lambda *a, **k: {})
    monkeypatch.setattr(jeng, "run_grid", lambda *a, **k: {})
    kw = dict(algo="decbyzpg", env="cartpole(horizon=100)", T=15, seeds=3,
              axes={"K": [1, 5, 13]}, override=_kappa_by_k, N=20, B=4,
              eta=2e-2, attack="large_noise(sigma=10)")
    ours = teng.Experiment(device="cpu", **kw)
    ref = jeng.Experiment(**kw)
    assert ours.to_json() == ref.to_json()
    assert ours.seeds == ref.seeds == (0, 1, 2)


def _small(algo):
    if algo == "byzpg":
        return ByzPGConfig, run_byzpg, dict(
            K=5, n_byz=1, attack="large_noise(sigma=10)", N=4, B=2,
            hidden=(8,), eta=2e-2)
    return DecByzPGConfig, run_decbyzpg, dict(
        K=5, n_byz=1, attack="large_noise(sigma=10)", N=4, B=2, hidden=(8,),
        kappa=1, eta=2e-2)


@pytest.mark.parametrize("algo, axes", [
    ("byzpg", {"aggregator": ("rfa", "mean")}),
    ("decbyzpg", {"aggregator": ("rfa", "krum")})])
def test_run_grid_seed_histories_equal_single_runs(algo, axes):
    cfg_cls, run, base = _small(algo)
    env = make_cartpole(horizon=12)
    T, seeds = 3, (0, 2)
    grid = teng.ScenarioGrid(seeds=seeds, axes=axes)
    res = teng.run_grid(env, grid, T, algo=algo, device="cpu", **base)
    carry = "vec" if algo == "byzpg" else "theta"
    assert len(res) == 2
    for scn, out in res.items():
        cfg = cfg_cls(**base, **scn._asdict())
        assert out["returns"].shape == (len(seeds), T)
        for i, s in enumerate(seeds):
            single = run(env, dataclasses.replace(cfg, seed=s), T,
                         device="cpu")
            np.testing.assert_array_equal(out["returns"][i],
                                          single["returns"])
            np.testing.assert_array_equal(out["samples"][i],
                                          single["samples"])
            np.testing.assert_array_equal(out[carry][i],
                                          single[carry].numpy())
            if "diameter" in single:
                np.testing.assert_array_equal(out["diameter"][i],
                                              single["diameter"])
        assert ("final_diameter_mean" in out) == (algo == "decbyzpg")


def test_experiment_run_caches_and_force_reruns(monkeypatch):
    calls = []
    real = teng.run_grid

    def counting(*a, **k):
        calls.append(k["device"])
        return real(*a, **k)

    monkeypatch.setattr(teng, "run_grid", counting)
    _, _, base = _small("byzpg")
    exp = teng.Experiment(algo="byzpg", env="cartpole(horizon=8)", T=2,
                          seeds=(1,), axes={"aggregator": ("mean",)},
                          device="cpu", **base)
    first = exp.run()
    assert exp.run() is first and exp.summary() == first.summary()
    again = exp.run(force=True)
    assert again is not first and calls == ["cpu", "cpu"]
    (scn, out), = again.items()
    np.testing.assert_array_equal(out["returns"], first[scn]["returns"])


def test_experiment_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, base = _small("byzpg")
    exp = teng.Experiment(algo="byzpg", env="cartpole(horizon=4)", T=1,
                          seeds=1, **base)
    with pytest.raises(RuntimeError, match="CUDA"):
        exp.run()
