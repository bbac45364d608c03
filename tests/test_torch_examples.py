"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), and the port's public surface against ``repro``'s.

* The surface: ``repro_torch._EXPORTS`` and ``_MODULES`` hold the
  reference's, each name from the reference's module renamed, resolved
  lazily; ``tests/test_serving.py``'s ``test_public_api_surface`` on the
  port.
* The same experiment: each ``Experiment`` example's ``main`` and the
  reference's with the same flags, ``Experiment.run`` replaced in both
  packages by a stub that records the experiment and stops; their
  ``grid_scenarios`` (axes, keys, every config field after the override),
  algorithm, environment, T and seeds are equal. ``federated_llm.py`` the
  same way, stopped at the state's init: the model configuration, the
  ``FedConfig``, the ``DataConfig``, K and the Byzantine mask.
* Each example end to end on the CPU at a small depth, its report's
  numbers finite; ``topology_resilience.py``'s static columns against the
  reference's ``resolve_topology``.
* ``serve_decode.py --offline`` serving the reference example's own
  parameters (carried over by ``convert.model_params_from_jax``) gives the
  reference's token streams under the margin rule
  (``torch_parity.assert_streams_agree``).
* ``federated_llm.py --ranks 2`` prints, on rank 0, the one-process run's
  honest losses and diameters within :data:`LOSS_TOL` and
  :data:`DIAM_RTOL`.
* Draw discipline: ``federated_llm.py`` (both trainers) and
  ``serve_decode.py`` under ``keycheck.record`` with the taps of its
  inventory; ``check`` finds nothing.
* No implicit CPU, and no import of ``jax`` or ``repro``.
"""
import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.distributed import fed_trainer as jft  # noqa: E402
from repro.topology import resolve_topology as j_resolve_topology  # noqa: E402
from repro_torch.analysis import keycheck  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.distributed import fed_trainer as tft  # noqa: E402
from repro_torch.topology import resolve_topology  # noqa: E402
from torch_parity import assert_streams_agree  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "byzpg_centralized", "federation_speedup",
            "topology_resilience", "attack_strength_sweep", "serve_decode",
            "federated_llm")
#: the five ``Experiment`` examples and the flags each is compared under:
#: its defaults and a set that moves every flag it has
EXPERIMENT_FLAGS = {
    "quickstart": [[], ["--iters", "7", "--seeds", "2",
                        "--attack", "large_noise(sigma=10)"]],
    "byzpg_centralized": [[], ["--iters", "5", "--seeds", "4",
                               "--attack", "avg_zero"]],
    "federation_speedup": [[], ["--iters", "9", "--seeds", "1"]],
    "topology_resilience": [[], ["--iters", "6", "--seeds", "2",
                                 "--attack", "large_noise", "--K", "9",
                                 "--n-byz", "2"]],
    "attack_strength_sweep": [[], ["--iters", "4", "--seeds", "2",
                                   "--sigmas", "3,30"]],
}
#: each example end to end on the CPU, at a small depth
SMALL = {
    "quickstart": ["--iters", "2", "--seeds", "1"],
    "byzpg_centralized": ["--iters", "2", "--seeds", "1"],
    "federation_speedup": ["--iters", "2", "--seeds", "1"],
    "topology_resilience": ["--iters", "2", "--seeds", "1"],
    "attack_strength_sweep": ["--iters", "2", "--seeds", "1",
                              "--sigmas", "10,200"],
    "serve_decode": ["--offline", "--requests", "8"],
    "federated_llm": ["--steps", "2"],
}
#: ``--ranks 2`` against one process. rank 0 prints its own honest loss,
#: which the D-sharded route keeps within the sharded trainer test's
#: LOSS_RTOL (1e-6, tests/test_torch_sharded_aggregation.py) of the
#: one-process loss after a step: the step before the second loss moves
#: θ by at most that test's per-entry STATE_RTOL (2e-6 of max|θ|), whose
#: effect on a loss near 6.3 stays within the same relative bound. The
#: print rounds to 4 decimals, so a printed loss may sit half a unit
#: (5e-5) from the value it prints on top of that.
LOSS_TOL = 5e-5
LOSS_RTOL = 1e-6
#: the diameter: the sharded test's 1e-5 relative bound on it, plus half a
#: unit of the print's third significant digit
DIAM_RTOL = 1e-5
STEP_RE = re.compile(r"step +(\d+) coin=([NB]) honest_loss=(\S+) "
                     r"diam=(\S+)")
NUMBER_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
                       r"|\b(?:nan|inf)\b", re.IGNORECASE)


class Stop(Exception):
    """Raised by the recording stubs once the run is configured."""


def _load(folder: str, name: str, monkeypatch):
    """An example as a module (its top level run once); the path it puts
    on ``sys.path`` is undone with the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", REPO / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mod, argv, monkeypatch):
    """The reference's ``main()`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.main()


def _canon(v):
    return v.canonical() if hasattr(v, "canonical") else v


def _config(cfg) -> dict:
    return {f.name: _canon(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


#: the surface's laziness, in a fresh interpreter
LAZY = (
    "import sys, repro_torch\n"
    "subs = lambda: {m for m in sys.modules if m.startswith('repro_torch.')}\n"
    "assert subs() == set(), subs()\n"
    "repro_torch.Experiment\n"
    "assert 'repro_torch.core.engine' in subs()\n"
    "assert not {'repro_torch.serving', 'repro_torch.distributed',"
    " 'repro_torch.analysis'} & subs(), subs()\n"
    "print('lazy ok')\n")
#: each example's top level, in a fresh interpreter without ``src/`` on
#: its path and from another working directory: it must find the port
#: from its own location and import neither ``jax`` nor ``repro``
IMPORTS = (
    "import importlib.util, sys\n"
    "for name in {names!r}:\n"
    "    spec = importlib.util.spec_from_file_location(\n"
    "        name, {folder!r} + f'/{{name}}.py')\n"
    "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in"
    " ('jax', 'jaxlib', 'repro')]\n"
    "assert not bad, bad\n"
    "assert 'repro_torch' in sys.modules\n"
    "print('examples ok')\n")


class _Finished:
    def __init__(self, proc):
        self.stdout, self.stderr = proc.communicate(timeout=300)
        self.returncode = proc.returncode


@pytest.fixture(scope="module", autouse=True)
def subprocesses():
    """The module's fresh processes, started together with the module's
    first test and read as each test needs them: ``ranks`` is
    ``federated_llm.py --ranks 2 --steps 2 --device cpu``, ``lazy`` and
    ``imports`` the :data:`LAZY` and :data:`IMPORTS` scripts."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    started = {
        "ranks": subprocess.Popen(
            [sys.executable, str(REPO / "examples_torch" / "federated_llm.py"),
             "--ranks", "2", "--steps", "2", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd="/"),
        "lazy": subprocess.Popen(
            [sys.executable, "-c", LAZY], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(env, PYTHONPATH=str(REPO / "src"))),
        "imports": subprocess.Popen(
            [sys.executable, "-c", IMPORTS.format(
                names=list(EXAMPLES), folder=str(REPO / "examples_torch"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd="/")}
    done = {}

    class Results:
        def __getitem__(self, key):
            if key not in done:
                done[key] = _Finished(started[key])
            return done[key]

    try:
        yield Results()
    finally:
        for proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# ---------------------------------------------------------------------------
# The public surface
# ---------------------------------------------------------------------------


def test_surface_holds_the_reference_surface():
    for name, module in repro._EXPORTS.items():
        assert repro_torch._EXPORTS[name] == \
            "repro_torch" + module[len("repro"):], name
    assert set(repro._MODULES) <= set(repro_torch._MODULES)
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert {"SweepError", "SweepMismatch", "resolve_device"} <= \
        set(repro_torch.__all__)
    # the namespaces' own names: the reference's core (its jit-dispatch
    # harnesses left out, on purpose), rl and optim
    ref = {ns: importlib.import_module(f"repro.{ns}")
           for ns in ("core", "rl", "optim")}
    names = {"core": set(ref["core"].__all__) - {"run_byzpg_legacy",
                                                 "run_decbyzpg_legacy"}}
    for ns in ("rl", "optim"):
        names[ns] = {n for n, v in vars(ref[ns]).items()
                     if not n.startswith("_") and not inspect.ismodule(v)}
    assert len(names["core"]) == 22 and len(names["rl"]) == 13 \
        and names["optim"] == {"adam", "sgd", "get_optimizer",
                               "cosine_schedule"}
    for ns, want in names.items():
        port = importlib.import_module(f"repro_torch.{ns}")
        assert want <= set(port.__all__), (ns, want - set(port.__all__))
        for name in want:
            assert getattr(port, name) is not None, (ns, name)
    import repro_torch.core as tcore
    assert not {"run_byzpg_legacy", "run_decbyzpg_legacy"} & \
        set(tcore.__all__)
    assert not [n for ns in ("core", "rl", "optim") for n in
                importlib.import_module(f"repro_torch.{ns}").__all__
                if n.startswith("lane_")]


def test_public_api_surface():
    for name in ("Experiment", "ScenarioGrid", "run_grid", "register",
                 "resolve", "Spec", "save", "restore", "serve",
                 "get_config", "reduced", "make_env"):
        assert name in repro_torch.__all__, name
        assert getattr(repro_torch, name) is not None
    serving = importlib.import_module("repro_torch.serving")
    assert repro_torch.serve is serving.serve
    assert repro_torch.obs.progress is not None
    with pytest.raises(AttributeError):
        repro_torch.not_a_real_name
    assert dir(repro_torch) == sorted(repro_torch.__all__)


@pytest.mark.parametrize("name", sorted(repro_torch._EXPORTS))
def test_export_is_its_modules_name(name):
    module = importlib.import_module(repro_torch._EXPORTS[name])
    assert getattr(repro_torch, name) is getattr(module, name)


@pytest.mark.parametrize("name", repro_torch._MODULES)
def test_namespace_is_the_subpackage(name):
    assert getattr(repro_torch, name) is \
        importlib.import_module(f"repro_torch.{name}")


def test_surface_resolves_lazily(subprocesses):
    """``import repro_torch`` imports no subsystem; a name imports its own
    submodule on first touch, and not the serving or training stacks."""
    proc = subprocesses["lazy"]
    assert proc.returncode == 0, proc.stderr
    assert "lazy ok" in proc.stdout


# ---------------------------------------------------------------------------
# The same experiment and the same federated run as the reference
# ---------------------------------------------------------------------------


def _recorder(monkeypatch, engine):
    seen = []

    def run(self, force=False):
        seen.append(self)
        raise Stop

    monkeypatch.setattr(engine.Experiment, "run", run)
    return seen


def _grid(engine, exp):
    grid = engine.ScenarioGrid(seeds=exp.seeds, axes=exp.axes)
    axes, scns = engine.grid_scenarios(grid, algo=exp.algo,
                                       override=exp.override, base=exp.base)
    return ({k: [_canon(v) for v in vals] for k, vals in axes.items()},
            [(key._fields, tuple(_canon(v) for v in key),
              type(cfg).__name__, _config(cfg)) for key, cfg in scns])


@pytest.mark.parametrize("name, flags", [
    (name, flags) for name, sets in EXPERIMENT_FLAGS.items()
    for flags in sets])
def test_experiment_equals_the_reference(name, flags, monkeypatch):
    ours, ref = _recorder(monkeypatch, teng), _recorder(monkeypatch, jeng)
    port = _load("examples_torch", name, monkeypatch)
    with pytest.raises(Stop), contextlib.redirect_stdout(io.StringIO()):
        port.main(flags + ["--device", "cpu"])
    with pytest.raises(Stop):
        _run_reference(_load("examples", name, monkeypatch), flags,
                       monkeypatch)
    (t,), (j,) = ours, ref
    assert (t.algo.canonical(), t.env_spec, t.T, t.seeds) == \
        (j.algo.canonical(), j.env_spec, j.T, j.seeds)
    assert _grid(teng, t) == _grid(jeng, j)
    assert torch.device(t.device) == torch.device("cpu")


def _stop_at_init(monkeypatch, trainer):
    """Both inits record their arguments and stop the run there; returns
    the records. The pipeline and the Byzantine mask, made before the
    init, are read from the script's locals at the stop
    (:func:`_run_locals`)."""
    calls = []

    def stub(name):
        def init(*args, **kwargs):
            calls.append((name, args, kwargs))
            raise Stop
        return init

    for name in ("init_flat_fed_state", "init_fed_state"):
        monkeypatch.setattr(trainer, name, stub(name))
    return calls


def _run_locals(excinfo) -> dict:
    tb, found = excinfo.tb, None
    while tb is not None:
        if {"cfg", "fed", "pipe", "mask"} <= set(tb.tb_frame.f_locals):
            found = dict(tb.tb_frame.f_locals)
        tb = tb.tb_next
    assert found is not None
    return found


@pytest.mark.parametrize("flags", [
    [], ["--tree"], ["--agents", "4", "--byz", "2", "--arch", "llama3.2-1b"],
    ["--tree", "--agents", "3", "--byz", "0", "--steps", "5"]],
    ids=["flat", "tree", "flat_flags", "tree_flags"])
def test_federated_run_equals_the_reference(flags, monkeypatch):
    ours = _stop_at_init(monkeypatch, tft)
    ref = _stop_at_init(monkeypatch, jft)
    port = _load("examples_torch", "federated_llm", monkeypatch)
    with pytest.raises(Stop) as t_exc:
        port.main(flags + ["--device", "cpu"])
    with pytest.raises(Stop) as j_exc:
        _run_reference(_load("examples", "federated_llm", monkeypatch),
                       flags, monkeypatch)
    (t_name, t_args, _), = ours
    (j_name, j_args, _), = ref
    assert t_name == j_name == ("init_fed_state" if "--tree" in flags
                                else "init_flat_fed_state")
    assert dataclasses.asdict(t_args[0]) == dataclasses.asdict(j_args[0])
    assert _config(t_args[1]) == _config(j_args[1])
    assert t_args[2] == j_args[2]
    t_loc, j_loc = _run_locals(t_exc), _run_locals(j_exc)
    assert dataclasses.asdict(t_loc["pipe"].cfg) == \
        dataclasses.asdict(j_loc["pipe"].cfg)
    assert t_loc["K"] == j_loc["K"] == t_args[2]
    np.testing.assert_array_equal(t_loc["mask"].numpy(),
                                  np.asarray(j_loc["mask"]))


# ---------------------------------------------------------------------------
# End to end on the CPU
# ---------------------------------------------------------------------------


#: the scripts whose draws the module's runs record (``keycheck.record``)
RECORDED = ("federated_llm", "serve_decode")


def _taps(name: str):
    """``keycheck.record``'s taps for a script: the inventory's on the
    federated steps (``keycheck.programs``), none for serving, whose only
    draw is θ's init."""
    if name != "federated_llm":
        return ()
    return (keycheck.Tap(tft, "fed_train_step_flat", lambda a, k: a[6]),
            keycheck.Tap(tft, "fed_train_step",
                         lambda a, k: k.get("noise", a[5] if len(a) > 5
                                            else None)))


@pytest.fixture(scope="module")
def runs():
    """Each example's ``main`` at :data:`SMALL` on the CPU, and the
    federated one also on the tree trainer: (its return, its report, the
    keycheck recording of the :data:`RECORDED`). Each starts from a clear
    obs recorder, as a fresh process does."""
    from repro_torch import obs
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        cases = [(name, flags) for name, flags in SMALL.items()]
        cases.append(("federated_llm", ["--steps", "2", "--tree"]))
        for name, flags in cases:
            mod = _load("examples_torch", name, mp)
            obs.get_recorder().clear()
            buf, box = io.StringIO(), []
            run = lambda: box.append(  # noqa: E731
                mod.main(flags + ["--device", "cpu"]))
            with contextlib.redirect_stdout(buf):
                rec = keycheck.record(run, _taps(name)) \
                    if name in RECORDED else run()
            out[name, tuple(flags)] = (box[0], buf.getvalue(), rec)
    finally:
        mp.undo()
    return out


def _report(runs, name):
    return runs[name, tuple(SMALL[name])][1]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_with_finite_report(runs, name):
    text = _report(runs, name)
    numbers = [float(x) for x in NUMBER_RE.findall(text)]
    assert len(numbers) >= 5, text
    assert all(math.isfinite(x) for x in numbers), text


@pytest.mark.parametrize("name, header", [
    ("quickstart", "== DecByzPG (robust) vs Dec-PAGE-PG (naive), attack="
                   "avg_zero, 3/13 Byzantine, 1 seeds =="),
    ("byzpg_centralized", "attack=large_noise, 3/13 Byzantine (centralized, "
                          "1 seeds)"),
    ("federation_speedup", "== DecByzPG speed-up in K (alpha=0, 1 seeds); "
                           "K=1 is PAGE-PG =="),
    ("topology_resilience", "== DecByzPG topology sweep: K=13, 3 Byzantine "
                            "(avg_zero, per-receiver equivocation), 1 seeds "
                            "=="),
    ("attack_strength_sweep", "== LargeNoise strength sweep, 3/13 Byzantine, "
                              "1 seeds; 4 scenarios in 2 lane groups =="),
    ("serve_decode", "8 requests on 4 slots (offline): p50="),
    ("federated_llm", "qwen2.5-3b-reduced: K=6, 1 Byzantine (LargeNoise), "
                      "RFA + GDA(kappa=3), PAGE p=0.25 — flat (K, D=")])
def test_report_header_is_the_references(runs, name, header):
    assert header in _report(runs, name)


def test_experiment_results_cover_the_grid(runs):
    """The five ``Experiment`` examples return their results: one summary
    per scenario, T iterations of one seed."""
    for name, scenarios in (("quickstart", 2), ("byzpg_centralized", 2),
                            ("federation_speedup", 3),
                            ("topology_resilience", 4),
                            ("attack_strength_sweep", 4)):
        res = runs[name, tuple(SMALL[name])][0]
        assert len(res) == scenarios, name
        for _, out in res.items():
            assert out["returns"].shape == (1, 2), name
            assert np.isfinite(out["final_return_mean"]), name


def test_attack_sweep_lanes_equal_the_per_scenario_route(runs):
    """The sweep's two lane groups give what ``lanes=False`` gives, within
    the reference's lane tolerances (returns 1e-5, samples exact, Δ₂
    1e-3, θ 1e-5)."""
    res = runs["attack_strength_sweep",
               tuple(SMALL["attack_strength_sweep"])][0]
    per = teng.Experiment(
        algo="decbyzpg", env="cartpole(horizon=200)", T=2, seeds=1,
        axes={"attack": ("large_noise(sigma=10.0)",
                         "large_noise(sigma=200.0)"),
              "aggregator": ("rfa", "mean")},
        K=13, n_byz=3, N=20, B=4, eta=2e-2, lanes=False, device="cpu",
        override=lambda c: dataclasses.replace(
            c, kappa=0 if c.aggregator.name == "mean" else 5)).run()
    assert list(map(tuple, res)) == list(map(tuple, per))
    for scn, want in per.items():
        got = res[scn]
        np.testing.assert_allclose(got["returns"], want["returns"],
                                   atol=1e-5)
        np.testing.assert_array_equal(got["samples"], want["samples"])
        np.testing.assert_allclose(got["diameter"], want["diameter"],
                                   atol=1e-3)
        np.testing.assert_allclose(got["theta"], want["theta"], atol=1e-5)


@pytest.mark.parametrize("K", [13, 9])
def test_topology_static_columns_equal_the_reference(K, monkeypatch):
    port = _load("examples_torch", "topology_resilience", monkeypatch)
    ref = _load("examples", "topology_resilience", monkeypatch)
    assert port.TOPOLOGIES == ref.TOPOLOGIES
    for spec in port.TOPOLOGIES:
        t, j = resolve_topology(spec, K), j_resolve_topology(spec, K)
        assert t.name == j.name
        assert abs(t.density - j.density) <= 1e-6
        assert t.min_in_degree == j.min_in_degree
        assert abs(t.spectral_gap - j.spectral_gap) <= 1e-6
        for n_byz in range(K):
            assert t.tolerates(n_byz) == j.tolerates(n_byz)


def test_serving_report_serves_every_request(runs):
    report = runs["serve_decode", tuple(SMALL["serve_decode"])][0]
    assert report.n_requests == 8
    assert all(1 <= len(r.tokens) <= 16 and set(r.tokens) <= {0, 1}
               for r in report.results)
    assert "telemetry: 8 serve.request records" in \
        _report(runs, "serve_decode")


def test_serve_offline_streams_equal_the_reference(monkeypatch):
    """The reference example's own parameters (its init key, split from
    ``--seed``) served by the port's example: the reference's streams
    under the margin rule."""
    ref = _load("examples", "serve_decode", monkeypatch)
    seen = {}
    engine_for = ref.engine_for_policy

    def recording_engine(policy, params, **kw):
        seen["policy"], seen["params"] = policy, params
        return engine_for(policy, params, **kw)

    class Server(ref.PolicyServer):
        def run_offline(self, traffic, **kw):
            seen["traffic"] = traffic
            seen["report"] = super().run_offline(traffic, **kw)
            return seen["report"]

    monkeypatch.setattr(ref, "engine_for_policy", recording_engine)
    monkeypatch.setattr(ref, "PolicyServer", Server)
    flags = ["--offline", "--requests", "12"]
    _run_reference(ref, flags, monkeypatch)

    port = _load("examples_torch", "serve_decode", monkeypatch)
    env = repro_torch.make_env("cartpole(horizon=32)")
    policy = repro_torch.resolve("policy", port.policy_spec("llama3.2-1b"),
                                 env=env)
    params = model_params_from_jax(jax.tree.map(np.asarray, seen["params"]),
                                   policy.model_cfg, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        report = port.main(flags + ["--device", "cpu"], params=params)
    mine = {r.uid: r.tokens for r in report.results}
    theirs = {r.uid: r.tokens for r in seen["report"].results}
    assert sorted(mine) == sorted(theirs) == list(range(12))
    assert_streams_agree(mine, theirs, seen["policy"].model_cfg,
                         seen["params"], seen["traffic"], env.n_actions)


def test_ranks_print_the_one_process_run(runs, subprocesses):
    rows = runs["federated_llm", tuple(SMALL["federated_llm"])][0]
    proc = subprocesses["ranks"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "D-sharded over 2 gloo ranks" in proc.stdout
    printed = [m.groups() for m in STEP_RE.finditer(proc.stdout)]
    assert [int(t) for t, *_ in printed] == [0, 1]     # rank 0 prints once
    for (_, coin, loss, diam), (c, want_loss, want_diam) in zip(printed,
                                                                rows):
        assert coin == ("N" if c else "B")
        assert abs(float(loss) - want_loss) <= \
            LOSS_TOL + LOSS_RTOL * abs(want_loss)
        unit = 0.0 if want_diam == 0 else \
            0.5 * 10 ** (math.floor(math.log10(abs(want_diam))) - 2)
        assert abs(float(diam) - want_diam) <= \
            unit + DIAM_RTOL * abs(want_diam)


@pytest.mark.parametrize("key", [
    ("federated_llm", tuple(SMALL["federated_llm"])),
    ("federated_llm", ("--steps", "2", "--tree")),
    ("serve_decode", tuple(SMALL["serve_decode"]))],
    ids=["federated_flat", "federated_tree", "serve_decode"])
def test_scripts_keep_draw_discipline(runs, key):
    """The scripts' own draws: θ₀ and every step's noise from one
    generator (keycheck's ``key-reuse`` would flag a second one seeded
    alike), each step consuming its own noise."""
    _, _, rec = runs[key]
    assert rec.draws
    if key[0] == "federated_llm":
        assert len(rec.steps) == 2
    assert keycheck.check(rec, key[0]) == []


# ---------------------------------------------------------------------------
# No implicit CPU, no reference import
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_cuda(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    mod = _load("examples_torch", name, monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(SMALL[name])


def test_examples_import_no_reference(subprocesses):
    """Each example's top level, run in a fresh interpreter from another
    working directory (it finds ``src/`` from its own location), imports
    neither ``jax`` nor ``repro``."""
    proc = subprocesses["imports"]
    assert proc.returncode == 0, proc.stderr
    assert "examples ok" in proc.stdout
