"""The port's windowed, resumable sweep service on the CPU: window slicing
and the LPT schedule against the JAX package's, windowed sweeps and
kill-and-resume against the port's one-shot ``run_grid`` bit for bit,
resume accounting, manifest validation, the telemetry records, a carry
checkpoint with its generator state, and the port's windows against the
reference's ``seed_window_loop`` chain under replayed noise."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import byzpg as jbz  # noqa: E402
from repro.core import decbyzpg as jdb  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.rl.envs import make_cartpole as jax_cartpole  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.core import byzpg as tbz  # noqa: E402
from repro_torch.core import decbyzpg as tdb  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.registry import resolve  # noqa: E402
from repro_torch.core.tree import tree_map, tree_paths  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.rl.envs import make_cartpole  # noqa: E402
from repro_torch.sweep import (SweepError, SweepMismatch,  # noqa: E402
                               SweepRunner)
from repro_torch.sweep import runner as trunner  # noqa: E402

from torch_parity import (replay_byzpg_noise,  # noqa: E402
                          replay_step_noise)

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

ENV_SPEC = "cartpole(horizon=20)"
ENV = make_cartpole(horizon=20)
T = 6
SEEDS = (0, 1)

DEC_KW = dict(K=3, n_byz=1, N=4, B=2, kappa=2, hidden=(8,))
DEC_AXES = {"eta": (1e-2, 5e-3),
            "attack": ("none", "large_noise(sigma=10)")}
BYZ_KW = dict(K=3, n_byz=1, attack="large_noise(sigma=10)", N=4, B=2,
              hidden=(8,))
BYZ_AXES = {"eta": (1e-2, 2e-2), "aggregator": ("rfa", "trimmed_mean")}
GRIDS = {"decbyzpg": (DEC_AXES, DEC_KW), "byzpg": (BYZ_AXES, BYZ_KW)}
#: what a summary holds per scenario (seed histories, curves, scalars)
_ARRAYS = ("returns", "samples", "returns_mean", "returns_ci95",
           "diameter", "diameter_mean")
_SCALARS = ("final_return_mean", "final_return_ci95",
            "final_diameter_mean")


def _runner(algo, axes=None, **kw):
    grid_axes, base = GRIDS[algo]
    return SweepRunner(algo=algo, env=ENV_SPEC, T=T, seeds=SEEDS,
                       axes=axes or grid_axes, device="cpu",
                       **{**base, **kw})


def _grid(algo, axes=None, **kw):
    grid_axes, base = GRIDS[algo]
    grid = teng.ScenarioGrid(seeds=SEEDS, axes=axes or grid_axes)
    return teng.run_grid(ENV, grid, T, algo=algo, device="cpu",
                         **{**base, **kw})


def _assert_results_equal(res, ref, algo="decbyzpg"):
    """res: ExperimentResult from the sweep; ref: a run_grid dict. Every
    history, curve and scalar bit for bit."""
    carry = resolve("algo", algo).carry_hist
    assert [tuple(s) for s in res.keys()] == [tuple(s) for s in ref]
    for scn in ref:
        got, want = res[tuple(scn)], ref[scn]
        assert set(got) == set(want)
        for k in (*_ARRAYS, carry):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k])
        for k in _SCALARS:
            if k in want:
                assert got[k] == want[k]


# ---------------------------------------------------------------------------
# window_slices and host_assignment: the reference's own
# ---------------------------------------------------------------------------


def test_window_slices_match_reference():
    for T_ in range(1, 41):
        for W in range(1, T_ + 1):
            assert teng.window_slices(T_, W) == jeng.window_slices(T_, W)
        for bad in (0, T_ + 1):
            with pytest.raises(ValueError) as ours:
                teng.window_slices(T_, bad)
            with pytest.raises(ValueError) as ref:
                jeng.window_slices(T_, bad)
            assert str(ours.value) == str(ref.value)


def test_host_assignment_matches_reference_and_row_blocks_cover():
    rng = np.random.default_rng(7)
    for _ in range(50):
        costs = rng.integers(1, 100, size=rng.integers(1, 12)).tolist()
        for n in range(1, 6):
            assert tshard.host_assignment(costs, n) == \
                jshard.host_assignment(costs, n)
    for rows in range(0, 9):
        for n in range(1, 5):
            blocks = [tshard.row_block(rows, n, p) for p in range(n)]
            assert [r for b in blocks for r in b] == list(range(rows))
            assert max(map(len, blocks)) - min(map(len, blocks)) <= 1


# ---------------------------------------------------------------------------
# Windowed == one-shot, kill-and-resume == uninterrupted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [1, 3, T])
@pytest.mark.parametrize("algo", ["decbyzpg", "byzpg"])
def test_sweep_windows_equal_run_grid(algo, W):
    _assert_results_equal(_runner(algo, windows=W).run(), _grid(algo), algo)


@pytest.mark.parametrize("stop", [3, 4], ids=["group_boundary", "mid_T"])
@pytest.mark.parametrize("algo", ["decbyzpg", "byzpg"])
def test_sweep_kill_and_resume_bit_identical(tmp_path, algo, stop):
    """Preempted after ``stop`` windows (3 windows a group: the end of
    group 0, or the first window of group 1), then resumed by a runner
    rebuilt from the manifest alone."""
    out = str(tmp_path / "sweep")
    assert _runner(algo, windows=3, out_dir=out).run(max_windows=stop) \
        is None
    res = SweepRunner.resume(out, device="cpu").run()
    _assert_results_equal(res, _grid(algo), algo)
    assert (tmp_path / "sweep" / "summary.json").exists()


def test_sweep_resume_skips_completed_groups(tmp_path, monkeypatch):
    out = str(tmp_path / "sweep")
    axes = {"attack": ("none", "sign_flip")}
    runner = SweepRunner(algo="decbyzpg", env=ENV_SPEC, T=T, seeds=SEEDS,
                         axes=axes, windows=2, out_dir=out, device="cpu",
                         **DEC_KW)
    assert runner.run(max_windows=2) is None    # group 0 done, group 1 not
    inits = []
    real = teng.seed_generator
    monkeypatch.setattr(teng, "seed_generator",
                        lambda s, d: inits.append(s) or real(s, d))
    with obs.capture("sweep.window") as sink:
        res = SweepRunner.resume(out, device="cpu").run()
    assert [(r["group"], r["window"]) for r in sink.records] == \
        [(1, 0), (1, 1)]
    assert inits == list(SEEDS)                 # group 1's rows only
    _assert_results_equal(res, _grid("decbyzpg", axes=axes))


def test_sweep_finished_resume_runs_nothing(tmp_path, monkeypatch):
    """A finished sweep reloads its files: no window, no generator."""
    out = str(tmp_path / "sweep")
    first = _runner("decbyzpg", windows=2, out_dir=out).run()

    def boom(*a, **k):
        raise AssertionError("a finished sweep ran or drew something")

    monkeypatch.setattr(tdb, "window_decbyzpg", boom)
    monkeypatch.setattr(teng, "seed_generator", boom)
    monkeypatch.setattr(trunner, "_generator", boom)
    with obs.capture("sweep.window") as sink:
        res = SweepRunner.resume(out, device="cpu").run()
    assert sink.records == []
    _assert_results_equal(res, first.results)


# ---------------------------------------------------------------------------
# Manifest validation + runner argument errors
# ---------------------------------------------------------------------------


def test_sweep_manifest_mismatch_names_fields(tmp_path):
    out = str(tmp_path / "sweep")
    kw = dict(algo="decbyzpg", env=ENV_SPEC, axes={"eta": (1e-2,)},
              windows=2, out_dir=out, **DEC_KW)
    SweepRunner(T=T, seeds=SEEDS, device="cpu", **kw).run(max_windows=1)
    # another device type: "meta" holds no data, and the mismatch is
    # raised before anything runs
    clash = SweepRunner(T=T + 2, seeds=(0, 1, 2), device="meta", **kw)
    with pytest.raises(SweepMismatch) as ei:
        clash.run()
    msg = str(ei.value)
    for field in ("meta.T", "meta.seeds", "window_slices", "meta.device"):
        assert field in msg
    with pytest.raises(SweepMismatch, match="meta.device: 'cpu' != 'meta'"):
        SweepRunner.resume(out, device="meta").run()


def test_sweep_resume_recorded_override_requires_hook(tmp_path):
    out = str(tmp_path / "sweep")
    hook = lambda cfg: cfg                                  # noqa: E731
    SweepRunner(algo="decbyzpg", env=ENV_SPEC, T=T, seeds=(0,),
                axes={"eta": (1e-2,)}, windows=2, out_dir=out,
                override=hook, device="cpu", **DEC_KW).run(max_windows=1)
    with pytest.raises(SweepError, match="override"):
        SweepRunner.resume(out, device="cpu")
    assert SweepRunner.resume(out, override=hook, device="cpu").run() \
        is not None


def test_sweep_rejects_unknown_mode_and_non_persistable_axis():
    with pytest.raises(SweepError, match="mode"):
        SweepRunner(mode="galaxy", device="cpu")
    bad = SweepRunner(algo="decbyzpg", env=ENV_SPEC, T=T, seeds=(0,),
                      axes={"eta": (1e-2,)}, windows=1, hidden=(8,), K=3,
                      N=4, B=2, probe=object(), device="cpu")
    with pytest.raises(SweepError, match="persist"):
        bad._meta()


def test_sweep_shard_without_out_dir_raises(monkeypatch):
    monkeypatch.setattr(trunner, "process_count", lambda: 2)
    with pytest.raises(SweepError, match="out_dir"):
        _runner("byzpg", mode="shard").run()


# ---------------------------------------------------------------------------
# Telemetry plane: the reference's sweep.window / sweep.partial records
# ---------------------------------------------------------------------------


def test_sweep_records_have_the_reference_fields(tmp_path):
    """The fields ``repro/sweep/runner.py`` records, plus one
    ``sweep.commit`` host span per committed window."""
    obs.get_tracer().clear()
    with obs.capture() as sink:
        _runner("decbyzpg", axes={"eta": (1e-2, 5e-3)}, windows=3,
                out_dir=str(tmp_path / "s")).run()
    windows = [r for r in sink.records if r["stream"] == "sweep.window"]
    partials = [r for r in sink.records if r["stream"] == "sweep.partial"]
    assert all(set(w) == {"stream", "group", "window", "t_done", "T"}
               for w in windows)
    # the eta axis is traced: its two scenarios are one lane group
    assert [(w["group"], w["window"], w["t_done"]) for w in windows] == \
        [(0, w, s) for w, (_, s) in enumerate(teng.window_slices(T, 3))]
    assert all(set(p) == {"stream", "scenario", "final_return_mean",
                          "final_return_ci95"} for p in partials)
    assert [p["scenario"] for p in partials] == ["eta=0.01", "eta=0.005"]
    assert all(np.isfinite(p["final_return_mean"]) for p in partials)
    commits = [e for e in obs.get_tracer().events
               if e["name"] == "sweep.commit"]
    assert [(e["args"]["group"], e["args"]["window"]) for e in commits] == \
        [(0, w) for w in range(3)]


# ---------------------------------------------------------------------------
# A carry checkpoint with its generator state (test_checkpoint.py's
# resume-equivalence counterparts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("algo", ["decbyzpg", "byzpg"])
def test_resume_equivalence_across_checkpoint(tmp_path, algo, telemetry):
    """3 steps, save and restore the carry and the generator's state,
    3 more steps: the uninterrupted 6-step run bit for bit, whether the
    steps tap telemetry or not (taps draw nothing)."""
    env = make_cartpole(horizon=10)
    kw = dict(K=3, n_byz=1, attack="sign_flip", aggregator="krum", N=4,
              B=2, hidden=(4,), seed=3)
    if algo == "decbyzpg":
        kw["kappa"] = 2
    a = resolve("algo", algo)
    cfg = a.config_cls(**kw)
    full = a.run(env, cfg, T, device="cpu")
    cfg_t = dataclasses.replace(cfg, telemetry=telemetry)
    gen = teng.seed_generator(cfg.seed, "cpu")
    carry = a.init(env, cfg_t, gen, device="cpu")
    carry, first = a.window(env, cfg_t, carry, gen, 0, 3)
    path = str(tmp_path / "mid.npz")
    save({"carry": carry, "generator": gen.get_state()}, path)
    template = {"carry": tree_map(lambda x: torch.empty_like(
        x, device="meta"), carry), "generator": gen.get_state()}
    back = restore(template, path, device="cpu")
    for (k, got), (_, want) in zip(tree_paths(back["carry"]),
                                   tree_paths(carry)):
        assert got.dtype == want.dtype, k
        assert torch.equal(got, want), k
    assert back["carry"].opt_state.step.dtype == torch.int32
    del gen, carry                       # the resumed half starts afresh
    gen = torch.Generator()
    gen.set_state(back["generator"])
    carry, second = a.window(env, cfg_t, back["carry"], gen, 3, T)
    out = a.finish(env, cfg_t, carry, [first, second])
    for k in ("returns", "coins", "samples", "diameter"):
        if k in full:
            np.testing.assert_array_equal(out[k], full[k])
    assert torch.equal(out[a.carry_hist], full[a.carry_hist])
    assert ("rejected" in out) == telemetry


# ---------------------------------------------------------------------------
# Parity with the reference's windows under its replayed noise
# ---------------------------------------------------------------------------


PARITY = {
    "decbyzpg": (jdb.DecByzPGConfig, tdb.DecByzPGConfig, replay_step_noise,
                 dict(K=3, n_byz=1, attack="large_noise(sigma=10)",
                      aggregator="trimmed_mean", agreement="cwtm", kappa=2,
                      N=4, B=2, eta=1e-2, hidden=(8,), seed=3)),
    "byzpg": (jbz.ByzPGConfig, tbz.ByzPGConfig, replay_byzpg_noise,
              dict(K=3, n_byz=1, attack="large_noise(sigma=10)",
                   aggregator="trimmed_mean", N=4, B=2, eta=1e-2,
                   hidden=(8,), seed=3)),
}


@pytest.mark.parametrize("algo", list(PARITY))
def test_windows_match_reference_seed_window_loop(algo):
    """The reference's ``seed_window_loop`` chained over
    ``window_slices(6, 3)`` from its ``seed_init_loop`` carry, and the
    port's ``window`` chained over the same slices from the same θ₀, fed
    the reference's draws: coins equal, returns within rtol 1e-5, θ
    within 1e-5 (f32 summation order, as in the single-run parity
    tests)."""
    jcfg_cls, tcfg_cls, replay, kw = PARITY[algo]
    jenv = jax_cartpole(horizon=20)
    jcfg = jcfg_cls(**kw)
    seeds = jnp.asarray([kw["seed"]], jnp.int32)
    slices = teng.window_slices(T, 3)
    jcarry = jeng.seed_init_loop(jenv, jcfg, 1, algo)(seeds)
    theta0 = np.array(jcarry[0][0])
    chunks = []
    for start, stop in slices:
        win = jeng.seed_window_loop(jenv, jcfg, T, stop - start, 1, algo)
        jcarry, hist = win(jcarry, seeds, jnp.arange(start, stop))
        chunks.append(jax.device_get(hist))
    ref = {k: np.concatenate([c[k][0] for c in chunks]) for k in chunks[0]}
    ref_theta = np.array(jcarry[0][0])

    a = resolve("algo", algo)
    tcfg = tcfg_cls(**kw)
    noise = replay(jenv, jcfg, theta0.shape[-1], T)
    carry = a.init(ENV, tcfg, None, theta0, device="cpu")
    ours = []
    for start, stop in slices:
        carry, chunk = a.window(ENV, tcfg, carry, None, start, stop, noise)
        ours.append(chunk)
    out = a.finish(ENV, tcfg, carry, ours)
    assert ref["coins"][0] and not ref["coins"].all()
    np.testing.assert_array_equal(out["coins"], ref["coins"])
    np.testing.assert_allclose(out["returns"], ref["returns"], rtol=1e-5)
    np.testing.assert_allclose(out[a.carry_hist].numpy(), ref_theta,
                               atol=1e-5)


def test_sweep_modules_import_no_jax():
    """The sweep modules import neither ``jax`` nor ``repro``."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.sweep, repro_torch.sweep.runner\n"
            "import repro_torch.launch.sweep, repro_torch.distributed\n"
            "import repro_torch.distributed.sharding\n"
            "from repro_torch import SweepRunner, SweepError, SweepMismatch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)
