"""The whole slice: the port's ``run_decbyzpg`` against the JAX package's,
fed the reference's own θ₀ and draws (replayed from its key tree), plus the
port's boundaries (no JAX, no implicit CPU)."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import decbyzpg as jdb  # noqa: E402
from repro.core import engine  # noqa: E402
from repro.core.tree import ravel  # noqa: E402
from repro.kernels import dispatch  # noqa: E402
from repro.rl.envs import make_cartpole as jax_cartpole  # noqa: E402
from repro.rl.policy import resolve_policy  # noqa: E402

from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import decbyzpg as tdb  # noqa: E402
from repro_torch.kernels.krum_score import krum_score  # noqa: E402
from repro_torch.rl.envs import make_cartpole  # noqa: E402

from torch_parity import replay_step_noise  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 5
# tests/test_topology.py's BASE with MDA, and a bucketing configuration:
# K=7, n_byz=1 gives Lemma-3 buckets of int(0.5 / (1/7)) = 3; on a ring
# each receiver selects among its own neighbourhood (where the Byzantine
# agent equivocates per receiver), so the diameter does not collapse to 0
BASE = dict(K=6, n_byz=1, attack="sign_flip", aggregator="rfa",
            agreement="mda", kappa=2, N=4, B=2, eta=1e-2, hidden=(8,),
            seed=3)
BUCKETED = dict(BASE, K=7, attack="large_noise(sigma=10)",
                per_receiver=True, topology="ring(k=4)")
# Krum (K=6, n_byz=1: Lemma 3 gives buckets of int(0.25 / (1/6)) = 1, so
# no bucketing, n_near = 3) with cwtm (n_trim = 1 of 6) under a consistent
# attack: the fused gossip_reduce path; and the trimmed mean with cwmed
# under per-receiver noise on a ring: the neighbor_reduce path
KRUM_CWTM = dict(BASE, aggregator="krum", agreement="cwtm")
TM_CWMED = dict(BUCKETED, aggregator="trimmed_mean", agreement="cwmed")
#: Krum's scores agree with the reference's to this share of the largest
SCORE_RTOL = 1e-5


def _jax_run(env, cfg):
    """The reference's fused loop, traced under ``pallas-interpret`` so its
    RFA runs in Gram space as the port's does. ``fused_decbyzpg`` caches by
    a key that ignores the backend, so the loop is jitted here."""
    ks = engine.seed_keys(cfg.seed)
    carry = jdb.init_decbyzpg_carry(env, cfg, ks.init)
    with dispatch.use_backend("pallas-interpret"):
        loop = jax.jit(jdb.build_decbyzpg_loop(env, cfg, T))
        hist = loop(*carry, jax.random.split(ks.loop, T), ks.coin)
    theta0 = np.array(ravel(resolve_policy(cfg, env).init(ks.init))[0])
    return jax.device_get(hist), theta0


@pytest.mark.parametrize("kw", [BASE, BUCKETED, KRUM_CWTM, TM_CWMED],
                         ids=["mda", "bucketing", "krum_cwtm",
                              "tm_cwmed_per_receiver"])
def test_run_decbyzpg_matches_jax(kw, monkeypatch):
    jenv = jax_cartpole(horizon=32)
    jcfg = jdb.DecByzPGConfig(**kw)
    hist, theta0 = _jax_run(jenv, jcfg)
    tcfg = tdb.DecByzPGConfig(**kw)
    noise = replay_step_noise(jenv, jcfg, theta0.shape[0], T)
    scores = []

    def recording_scores(g, n_near):
        scores.append(krum_score(g, n_near))
        return scores[-1]

    monkeypatch.setattr(tagg, "krum_score", recording_scores)
    out = tdb.run_decbyzpg(make_cartpole(horizon=32), tcfg, T,
                           device="cpu", theta0=theta0, noise=noise)
    # Krum's argmin is discontinuous: each step's winner must beat the
    # runner-up by more than the scores' tolerance, or rounding could swap
    # them and θ would differ by a whole gradient
    assert len(scores) == (T if kw["aggregator"] == "krum" else 0)
    for s in scores:
        top = torch.sort(s, dim=1).values
        assert (top[:, 1] - top[:, 0]).min() > SCORE_RTOL * top.abs().max()
    # the same draws and θ₀: the coins are the same bits and the rollouts
    # pick the same actions; what differs is f32 summation order (the
    # gradients' sums over M·H terms, the Gram products, the Weiszfeld
    # sums), which five Adam steps carry into θ at the 1e-6 level
    np.testing.assert_array_equal(out["coins"], np.asarray(hist["coins"]))
    np.testing.assert_allclose(out["returns"], hist["returns"], rtol=1e-5)
    np.testing.assert_allclose(out["theta"].numpy(), hist["theta"],
                               atol=1e-5)
    # both sides take Δ² from the Gram identity G_ii + G_jj − 2 G_ij, which
    # loses up to a few ulps of max‖θ_i‖² to cancellation in either order
    sq = float(np.max(np.sum(np.square(hist["theta"]), axis=1)))
    np.testing.assert_allclose(out["diameter"] ** 2, hist["diameter"] ** 2,
                               atol=8 * np.finfo(np.float32).eps * sq)
    assert out["samples"].tolist() == np.cumsum(
        np.where(hist["coins"], jcfg.N, jcfg.B)).tolist()


def test_seeded_run_is_deterministic_and_starts_with_coin():
    cfg = tdb.DecByzPGConfig(K=4, n_byz=1, attack="large_noise(sigma=10)",
                             kappa=1, N=3, B=2, hidden=(4,))
    env = make_cartpole(horizon=8)
    a = tdb.run_decbyzpg(env, cfg, 3, device="cpu")
    b = tdb.run_decbyzpg(env, cfg, 3, device="cpu")
    assert a["coins"][0]
    np.testing.assert_array_equal(a["returns"], b["returns"])
    assert torch.equal(a["theta"], b["theta"])
    assert [p["w"].shape for p in a["params"]] == [(4, 4), (4, 2)]
    c = tdb.run_decbyzpg(env, dataclasses.replace(cfg, seed=1), 3,
                         device="cpu")
    assert not torch.equal(a["theta"], c["theta"])


def test_config_fields_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(tdb.DecByzPGConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jdb.DecByzPGConfig)}
    assert ours == ref
    # telemetry observes only: the same run with it on returns the same
    # bits, plus one rejected mask and gradient norm per iteration
    cfg = tdb.DecByzPGConfig(K=4, n_byz=1, attack="sign_flip", kappa=1,
                             N=3, B=2, hidden=(4,))
    env = make_cartpole(horizon=8)
    off = tdb.run_decbyzpg(env, cfg, 2, device="cpu")
    on = tdb.run_decbyzpg(env, dataclasses.replace(cfg, telemetry=True), 2,
                          device="cpu")
    for k in ("returns", "coins", "diameter"):
        np.testing.assert_array_equal(on[k], off[k])
    assert torch.equal(on["theta"], off["theta"])
    assert on["rejected"].shape == (2, 4) and on["grad_norm"].shape == (2,)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = make_cartpole(horizon=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdb.run_decbyzpg(env, tdb.DecByzPGConfig(K=2, N=2, B=1), 1)


def test_port_imports_no_jax():
    """Every module of the port imports without ``jax`` or ``repro``, the
    serving slice's and the ByzPG, engine, obs and checkpoint modules
    among them (the analysis suite too), and no import statement in the
    port, in ``chip_smoke.py`` or in ``tools/`` names either (the smoke
    script and the profilers import the port inside their functions)."""
    serving = ["repro_torch.configs.base", "repro_torch.configs.qwen2_7b",
               "repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.model",
               "repro_torch.kernels.flash_attention.flash_attention",
               "repro_torch.kernels.flash_attention.ops",
               "repro_torch.distributed.serving",
               "repro_torch.serving.engine", "repro_torch.serving.server",
               "repro_torch.serving.scheduler", "repro_torch.serving.traffic",
               "repro_torch.rl.transformer_policy",
               "repro_torch.launch.serve",
               "repro_torch.core.byzpg", "repro_torch.core.page",
               "repro_torch.core.engine", "repro_torch.obs",
               "repro_torch.obs.metrics", "repro_torch.obs.sinks",
               "repro_torch.obs.trace", "repro_torch.obs.manifest",
               "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
               "repro_torch.analysis", "repro_torch.analysis.findings",
               "repro_torch.analysis.lint", "repro_torch.analysis.keycheck",
               "repro_torch.analysis.retrace",
               "repro_torch.analysis.donation",
               "repro_torch.analysis.memcheck",
               "repro_torch.analysis.__main__"]
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        f"missing = set({serving!r}) - set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 50, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import ast
    import glob
    files = (glob.glob(os.path.join(REPO, "src", "repro_torch", "**",
                                    "*.py"), recursive=True)
             + [os.path.join(REPO, "chip_smoke.py")]
             + glob.glob(os.path.join(REPO, "tools", "*.py")))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, m)
