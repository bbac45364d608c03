"""The port's telemetry plane and checkpoints against the JAX package's:
the confusion tally, the sinks' record layout, telemetry runs of both
algorithms (bit-identical to the runs without it, and the rejection masks
and gradient norms of the reference's own telemetry runs), and npz
archives that either package writes and the other restores."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import byzpg as jbz  # noqa: E402
from repro.core import decbyzpg as jdb  # noqa: E402
from repro.core import engine  # noqa: E402
from repro.kernels import dispatch  # noqa: E402
from repro.rl.envs import make_cartpole as jax_cartpole  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import byzpg as tbz  # noqa: E402
from repro_torch.core import decbyzpg as tdb  # noqa: E402
from repro_torch.core.registry import resolve  # noqa: E402
from repro_torch.core.tree import tree_map, tree_paths  # noqa: E402
from repro_torch.rl.envs import make_cartpole  # noqa: E402
from repro_torch.serving import policy_params  # noqa: E402

from torch_parity import replay_byzpg_noise, replay_step_noise  # noqa: E402

torch.set_num_threads(2)

T = 4
SMALL = dict(N=4, B=2, eta=1e-2, hidden=(8,), seed=5)
# (algorithm, config): Krum and the trimmed mean on ByzPG's server,
# bucketed RFA under MDA on DecByzPG, and the mean's median-distance
# scores with two honest-looking random actors (n_byz=2)
TELEMETRY = {
    "byzpg_krum": ("byzpg", dict(SMALL, K=6, n_byz=1, aggregator="krum",
                                 attack="large_noise(sigma=10)")),
    "byzpg_trimmed_mean": ("byzpg", dict(SMALL, K=6, n_byz=1,
                                         aggregator="trimmed_mean",
                                         attack="sign_flip")),
    "byzpg_mean_random_action": ("byzpg", dict(
        SMALL, K=6, n_byz=2, aggregator="mean", attack="random_action")),
    "decbyzpg_rfa_mda": ("decbyzpg", dict(
        SMALL, K=7, n_byz=1, attack="large_noise(sigma=10)", kappa=2)),
}


@pytest.mark.parametrize("shape, n_byz", [((7,), 2), ((5, 13), 3),
                                          ((2, 3, 6), 0), ((4, 6), 6)])
def test_confusion_tally_matches_reference(shape, n_byz):
    rej = np.random.default_rng(n_byz).random(shape) < 0.4
    assert tobs.confusion_tally(rej, n_byz) == \
        jobs.confusion_tally(rej, n_byz)
    assert tobs.confusion_tally(torch.from_numpy(rej), n_byz) == \
        jobs.confusion_tally(rej, n_byz)


def _ref_taps(path):
    """Three taps from inside a jitted function of the reference, into a
    MemorySink and a JsonlSink."""
    mem = jobs.MemorySink()

    @jax.jit
    def f(x, t):
        jobs.tap("byzpg", t=t, coin=t == 0, honest_return=x.sum(),
                 rejected=x > 0)
        return x

    with jobs.telemetry(mem, jobs.JsonlSink(path)):
        for t in range(3):
            f(jnp.asarray([1.5, -2.0, 0.25]) * (t + 1), jnp.int32(t))
        jax.effects_barrier()
    return mem.records


def _port_taps(path):
    mem = tobs.MemorySink()
    with tobs.telemetry(mem, tobs.JsonlSink(path)):
        for t in range(3):
            x = torch.tensor([1.5, -2.0, 0.25]) * (t + 1)
            tobs.tap("byzpg", t=np.int32(t), coin=torch.tensor(t == 0),
                     honest_return=x.sum(), rejected=x > 0)
    return mem.records


def test_sink_records_match_reference_layout(tmp_path):
    ref = _ref_taps(str(tmp_path / "ref.jsonl"))
    ours = _port_taps(str(tmp_path / "port.jsonl"))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in a:
            if k == "stream":
                assert a[k] == b[k]
                continue
            assert isinstance(a[k], np.ndarray)
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            np.testing.assert_array_equal(a[k], b[k])
    with open(tmp_path / "ref.jsonl") as f, \
            open(tmp_path / "port.jsonl") as g:
        assert g.read() == f.read()


def test_stdout_sink_and_progress(capsys):
    rec = tobs.Recorder()
    rec.record("progress", {"message": "run_grid 1/4"})
    rec.record("byzpg", {"t": np.int32(0)})
    tobs.StdoutProgressSink(streams=None).emit({"stream": "x", "v": 1})
    assert capsys.readouterr().out == "run_grid 1/4\n[x] {'v': 1}\n"
    assert len(rec.stream("byzpg")) == 1 and rec.stream("none") == []
    buf = tobs.RingBuffer(2)
    for i in range(3):
        buf.append({"i": i})
    assert [r["i"] for r in buf] == [1, 2] and buf.dropped == 1


def _run(algo, kw, env, T, **run_kw):
    if algo == "byzpg":
        return tbz.run_byzpg(env, tbz.ByzPGConfig(**kw), T, device="cpu",
                             **run_kw)
    return tdb.run_decbyzpg(env, tdb.DecByzPGConfig(**kw), T, device="cpu",
                            **run_kw)


@pytest.mark.parametrize("name", ["byzpg_krum", "decbyzpg_rfa_mda"])
def test_telemetry_run_is_bit_identical(name):
    algo, kw = TELEMETRY[name]
    env = make_cartpole(horizon=16)
    off = _run(algo, kw, env, T)
    with tobs.capture(algo) as sink:
        on = _run(algo, dict(kw, telemetry=True), env, T)
    carry = "vec" if algo == "byzpg" else "theta"
    for k in ("returns", "coins", "samples") + (
            ("diameter",) if algo == "decbyzpg" else ()):
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    assert torch.equal(on[carry], off[carry])
    assert "rejected" not in off and "grad_norm" not in off
    K = kw["K"]
    assert on["rejected"].shape == (T, K) and on["grad_norm"].shape == (T,)
    assert on["rejected"].sum(1).tolist() == [kw["n_byz"]] * T
    assert on["aggregator_confusion"] == tobs.confusion_tally(
        on["rejected"], kw["n_byz"])
    # one tap per iteration, holding what the run returns
    assert [int(r["t"]) for r in sink.records] == list(range(T))
    np.testing.assert_array_equal(
        np.stack([r["rejected"] for r in sink.records]), on["rejected"])
    np.testing.assert_array_equal(
        np.stack([r["grad_norm"] for r in sink.records]), on["grad_norm"])


def _ref_telemetry(algo, kw, T):
    """The reference's telemetry loop under ``pallas-interpret``: its
    history, its tapped records, θ₀ and the replayed draws."""
    env = jax_cartpole(horizon=16)
    mod = jbz if algo == "byzpg" else jdb
    cfg = (mod.ByzPGConfig if algo == "byzpg" else mod.DecByzPGConfig)(
        **kw, telemetry=True)
    ks = engine.seed_keys(cfg.seed)
    init = mod.init_byzpg_carry if algo == "byzpg" \
        else mod.init_decbyzpg_carry
    carry = init(env, cfg, ks.init)
    build = mod.build_byzpg_loop if algo == "byzpg" \
        else mod.build_decbyzpg_loop
    with jobs.capture(algo) as sink, dispatch.use_backend("pallas-interpret"):
        hist = jax.jit(build(env, cfg, T))(
            *carry, jax.random.split(ks.loop, T), ks.coin)
        hist = jax.device_get(hist)
        jax.effects_barrier()
    theta0 = np.array(carry[0] if algo == "byzpg" else carry[0][0])
    replay = replay_byzpg_noise if algo == "byzpg" else replay_step_noise
    return hist, sink.records, theta0, replay(env, cfg, theta0.shape[0], T)


@pytest.mark.parametrize("name", list(TELEMETRY))
def test_telemetry_matches_reference(name):
    algo, kw = TELEMETRY[name]
    hist, records, theta0, noise = _ref_telemetry(algo, kw, T)
    with tobs.capture(algo) as sink:
        out = _run(algo, dict(kw, telemetry=True), make_cartpole(horizon=16),
                   T, theta0=theta0, noise=noise)
    np.testing.assert_array_equal(out["coins"], hist["coins"])
    np.testing.assert_array_equal(out["rejected"], hist["rejected"])
    np.testing.assert_allclose(out["grad_norm"], hist["grad_norm"],
                               rtol=1e-5)
    assert out["aggregator_confusion"] == jobs.confusion_tally(
        hist["rejected"], kw["n_byz"])
    assert [list(r) for r in sink.records] == [list(r) for r in records]
    assert len(records) == T


def test_tracer_and_manifest(tmp_path):
    tracer = tobs.Tracer()
    with tracer.span("run_grid.scenario", scenario=0):
        tracer.instant("mark", n=1)
    doc = tracer.to_chrome(str(tmp_path / "trace.json"))
    assert [e["ph"] for e in doc["traceEvents"]] == ["i", "X"]
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    assert tobs.host_span("x") is tobs.named_phase("y", False)
    with tobs.telemetry():
        with tobs.host_span("engine.run"):
            pass
    assert tobs.get_tracer().events[-1]["name"] == "engine.run"
    m = tobs.build_manifest({"spec": "byzpg"})
    assert m["torch_version"] == torch.__version__ and m["spec"] == "byzpg"
    assert m["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert set(m["kernel_launch_counts"]) >= {"gram", "weiszfeld", "wsum"}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tree(rng, lib):
    """One pytree in both packages' leaves: a list of MLP layers, a nested
    dict, an int vector and a NamedTuple (an optimizer state)."""
    from repro_torch.optim.optimizers import AdamState
    arr = {"numpy": np.asarray, "torch": torch.from_numpy,
           "jax": jnp.asarray}[lib]
    layers = [{"w": rng.standard_normal((4, 3)).astype(np.float32),
               "b": rng.standard_normal(3).astype(np.float32)}
              for _ in range(2)]
    return {"params": [{k: arr(v) for k, v in layer.items()}
                       for layer in layers],
            "blocks": {"norm": arr(rng.standard_normal(5).astype(np.float32)),
                       "attn": {"wq": arr(np.arange(6, dtype=np.float32)
                                          .reshape(2, 3))}},
            "step": arr(np.arange(3, dtype=np.int32)),
            "opt": AdamState(arr(np.full((), 7, np.int32)),
                             arr(np.ones(2, np.float32)),
                             arr(np.zeros(2, np.float32)))}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_reference_archive_restores_in_port_bit_for_bit(tmp_path):
    from repro.checkpoint.ckpt import _flatten as jax_flatten
    ref = _tree(np.random.default_rng(0), "jax")
    jckpt.save(ref, str(tmp_path / "ref"))
    template = tree_map(torch.zeros_like,
                        _tree(np.random.default_rng(1), "torch"))
    got = tckpt.restore(template, str(tmp_path / "ref"), device="cpu")
    assert isinstance(got["opt"], type(template["opt"]))
    want, have = jax_flatten(ref), dict(tree_paths(got))
    assert list(have) == list(want)
    for k, arr in want.items():
        assert have[k].numpy().dtype == arr.dtype, k
        np.testing.assert_array_equal(have[k].numpy(), arr, err_msg=k)
    assert torch.equal(got["blocks"]["attn"]["wq"],
                       torch.arange(6.0).reshape(2, 3))
    assert int(got["opt"].step) == 7


def test_port_archive_restores_in_reference_bit_for_bit(tmp_path):
    tree = _tree(np.random.default_rng(2), "torch")
    tckpt.save(tree, str(tmp_path / "port.npz"))
    assert sorted(os.listdir(tmp_path)) == ["port.npz"]
    template = jax.tree.map(jnp.zeros_like,
                            _tree(np.random.default_rng(3), "jax"))
    got = jckpt.restore(template, str(tmp_path / "port"))
    for want, have in zip(_leaves(tree), _leaves(got)):
        assert want.dtype == have.dtype
        np.testing.assert_array_equal(want, have)
    with np.load(tmp_path / "port.npz") as data:
        assert sorted(data.files) == sorted([
            "blocks/attn/wq", "blocks/norm", "opt/m", "opt/step", "opt/v",
            "params/0/b", "params/0/w", "params/1/b", "params/1/w", "step"])


def test_restore_names_every_mismatched_field(tmp_path):
    tree = {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.int32),
            "c": torch.zeros(1), "gone": torch.zeros(1)}
    tckpt.save(tree, str(tmp_path / "x"))
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    jckpt.save(jtree, str(tmp_path / "y"))
    bad_t = {"a": torch.zeros(4), "b": torch.zeros(2), "c": torch.zeros(1),
             "new": torch.zeros(1)}
    bad_j = {k: jnp.asarray(v.numpy()) for k, v in bad_t.items()}
    for name in ("x", "y"):
        path = str(tmp_path / name)
        with pytest.raises(ValueError) as ours:
            tckpt.restore(bad_t, path, device="cpu")
        with pytest.raises(ValueError) as ref:
            jckpt.restore(bad_j, path)
        assert str(ours.value) == str(ref.value)
        for field in ("a: shape", "b: dtype", "new: in template",
                      "gone: in file"):
            assert field in str(ours.value)
        assert "c:" not in str(ours.value)


def test_restore_cast_dtypes(tmp_path):
    x = torch.linspace(-3, 3, 7)
    tckpt.save({"x": x}, str(tmp_path / "f"))
    for dtype in (torch.bfloat16, torch.float64):
        template = {"x": torch.empty(7, dtype=dtype, device="meta")}
        with pytest.raises(ValueError, match="cast_dtypes=True"):
            tckpt.restore(template, str(tmp_path / "f"), device="cpu")
        got = tckpt.restore(template, str(tmp_path / "f"), cast_dtypes=True,
                            device="cpu")
        assert got["x"].dtype == dtype and torch.equal(got["x"], x.to(dtype))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore({"x": torch.empty(8, dtype=torch.bfloat16)},
                      str(tmp_path / "f"), cast_dtypes=True, device="cpu")


def test_restore_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tckpt.save({"x": torch.zeros(2)}, str(tmp_path / "f"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.restore({"x": torch.zeros(2)}, str(tmp_path / "f"))


def test_policy_params_checkpoint_equals_theta(tmp_path):
    from repro.core.registry import resolve as jax_resolve
    from repro.serving import policy_params as jax_policy_params
    spec = "transformer(arch='llama3.2-1b', n_layers=2, d_model=64, n_heads=2)"
    env = resolve("env", "cartpole(horizon=32)")
    pol = resolve("policy", spec, env=env)
    gen = torch.Generator()
    gen.manual_seed(0)
    d = sum(t.numel() for _, t in tree_paths(
        policy_params(pol, key=gen, device="cpu")))
    theta = np.random.default_rng(4).standard_normal(d).astype(np.float32)
    from_theta = policy_params(pol, theta=theta, device="cpu")
    tckpt.save(from_theta, str(tmp_path / "port"))
    # the reference's own archive of the same parameters
    jpol = jax_resolve("policy", spec, env=jax_resolve(
        "env", "cartpole(horizon=32)"))
    jckpt.save(jax_policy_params(jpol, theta=theta), str(tmp_path / "ref"))
    for name in ("port", "ref"):
        got = policy_params(pol, checkpoint=str(tmp_path / name),
                            theta=np.zeros(1), device="cpu")
        flat, want = dict(tree_paths(got)), dict(tree_paths(from_theta))
        assert flat.keys() == want.keys()
        assert all(torch.equal(flat[k], want[k]) for k in want)


def test_serving_emits_request_and_gauge_records():
    """Under ``obs.telemetry`` the server records one ``serve.request`` per
    request and a ``serve.gauge`` per loop turn, with the reference's
    fields; off, it records nothing."""
    from repro_torch.serving import serve
    kw = dict(key=0, n_requests=3, slots=2, max_new=4, realtime=False,
              warmup=False, device="cpu")
    with tobs.capture() as sink:
        report = serve(**kw)
    reqs = [r for r in sink.records if r["stream"] == "serve.request"]
    gauges = [r for r in sink.records if r["stream"] == "serve.gauge"]
    assert sorted(r["uid"] for r in reqs) == [r.uid for r in report.results]
    assert list(reqs[0]) == ["stream", "uid", "tokens", "prompt_len",
                             "latency_ms", "ttft_ms", "queue_ms"]
    assert gauges and list(gauges[0]) == ["stream", "queue_depth",
                                          "slots_busy", "slots"]
    assert all(g["slots"] == 2 and 0 <= g["slots_busy"] <= 2 for g in gauges)
    quiet = tobs.MemorySink()
    tobs.get_recorder().add_sink(quiet)
    try:
        serve(**kw)
    finally:
        tobs.get_recorder().remove_sink(quiet)
    assert not [r for r in quiet.records if r["stream"].startswith("serve.")]
