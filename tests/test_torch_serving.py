"""The port's serving path on the CPU: the batching-invariance and slot
lifecycle contracts of ``tests/test_serving.py`` held on the port, its
served token streams against the JAX package's on the same traffic and
weights, and its front doors (``serve``, ``policy_params``, the CLI).

Streams are compared under the margin rule: the port and the reference
sum in other orders, so their logits differ by up to ``LOGIT_TOL``
(``tests/test_torch_models.py``); a greedy token is held equal wherever
the reference's top-1 margin exceeds that tolerance, and a stream is
compared up to its first step with a smaller margin."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.core.registry import resolve as jresolve  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.rl.envs import make_env  # noqa: E402
from repro.serving import PolicyServer as JServer  # noqa: E402
from repro.serving import DecodeEngine as JEngine  # noqa: E402
from repro.serving import engine_for_policy as j_engine_for  # noqa: E402
from repro.serving import make_traffic as j_make_traffic  # noqa: E402

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.core.registry import resolve  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import (DecodeEngine, PolicyServer,  # noqa: E402
                                 Request, SlotScheduler, engine_for_policy,
                                 make_traffic, policy_params, serve)
from torch_parity import (assert_streams_agree,  # noqa: E402
                          routing_margins)

torch.set_num_threads(2)

POLICY = ("transformer(arch='qwen2.5-3b', n_layers=2, d_model=64, "
          "n_heads=2)")
#: the same policy at head dim 48, which the CUDA flash kernel runs
#: zero-padded to 64
POLICY_HD48 = ("transformer(arch='qwen2.5-3b', n_layers=2, d_model=96, "
               "n_heads=2)")
LOGIT_TOL = 2e-5
ROUTE_MARGIN = 1e-5


@pytest.fixture(scope="module")
def env():
    return resolve("env", "cartpole(horizon=16)")


@pytest.fixture(scope="module")
def policy(env):
    return resolve("policy", POLICY, env=env)


@pytest.fixture(scope="module")
def jax_side():
    """The reference's policy and its params (tests/test_serving.py's)."""
    jpol = jresolve("policy", POLICY, env=make_env("cartpole(horizon=16)"))
    return jpol, jpol.init(jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def params(policy, jax_side):
    return model_params_from_jax(jax.tree.map(np.asarray, jax_side[1]),
                                 policy.model_cfg, device="cpu")


def _tokens_by_uid(policy, params, traffic, slots, **kw):
    eng = engine_for_policy(policy, params, slots=slots, max_new=8,
                            max_prompt=4, device="cpu", **kw)
    report = PolicyServer(eng, warmup=False).run_offline(traffic)
    assert len(report.results) == len(traffic)
    return {r.uid: r.tokens for r in report.results}


# --- the contracts of tests/test_serving.py, on the port --------------------

def test_slot_count_invariance(policy, params, env):
    traffic = make_traffic(10, seed=7, rate_rps=500.0, max_new=8,
                           obs_dim=env.obs_dim)
    t1 = _tokens_by_uid(policy, params, traffic, slots=1)
    t2 = _tokens_by_uid(policy, params, traffic, slots=2)
    t4 = _tokens_by_uid(policy, params, traffic, slots=4)
    assert t1 == t2 == t4
    assert any(len(set(t)) > 1 for t in t1.values())


def test_arrival_order_invariance(policy, params, env):
    traffic = make_traffic(8, seed=3, rate_rps=500.0, max_new=8,
                           obs_dim=env.obs_dim)
    base = _tokens_by_uid(policy, params, traffic, slots=3)
    rng = np.random.default_rng(0)
    for _ in range(2):
        shuffled = list(traffic)
        rng.shuffle(shuffled)
        for i, r in enumerate(shuffled):
            r.arrival_s = i * 1e-3
        assert _tokens_by_uid(policy, params, shuffled, slots=3) == base


def test_prompt_padding_invariance(policy, params):
    req = Request(uid=0, max_new=6, tokens=np.array([3, 1, 2], np.int32))

    def run(buckets):
        eng = DecodeEngine(policy.model_cfg, params, slots=1, max_new=6,
                           max_prompt=8, prompt_buckets=buckets,
                           n_logits=None, device="cpu")
        sch = SlotScheduler(eng)
        assert sch.admit(req) is None
        (res,) = sch.drain()
        return res.tokens

    assert run(buckets=(3,)) == run(buckets=(8,))


def test_matches_unbatched_reference(policy, params, env):
    """Engine output == the port's own prefill + decode_step loop."""
    cfg = policy.model_cfg
    obs_v = np.linspace(-0.5, 0.5, env.obs_dim).astype(np.float32)
    max_new = 6
    pe = torch.zeros((1, cfg.n_prefix_embeds, cfg.d_model))
    pe[0, 0, :env.obs_dim] = torch.from_numpy(obs_v)
    toks = torch.zeros((1, 1), dtype=torch.long)
    W = cfg.n_prefix_embeds + 1 + max_new
    logits, cache = tm.prefill(cfg, params, toks, pe, cache_len=W)
    tok = torch.argmax(logits[0, -1])
    ref = [int(tok)]
    for _ in range(max_new - 1):
        logits, cache = tm.decode_step(cfg, params, tok[None], cache)
        tok = torch.argmax(logits[0, 0])
        ref.append(int(tok))

    eng = DecodeEngine(cfg, params, slots=3, max_new=max_new, max_prompt=4,
                       device="cpu")
    sch = SlotScheduler(eng)
    assert sch.admit(Request(uid=0, max_new=max_new, obs=obs_v)) is None
    (res,) = sch.drain()
    assert res.tokens == ref


def test_single_slot_and_same_tick_refill(policy, params, env):
    eng = engine_for_policy(policy, params, slots=3, max_new=4,
                            max_prompt=4, device="cpu")
    sch = SlotScheduler(eng)
    obs_dim = env.obs_dim
    for i in range(3):
        assert sch.admit(Request(uid=i, max_new=3, obs=np.full(
            obs_dim, 0.1 * i, np.float32))) is None
    assert not sch.has_free() and sch.busy() == 3
    done = []
    while not done:
        done = sch.tick()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert sch.idle() and len(sch.free) == 3
    for i in range(3):
        assert sch.admit(Request(uid=10 + i, max_new=2, obs=np.full(
            obs_dim, -0.2 * i, np.float32))) is None
    got = sch.drain()
    assert sorted(r.uid for r in got) == [10, 11, 12]
    assert all(len(r.tokens) == 2 for r in got)


def test_budget_one_completes_at_prefill(policy, params, env):
    eng = engine_for_policy(policy, params, slots=1, max_new=4,
                            max_prompt=4, device="cpu")
    sch = SlotScheduler(eng)
    res = sch.admit(Request(uid=5, max_new=1,
                            obs=np.zeros(env.obs_dim, np.float32)))
    assert res is not None and len(res.tokens) == 1
    assert sch.idle() and sch.has_free()


def test_token_budgets_respected(policy, params, env):
    traffic = make_traffic(6, seed=11, rate_rps=500.0, max_new=8,
                           obs_dim=env.obs_dim)
    eng = engine_for_policy(policy, params, slots=2, max_new=8,
                            max_prompt=4, device="cpu")
    report = PolicyServer(eng, warmup=False).run_offline(traffic)
    budgets = {r.uid: r.max_new for r in traffic}
    for r in report.results:
        assert len(r.tokens) == budgets[r.uid]


def test_realtime_matches_offline(policy, params, env):
    traffic = make_traffic(8, seed=9, rate_rps=2000.0, max_new=6,
                           obs_dim=env.obs_dim)
    offline = _tokens_by_uid(policy, params, traffic, slots=2)
    eng = engine_for_policy(policy, params, slots=2, max_new=6,
                            max_prompt=4, device="cpu")
    report = PolicyServer(eng, warmup=False).run(traffic)
    assert {r.uid: r.tokens for r in report.results} == offline
    assert all(r.latency_s >= 0 for r in report.results)


# --- the port against the reference ------------------------------------------

def test_make_traffic_equals_the_reference():
    for kw in (dict(obs_dim=4), dict(vocab=128256,
                                     prompt_lens=(1, 16, 128, 512))):
        mine = make_traffic(12, seed=5, max_new=32, **kw)
        ref = j_make_traffic(12, seed=5, max_new=32, **kw)
        for a, b in zip(mine, ref):
            assert (a.uid, a.max_new, a.arrival_s) == \
                (b.uid, b.max_new, b.arrival_s)
            for f in ("tokens", "obs"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


def test_slot_cache_ops_and_cache_len_match_the_reference():
    from repro.distributed import serving as jserv
    from repro_torch.distributed import serving as tserv
    for arch in ("llama3.2-1b", "xlstm-350m"):
        for seq_len in (16, 65536, 524288):
            assert tserv.serve_cache_len(tcfg.get_config(arch), seq_len) \
                == jserv.serve_cache_len(jcfg.get_config(arch), seq_len)
    cfg = jcfg.reduced(jcfg.get_config("llama3.2-1b"))
    port_cfg = tcfg.reduced(tcfg.get_config("llama3.2-1b"))
    row = jm.init_cache(cfg, 1, 6)
    row = dict(row, slot_pos=jnp.arange(6) - 1,
               blocks=jax.tree.map(lambda x: x + 1.0, row["blocks"]))
    trow = {"slot_pos": torch.arange(6) - 1,
            "blocks": tm.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  row["blocks"])}
    want = jserv.slot_cache_evict(
        jserv.slot_cache_insert(jm.init_slot_cache(cfg, 3, 6), row, 1, 3), 2)
    got = tserv.slot_cache_evict(tserv.slot_cache_insert(
        tm.init_slot_cache(port_cfg, 3, 6, device="cpu"), trow, 1, 3), 2)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                  np.asarray(want["slot_pos"]))
    np.testing.assert_array_equal(got["blocks"]["kv"]["k"].numpy(),
                                  np.asarray(want["blocks"]["kv"]["k"]))


@pytest.mark.parametrize("spec", [POLICY, POLICY_HD48],
                         ids=["hd32", "hd48"])
def test_policy_streams_match_the_reference(spec, env):
    policy = resolve("policy", spec, env=env)
    jpol = jresolve("policy", spec, env=make_env("cartpole(horizon=16)"))
    jparams = jpol.init(jax.random.PRNGKey(42))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                   policy.model_cfg, device="cpu")
    assert policy.model_cfg.resolved_head_dim == (
        48 if spec == POLICY_HD48 else 32)
    traffic = make_traffic(6, seed=4, rate_rps=500.0, max_new=6,
                           obs_dim=env.obs_dim)
    mine = _tokens_by_uid(policy, params, traffic, slots=2)
    jeng = j_engine_for(jpol, jparams, slots=2, max_new=8, max_prompt=4)
    ref = {r.uid: r.tokens for r in
           JServer(jeng, warmup=False).run_offline(traffic).results}
    assert_streams_agree(mine, ref, jpol.model_cfg, jparams, traffic,
                          env.n_actions)


def test_lm_streams_match_the_reference():
    """Token prompts on reduced Llama-3.2-1B, prompts padded to buckets."""
    cfg = jcfg.reduced(jcfg.get_config("llama3.2-1b"))
    port_cfg = tcfg.reduced(tcfg.get_config("llama3.2-1b"))
    jparams = jm.init_params(cfg, jax.random.PRNGKey(3))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    port_cfg, device="cpu")
    traffic = make_traffic(5, seed=2, max_new=5, vocab=cfg.vocab_size,
                           prompt_lens=(1, 3, 8))
    before = dispatch.launch_counts()["flash_attention"]
    report = PolicyServer(DecodeEngine(port_cfg, tparams, slots=2,
                                       max_new=5, max_prompt=8,
                                       device="cpu"),
                          warmup=False).run_offline(traffic)
    # the plain route on the CPU: no kernel launch
    assert dispatch.launch_counts()["flash_attention"] == before
    mine = {r.uid: r.tokens for r in report.results}
    jeng = JEngine(cfg, jparams, slots=2, max_new=5, max_prompt=8)
    ref = {r.uid: r.tokens for r in
           JServer(jeng, warmup=False).run_offline(traffic).results}
    assert_streams_agree(mine, ref, cfg, jparams, traffic, None)


def test_moe_mla_streams_match_the_reference():
    """Token prompts on reduced DeepSeek-V2-Lite (MLA with absorbed
    decode, MoE with a shared expert), padded to the same buckets on both
    sides: pad tokens take part in routing and in each expert's capacity
    (T is the bucket length) and, the sort being stable, queue behind the
    real tokens of their expert. The port's engine against the
    reference's, and both against the reference's padded unbatched
    stream under the margin rule; every routing margin of the port's run
    exceeds ``ROUTE_MARGIN`` (``tests/test_torch_models.py``)."""
    cfg = jcfg.reduced(jcfg.get_config("deepseek-v2-lite-16b"))
    port_cfg = tcfg.reduced(tcfg.get_config("deepseek-v2-lite-16b"))
    assert cfg.mla_absorb and cfg.moe.n_shared_experts
    jparams = jm.init_params(cfg, jax.random.PRNGKey(3))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    port_cfg, device="cpu")
    traffic = make_traffic(6, seed=2, max_new=5, vocab=cfg.vocab_size,
                           prompt_lens=(1, 3, 8))
    assert any(len(r.tokens) == 3 for r in traffic)     # padded to 4
    engine = DecodeEngine(port_cfg, tparams, slots=2, max_new=5,
                          max_prompt=8, device="cpu")
    with routing_margins() as margins:
        report = PolicyServer(engine, warmup=False).run_offline(traffic)
    assert min(margins) > ROUTE_MARGIN
    mine = {r.uid: r.tokens for r in report.results}
    jeng = JEngine(cfg, jparams, slots=2, max_new=5, max_prompt=8)
    assert jeng.prompt_buckets == engine.prompt_buckets
    ref = {r.uid: r.tokens for r in
           JServer(jeng, warmup=False).run_offline(traffic).results}
    assert_streams_agree(mine, ref, cfg, jparams, traffic, None,
                          bucket_for=engine.bucket_for)


def test_policy_params_from_theta_in_ravel_order(policy, jax_side,
                                                 tmp_path):
    jpol, jparams = jax_side
    theta, _ = ravel_pytree(jparams)
    got = policy_params(policy, theta=np.asarray(theta), device="cpu")
    want = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 policy.model_cfg, device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 got, want)
    with pytest.raises(ValueError, match="theta has shape"):
        policy_params(policy, theta=np.zeros(3, np.float32), device="cpu")
    # a checkpoint of the same parameters wins over theta
    from repro_torch.checkpoint import save
    save(got, str(tmp_path / "policy.npz"))
    restored = policy_params(policy, checkpoint=str(tmp_path / "policy.npz"),
                             theta=np.zeros(3, np.float32), device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 restored, want)
    with pytest.raises(FileNotFoundError):
        policy_params(policy, checkpoint=str(tmp_path / "absent.npz"),
                      device="cpu")
    with pytest.raises(ValueError, match="no parameter source"):
        policy_params(policy, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    fresh = policy_params(policy, key=gen, device="cpu")
    same = policy_params(policy, key=0, device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 fresh, same)


def test_policy_logits_match_the_reference(policy, params, jax_side, env):
    jpol, jparams = jax_side
    obs = np.random.default_rng(1).standard_normal(
        (3, 2, env.obs_dim)).astype(np.float32)
    got = policy.logits(params, torch.from_numpy(obs))
    want = jpol.logits(jparams, jnp.asarray(obs))
    assert got.shape == (3, 2, env.n_actions)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL)


# --- front doors -------------------------------------------------------------

def test_serve_front_door_on_the_cpu():
    report = serve(key=0, n_requests=5, slots=2, max_new=4, realtime=False,
                   device="cpu")
    assert report.n_requests == 5
    assert all(1 <= len(r.tokens) <= 4 for r in report.results)
    assert set(report.summary()) >= {"tokens_per_s", "latency_p50_ms",
                                     "latency_p99_ms", "ttft_p50_ms"}


def test_launch_cli_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama3.2-1b", "--reduced", "--requests", "3",
          "--slots", "2", "--gen", "3", "--prompt-len", "8", "--offline",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lm serve arch=llama3.2-1b-reduced n_requests=3" in out
    main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--requests", "2",
          "--slots", "2", "--gen", "2", "--prompt-len", "8", "--offline",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lm serve arch=deepseek-v2-lite-16b-reduced n_requests=2" in out
    main(["--policy", POLICY, "--requests", "2", "--gen", "2", "--offline",
          "--device", "cpu"])
    assert "policy serve n_requests=2" in capsys.readouterr().out


def test_launch_cli_serves_a_checkpoint(jax_side, env, tmp_path):
    """``--checkpoint`` (policy mode): the reference's archive of its
    policy's parameters served by the port's CLI, against the reference's
    ``serve(checkpoint=)`` on the same archive and traffic (the CLI's
    defaults: cartpole(horizon=32), 4 slots, prompts of up to 8), under
    the margin rule."""
    from repro import checkpoint as jckpt
    from repro.serving import serve as jserve
    from repro_torch.launch.serve import main
    jpol, jparams = jax_side
    path = str(tmp_path / "policy.npz")
    jckpt.save(jparams, path)
    report = main(["--policy", POLICY, "--requests", "5", "--gen", "4",
                   "--seed", "3", "--offline", "--device", "cpu",
                   "--checkpoint", path])
    mine = {r.uid: r.tokens for r in report.results}
    ref = jserve(policy=POLICY, checkpoint=path, n_requests=5, max_new=4,
                 seed=3, realtime=False)
    cli_env = make_env("cartpole(horizon=32)")
    traffic = make_traffic(5, seed=3, rate_rps=100.0, max_new=4,
                           obs_dim=cli_env.obs_dim)
    assert_streams_agree(mine, {r.uid: r.tokens for r in ref.results},
                         jpol.model_cfg, jparams, traffic,
                         cli_env.n_actions)


def test_entry_points_default_to_cuda(policy, params):
    if torch.cuda.is_available():
        pytest.skip("this checks the error without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(policy.model_cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_for_policy(policy, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(key=0, n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        policy_params(policy, key=0)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "llama3.2-1b", "--reduced"])


def test_decbyzpg_resolves_the_transformer_policy(policy, env):
    """The policy DecByzPG trains is the one serving serves: its flat θ
    holds exactly the served model's parameters."""
    from repro_torch.core.decbyzpg import DecByzPGConfig
    from repro_torch.core.tree import tree_size
    from repro_torch.rl.policy import resolve_policy
    cfg = dataclasses.replace(DecByzPGConfig(), policy=POLICY)
    trained = resolve_policy(cfg, env)
    assert trained.model_cfg == policy.model_cfg
    assert trained.d == tree_size(tm.param_shapes(policy.model_cfg))


def test_profiler_ranges_cover_the_phases(policy, params, env):
    """tools/profile_serve.py reads these ranges."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine_for_policy(policy, params, slots=2, max_new=3,
                            max_prompt=4, device="cpu")
    traffic = make_traffic(2, seed=1, max_new=3, obs_dim=env.obs_dim)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PolicyServer(eng, warmup=False).run_offline(traffic)
    names = {e.key for e in prof.key_averages()}
    assert {"serve.prefill", "serve.insert", "serve.tick"} <= names


# --- the recurrent families ---------------------------------------------------

RECURRENT_ARCHS = ["hymba-1.5b", "xlstm-350m"]


def _recurrent(arch, seed=3):
    cfg = jcfg.reduced(jcfg.get_config(arch))
    port_cfg = tcfg.reduced(tcfg.get_config(arch))
    jparams = jm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, port_cfg, jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), port_cfg, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_engine_prefills_exact_lengths(arch):
    """No prompt padding for a recurrent state, as in the reference's
    engine: no default buckets, the ring sized by ``max_prompt``, and
    ``bucket_for`` the prompt's own length even when buckets are
    passed (which then size the ring, as there)."""
    cfg, port_cfg, jparams, tparams = _recurrent(arch)
    for buckets in (None, (4, 8)):
        eng = DecodeEngine(port_cfg, tparams, slots=2, max_new=5,
                           max_prompt=12, prompt_buckets=buckets,
                           device="cpu")
        ref = JEngine(cfg, jparams, slots=2, max_new=5, max_prompt=12,
                      prompt_buckets=buckets)
        assert eng.prompt_buckets == ref.prompt_buckets == \
            (() if buckets is None else buckets)
        assert eng.cache_len == ref.cache_len == \
            (12 if buckets is None else 8) + 5
        for n in range(1, 13):
            assert eng.bucket_for(n) == ref.bucket_for(n) == n
        with pytest.raises(ValueError, match="max_prompt"):
            eng.bucket_for(13)
    # an attention family pads to the same buckets
    dense_cfg = tcfg.reduced(tcfg.get_config("llama3.2-1b"))
    dense = DecodeEngine(dense_cfg, tm.init_params(dense_cfg, 0,
                                                   device="cpu"),
                         max_prompt=12, prompt_buckets=(4, 8), device="cpu")
    assert dense.bucket_for(3) == 4


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_streams_match_the_reference(arch):
    """Prompts of 1, 3, 6 and 11 tokens through the port's engine (two
    slots, so slots are refilled mid-flight and evicted states are
    overwritten) against the reference's engine, and both against the
    reference's unbatched exact-length stream under the margin rule; the
    warmup's one-token prefill runs first, as a served engine's does."""
    cfg, port_cfg, jparams, tparams = _recurrent(arch)
    traffic = make_traffic(6, seed=2, max_new=5, vocab=cfg.vocab_size,
                           prompt_lens=(1, 3, 6, 11))
    assert len({len(r.tokens) for r in traffic}) >= 3
    report = PolicyServer(DecodeEngine(port_cfg, tparams, slots=2,
                                       max_new=5, max_prompt=12,
                                       device="cpu")).run_offline(traffic)
    mine = {r.uid: r.tokens for r in report.results}
    jeng = JEngine(cfg, jparams, slots=2, max_new=5, max_prompt=12)
    ref = {r.uid: r.tokens for r in
           JServer(jeng, warmup=False).run_offline(traffic).results}
    assert_streams_agree(mine, ref, cfg, jparams, traffic, None)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_padding_changes_the_recurrent_state(arch):
    """Why the engine never pads these families: a prompt right-padded by
    three tokens leaves a different recurrent state (by far more than
    rounding), where the attention ring's real entries and the logits at
    the true last position do not change."""
    _, port_cfg, _, tparams = _recurrent(arch)
    toks = torch.tensor([[7, 3, 9, 4, 1]])
    padded = torch.cat([toks, torch.zeros((1, 3), dtype=torch.long)], 1)
    lg, exact = tm.prefill(port_cfg, tparams, toks, cache_len=12,
                           last_only=False)
    lp, pad = tm.prefill(port_cfg, tparams, padded, cache_len=12,
                         last_only=False)
    np.testing.assert_allclose(lp[:, 4].numpy(), lg[:, 4].numpy(), rtol=0,
                               atol=1e-5)
    from repro_torch.core.tree import tree_paths
    moved = {}
    for (path, a), (_, b) in zip(tree_paths(exact["blocks"]),
                                 tree_paths(pad["blocks"])):
        if path.startswith("kv/"):
            np.testing.assert_allclose(a[:, :, :5].numpy(),
                                       b[:, :, :5].numpy(), rtol=0,
                                       atol=1e-5)
        else:
            moved[path] = (a - b).abs().max().item()
    assert moved and max(moved.values()) > 1e-2, moved


def test_recurrent_slot_cache_ops_match_the_reference():
    """Insert and evict over the hybrid and xLSTM trees: every recurrent
    leaf copied whole into its slot, the evicted slot's state left as it
    was, as in the reference."""
    from repro.distributed import serving as jserv
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed import serving as tserv
    for arch in RECURRENT_ARCHS:
        cfg, port_cfg, _, _ = _recurrent(arch)
        row = jm.init_cache(cfg, 1, 6)
        row = dict(row, slot_pos=jnp.arange(6) - 1,
                   blocks=jax.tree.map(lambda x: x + 1.5, row["blocks"]))
        trow = {"slot_pos": torch.arange(6) - 1,
                "blocks": tm.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                      row["blocks"])}
        want = jserv.slot_cache_evict(jserv.slot_cache_insert(
            jm.init_slot_cache(cfg, 3, 6), row, 1, 3), 1)
        got = tserv.slot_cache_evict(tserv.slot_cache_insert(
            tm.init_slot_cache(port_cfg, 3, 6, device="cpu"), trow, 1, 3), 1)
        np.testing.assert_array_equal(got["pos"].numpy(),
                                      np.asarray(want["pos"]))
        np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                      np.asarray(want["slot_pos"]))
        flat = jax.tree_util.tree_flatten_with_path(want["blocks"])[0]
        paths = tree_paths(got["blocks"])
        assert [p for p, _ in paths] == ["/".join(k.key for k in kp)
                                         for kp, _ in flat]
        for (path, g), (_, w) in zip(paths, flat):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=path)


def test_launch_cli_serves_the_recurrent_families(capsys):
    from repro_torch.launch.serve import main
    for arch in RECURRENT_ARCHS:
        main(["--arch", arch, "--reduced", "--requests", "3", "--slots",
              "2", "--gen", "3", "--prompt-len", "8", "--offline",
              "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"lm serve arch={arch}-reduced n_requests=3" in out
