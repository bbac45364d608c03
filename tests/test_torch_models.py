"""The port's configs and dense models against the JAX package's, on the
CPU: the same weights (carried over by ``model_params_from_jax``) and the
same tokens give the same logits, caches and decode steps.

Tolerances: both sides compute in f32 and sum in other orders (XLA's
chunked softmax attention against the port's tiled online softmax, other
matmul blockings), so activations of O(1) agree to a few 1e-6; the
logits are compared with atol 2e-5 and the K/V caches with atol 5e-5
(keys grow with RoPE's rotation of O(3) projections)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.rl.transformer_policy import (  # noqa: E402
    transformer_policy_config as jax_policy_config)

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.rl.transformer_policy import (  # noqa: E402
    transformer_policy_config)

torch.set_num_threads(2)

LOGIT_TOL = 2e-5
CACHE_TOL = 5e-5

# the reference's entry points, compiled once per config (a static arg)
J_FORWARD = jax.jit(jm.forward, static_argnums=0,
                    static_argnames=("collect_cache", "last_only"))
J_PREFILL = jax.jit(jm.prefill, static_argnums=0,
                    static_argnames=("cache_len",))
J_DECODE = jax.jit(jm.decode_step, static_argnums=0)
J_SLOTS = jax.jit(jm.decode_step_slots, static_argnums=0)
J_INIT = jax.jit(jm.init_params, static_argnums=0)


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tcfg.reduced(t)) == dataclasses.asdict(
        jcfg.reduced(j))
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.resolved_head_dim == j.resolved_head_dim


def test_aliases_and_input_shapes():
    for alias, key in jcfg._ALIASES.items():
        assert tcfg.get_config(alias) == tcfg.get_config(key)
    assert {k: dataclasses.asdict(v) for k, v in tcfg.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jcfg.INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown architecture"):
        tcfg.get_config("gpt-5")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b",
                                  "hymba-1.5b", "xlstm-350m",
                                  "minicpm3-4b"])
def test_unported_families_raise(arch):
    cfg = tcfg.reduced(tcfg.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_params(cfg, 0, device="cpu")


def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    for fused in (False, True):
        np.testing.assert_allclose(
            tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                             fused).numpy(),
            np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                        fused)), rtol=1e-6, atol=1e-6)
    for theta in (10_000.0, 500_000.0, 1_000_000.0):
        np.testing.assert_array_equal(
            tlayers.rope_freqs(64, theta).numpy(),
            np.asarray(jlayers.rope_freqs(64, theta)))
        pos = np.arange(600, 605, dtype=np.int32)
        np.testing.assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)), atol=2e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(
        tlayers.swiglu(torch.from_numpy(h), *map(torch.from_numpy, ws)
                       ).numpy(),
        np.asarray(jlayers.swiglu(jnp.asarray(h), *map(jnp.asarray, ws))),
        rtol=1e-5, atol=1e-5)


def test_dense_init_is_truncated_fan_in():
    gen = torch.Generator()
    gen.manual_seed(0)
    w = tlayers.dense_init(gen, (256, 512))
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert w.abs().max().item() <= 3 * 256 ** -0.5 + 1e-7
    # a standard normal cut at ±3 has std 0.98658
    assert abs(w.std().item() / 256 ** -0.5 - 0.98658) < 0.01


# --- whole models ----------------------------------------------------------

def _config_pair(name):
    """(JAX cfg, port cfg) of reduced Llama-3.2-1B, reduced Qwen2.5-3B
    (QKV bias, G = 2) and the serving default's policy model (one prefix
    embedding)."""
    if name == "policy":
        kw = dict(n_layers=2, d_model=64, n_heads=2)
        return (jax_policy_config("llama3.2-1b", **kw),
                transformer_policy_config("llama3.2-1b", **kw))
    return (jcfg.reduced(jcfg.get_config(name)),
            tcfg.reduced(tcfg.get_config(name)))


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2.5-3b",
                                        "policy"])
def model(request):
    """(JAX cfg, port cfg, JAX params, port params) with the same weights;
    Qwen's zero-initialised QKV biases are drawn so that they count."""
    cfg, port_cfg = _config_pair(request.param)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    if request.param == "qwen2.5-3b":
        assert cfg.qkv_bias and cfg.n_heads // cfg.n_kv_heads == 2
    params = J_INIT(cfg, jax.random.PRNGKey(7))
    if cfg.qkv_bias:
        a = params["blocks"]["attn"]
        for i, name in enumerate(("bq", "bk", "bv")):
            a[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(i),
                                              a[name].shape)
    np_params = jax.tree.map(np.asarray, params)
    return cfg, port_cfg, params, model_params_from_jax(np_params, port_cfg,
                                                        device="cpu")


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = None
    if cfg.frontend != "none":
        pe = rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)
                                 ).astype(np.float32)
    return toks, pe


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, long=False):
    if x is None:
        return None
    return torch.from_numpy(np.asarray(x)).long() if long \
        else torch.from_numpy(np.asarray(x))


def test_param_tree_matches_the_reference(model):
    cfg, port_cfg, params, tparams = model
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape), tparams) == shapes
    assert tm.param_shapes(port_cfg) == shapes
    fresh = tm.init_params(port_cfg, 3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), fresh) == shapes
    bad = dict(jax.tree.map(np.asarray, params))
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        model_params_from_jax(bad, port_cfg, device="cpu")


def test_gqa_forward_matches_the_reference(model):
    cfg, port_cfg, params, tparams = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    tp = tm.tree_map(lambda a: a[0], tparams["blocks"]["attn"])
    pos = np.arange(70)
    want, (wk, wv) = jattn.gqa_forward(jp, cfg, jnp.asarray(x),
                                       jnp.asarray(pos))
    got, (gk, gv) = tattn.gqa_forward(tp, port_cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=CACHE_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=CACHE_TOL)
    with pytest.raises(ValueError, match="arange"):
        tattn.gqa_forward(tp, port_cfg, torch.from_numpy(x),
                          torch.from_numpy(pos + 1))


def test_forward_matches_the_reference(model):
    cfg, port_cfg, params, tparams = model
    toks, pe = _inputs(cfg, 2, 37)
    want, _, wc = J_FORWARD(cfg, params, _j(toks), _j(pe),
                            collect_cache=True)
    got, _, gc = tm.forward(port_cfg, tparams, _t(toks, True), _t(pe),
                            collect_cache=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gc["kv"][name].numpy(),
                                   np.asarray(wc["kv"][name]),
                                   atol=CACHE_TOL)
    last, _, _ = tm.forward(port_cfg, tparams, _t(toks, True), _t(pe),
                            last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), atol=1e-6)


@pytest.mark.parametrize("S,W", [(20, 30), (20, 12), (24, 24)])
def test_prefill_and_decode_match_the_reference(model, S, W):
    """Prefill into a ring larger than the prompt (padded), smaller (kept
    suffix, rolled) and equal, then greedy decode steps past the ring."""
    cfg, port_cfg, params, tparams = model
    toks, pe = _inputs(cfg, 1, S, seed=S + W)
    wl, wcache = J_PREFILL(cfg, params, _j(toks), _j(pe), cache_len=W)
    gl, gcache = tm.prefill(port_cfg, tparams, _t(toks, True), _t(pe),
                            cache_len=W)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                  np.asarray(wcache["slot_pos"]))
    tok = np.asarray(jnp.argmax(wl[:, -1], -1)).astype(np.int32)
    for _ in range(W // 2 + 3):
        wl, wcache = J_DECODE(cfg, params, jnp.asarray(tok), wcache)
        gl, gcache = tm.decode_step(port_cfg, tparams, _t(tok, True), gcache)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        assert int(gcache["pos"]) == int(wcache["pos"])
        np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                      np.asarray(wcache["slot_pos"]))
        tok = np.asarray(jnp.argmax(wl[:, 0], -1)).astype(np.int32)
    np.testing.assert_allclose(gcache["blocks"]["kv"]["k"].numpy(),
                               np.asarray(wcache["blocks"]["kv"]["k"]),
                               atol=CACHE_TOL)


def test_decode_step_slots_matches_the_reference(model):
    """Slots at different positions, one of them empty, over three steps:
    the explicit slot dimension against the reference's vmap."""
    cfg, port_cfg, params, tparams = model
    W, slots = 16, 3
    wcache = jm.init_slot_cache(cfg, slots, W)
    gcache = tm.init_slot_cache(port_cfg, slots, W, device="cpu")
    from repro.distributed.serving import slot_cache_insert as j_insert
    from repro_torch.distributed.serving import slot_cache_insert as t_insert
    for slot, S in ((0, 5), (2, 11)):
        toks, pe = _inputs(cfg, 1, S, seed=slot)
        _, wrow = J_PREFILL(cfg, params, _j(toks), _j(pe), cache_len=W)
        _, grow = tm.prefill(port_cfg, tparams, _t(toks, True), _t(pe),
                             cache_len=W)
        true_len = S - 1 + cfg.n_prefix_embeds     # last token is padding
        wcache = j_insert(wcache, wrow, slot, true_len)
        gcache = t_insert(gcache, grow, slot, true_len)
    tok = np.array([3, 0, 9], np.int32)
    for _ in range(3):
        wl, wcache = J_SLOTS(cfg, params, jnp.asarray(tok), wcache)
        gl, gcache = tm.decode_step_slots(port_cfg, tparams, _t(tok, True),
                                          gcache)
        assert gl.shape == wl.shape == (slots, cfg.vocab_size)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(gcache["pos"].numpy(),
                                      np.asarray(wcache["pos"]))
        np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                      np.asarray(wcache["slot_pos"]))
        tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)


def test_model_entry_points_default_to_cuda():
    cfg = tcfg.reduced(tcfg.get_config("llama3.2-1b"))
    if torch.cuda.is_available():
        pytest.skip("this checks the error without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_slot_cache(cfg, 2, 8)
