"""The port's configs and models against the JAX package's, on the CPU:
the same weights (carried over by ``model_params_from_jax``) and the same
tokens give the same logits, caches and decode steps, for every family
(the recurrent Hymba-1.5B and xLSTM-350M included: their states are
compared as cache leaves, with the caches' tolerance).

Tolerances: both sides compute in f32 and sum in other orders (XLA's
chunked softmax attention against the port's tiled online softmax, other
matmul blockings), so activations of O(1) agree to a few 1e-6; the
logits are compared with atol 2e-5 and the caches (K/V, or MLA's latent
and RoPE key) with atol 5e-5 (keys grow with RoPE's rotation of O(3)
projections). The MoE models (Grok-1, DeepSeek-V2-Lite) route each token
to its top-k experts, a discontinuous choice: every test that runs them
asserts first that the smallest gap between the k-th and (k+1)-th router
probability exceeds ``ROUTE_MARGIN`` (the two packages' router
probabilities agree to about 1e-7), so no choice can flip on rounding."""
import dataclasses
import functools

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
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.rl.transformer_policy import (  # noqa: E402
    transformer_policy_config)
from torch_parity import routing_margins  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 2e-5
CACHE_TOL = 5e-5
ROUTE_MARGIN = 1e-5
#: the families this slice serves, reduced: GQA with MoE (Grok-1), MLA
#: with MoE and shared experts (DeepSeek-V2-Lite), MLA with SwiGLU
#: (MiniCPM3-4B)
NEW_ARCHS = ["grok-1-314b", "deepseek-v2-lite-16b", "minicpm3-4b"]
#: the recurrent families, reduced: the hybrid GQA + Mamba block
#: (Hymba-1.5B) and xLSTM's (mLSTM, sLSTM) pairs
RECURRENT_ARCHS = ["hymba-1.5b", "xlstm-350m"]

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
    """(JAX cfg, port cfg) of a reduced architecture (Qwen2.5-3B: QKV
    bias, G = 2) or of the serving default's policy model (one prefix
    embedding)."""
    if name == "policy":
        kw = dict(n_layers=2, d_model=64, n_heads=2)
        return (jax_policy_config("llama3.2-1b", **kw),
                transformer_policy_config("llama3.2-1b", **kw))
    return (jcfg.reduced(jcfg.get_config(name)),
            tcfg.reduced(tcfg.get_config(name)))


@functools.lru_cache(maxsize=None)
def _build(name):
    """(JAX cfg, port cfg, JAX params, port params) with the same weights;
    Qwen's zero-initialised QKV biases are drawn so that they count."""
    cfg, port_cfg = _config_pair(name)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    if name == "qwen2.5-3b":
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


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2.5-3b",
                                        "policy"] + NEW_ARCHS
                + RECURRENT_ARCHS)
def model(request):
    """Every served family: see :func:`_build`."""
    return _build(request.param)


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2.5-3b",
                                        "policy", "grok-1-314b"])
def gqa_model(request):
    """The models whose attention is GQA: see :func:`_build`."""
    return _build(request.param)


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


def _assert_leaves(got, want):
    """Every leaf of a port cache tree within ``CACHE_TOL`` of the
    reference's, the trees alike: the rings, the recurrent states."""
    paths = [p for p, _ in tree_paths(got)]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert paths == ["/".join(k.key for k in kp) for kp, _ in flat]
    for (path, g), (_, w) in zip(tree_paths(got), flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=CACHE_TOL, err_msg=path)


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


def test_gqa_forward_matches_the_reference(gqa_model):
    cfg, port_cfg, params, tparams = gqa_model
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
    want, waux, wc = J_FORWARD(cfg, params, _j(toks), _j(pe),
                               collect_cache=True)
    with routing_margins() as margins:
        got, gaux, gc = tm.forward(port_cfg, tparams, _t(toks, True),
                                   _t(pe), collect_cache=True)
    assert min(margins, default=1.0) > ROUTE_MARGIN
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    np.testing.assert_allclose(gaux.item(), float(waux), rtol=1e-5,
                               atol=1e-7)
    _assert_leaves(gc, wc)
    last, _, _ = tm.forward(port_cfg, tparams, _t(toks, True), _t(pe),
                            last_only=True)
    # The layers run the same S-row pass either way; only the head's
    # product differs, 1 row against S rows, which the host BLAS serves
    # with different kernels that sum each logit's d_model terms in
    # different blockings. Each f32 partial sum rounds by half an ulp of
    # its size, and the partial sums stay within the logits' scale, so
    # the two orders part by a few roundings of max|logit|; 16 ulps of
    # it bounds that (an AMD EPYC host measured up to 6.1).
    np.testing.assert_allclose(
        last.numpy(), got[:, -1:].numpy(), rtol=0,
        atol=16 * np.finfo(np.float32).eps * got[:, -1:].abs().max().item())


@pytest.mark.parametrize("S,W", [(20, 30), (20, 12), (24, 24)])
def test_prefill_and_decode_match_the_reference(model, S, W):
    """Prefill into a ring larger than the prompt (padded), smaller (kept
    suffix, rolled) and equal, then greedy decode steps past the ring."""
    cfg, port_cfg, params, tparams = model
    toks, pe = _inputs(cfg, 1, S, seed=S + W)
    wl, wcache = J_PREFILL(cfg, params, _j(toks), _j(pe), cache_len=W)
    with routing_margins() as margins:
        gl, gcache = tm.prefill(port_cfg, tparams, _t(toks, True), _t(pe),
                                cache_len=W)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                      np.asarray(wcache["slot_pos"]))
        tok = np.asarray(jnp.argmax(wl[:, -1], -1)).astype(np.int32)
        for _ in range(W // 2 + 3):
            wl, wcache = J_DECODE(cfg, params, jnp.asarray(tok), wcache)
            gl, gcache = tm.decode_step(port_cfg, tparams, _t(tok, True),
                                        gcache)
            assert min(margins, default=1.0) > ROUTE_MARGIN
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       atol=LOGIT_TOL)
            assert int(gcache["pos"]) == int(wcache["pos"])
            np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                          np.asarray(wcache["slot_pos"]))
            tok = np.asarray(jnp.argmax(wl[:, 0], -1)).astype(np.int32)
    _assert_leaves(gcache["blocks"], wcache["blocks"])


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
        with routing_margins() as margins:
            gl, gcache = tm.decode_step_slots(port_cfg, tparams,
                                              _t(tok, True), gcache)
        assert min(margins, default=1.0) > ROUTE_MARGIN
        assert gl.shape == wl.shape == (slots, cfg.vocab_size)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(gcache["pos"].numpy(),
                                      np.asarray(wcache["pos"]))
        np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                      np.asarray(wcache["slot_pos"]))
        tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)


def _no_drop(cfg):
    """A capacity of T·k + 1 per expert: no token is ever dropped, so a
    prefill of S tokens and S one-token decode steps route alike."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


@pytest.mark.parametrize("arch", NEW_ARCHS + RECURRENT_ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """The port's counterpart of ``tests/test_cache_equivalence.py``:
    prefill S tokens, decode 4, against one forward over all S + 4 (MoE
    without drops, as there). Both are the port's own f32 on other
    shapes, so the logits agree to a few 1e-6; atol 2e-5."""
    cfg = _no_drop(tcfg.reduced(tcfg.get_config(arch)))
    params = tm.init_params(cfg, 1, device="cpu")
    B, S, n_dec = 2, 12, 4
    gen = torch.Generator()
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + n_dec), generator=gen)
    with routing_margins() as margins:
        full, _, _ = tm.forward(cfg, params, toks)
        logits, cache = tm.prefill(cfg, params, toks[:, :S],
                                   cache_len=S + n_dec)
        errs = [(logits[:, -1] - full[:, S - 1]).abs().max().item()]
        for i in range(n_dec):
            lg, cache = tm.decode_step(cfg, params, toks[:, S + i], cache)
            errs.append((lg[:, 0] - full[:, S + i]).abs().max().item())
    assert min(margins, default=1.0) > ROUTE_MARGIN
    assert max(errs) < LOGIT_TOL, errs


J_LOSS = jax.jit(jax.value_and_grad(jm.lm_loss, argnums=1),
                 static_argnums=0)


@pytest.mark.parametrize("arch", NEW_ARCHS + RECURRENT_ARCHS)
def test_lm_loss_matches_the_reference(arch):
    """``lm_loss`` (cross-entropy plus the MoE aux term summed over
    layers) within rtol 1e-5 of the reference on the same weights and
    tokens; then one SGD step (the reference smoke test's lr 0.05) whose
    gradient is finite and non-zero lowers the loss on the same batch."""
    cfg, port_cfg, params, tparams = _build(arch)
    toks, _ = _inputs(cfg, 2, 17, seed=5)
    want, _ = J_LOSS(cfg, params, jnp.asarray(toks))
    leaves = tm.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    with routing_margins() as margins:
        loss = tm.lm_loss(port_cfg, leaves, _t(toks, True))
    assert min(margins, default=1.0) > ROUTE_MARGIN
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    grads = [g for _, g in tree_paths(tm.tree_map(lambda x: x.grad,
                                                  leaves))]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float((g ** 2).sum()) for g in grads) > 0
    stepped = tm.tree_map(lambda x: (x - 0.05 * x.grad).detach(), leaves)
    with torch.no_grad():
        after = tm.lm_loss(port_cfg, stepped, _t(toks, True))
    assert after.item() < loss.item()


def test_model_entry_points_default_to_cuda():
    cfg = tcfg.reduced(tcfg.get_config("llama3.2-1b"))
    if torch.cuda.is_available():
        pytest.skip("this checks the error without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_slot_cache(cfg, 2, 8)


# --- the recurrent families ------------------------------------------------

def test_recurrent_block_stacks():
    """xLSTM stacks n_layers / slstm_every pairs (12 at full size), Hymba
    one block per layer with its Mamba subtree."""
    x = tcfg.get_config("xlstm-350m")
    assert tm.n_block_stacks(x) == 12
    shapes = tm.param_shapes(x)
    assert shapes["blocks"]["m"]["wq"] == (12, 2048, 2048)
    assert shapes["blocks"]["norm_s"] == (12, 1024)
    h = tcfg.get_config("hymba-1.5b")
    assert tm.n_block_stacks(h) == 32
    assert tm.param_shapes(h)["blocks"]["ssm"]["A_log"] == (32, 3200, 16)
    for arch in RECURRENT_ARCHS:
        cfg, port_cfg, params, _ = _build(arch)
        cache = tm.init_cache(port_cfg, 3, 10, device="cpu")
        want = jm.init_cache(cfg, 3, 10)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      np.asarray(want["slot_pos"]))
        _assert_leaves(cache["blocks"], want["blocks"])
        # every leaf its own memory: decode writes them in place
        ptrs = [t.data_ptr() for _, t in tree_paths(cache["blocks"])]
        assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("chunk", [0, 4])
def test_recurrent_lm_loss_gradient_matches_jax(arch, chunk):
    """``lm_loss`` and its gradient, every leaf, against ``jax.grad`` of
    the reference's (rtol 1e-5 on the loss; each gradient leaf within
    1e-5 of the gradient's largest entry, f32 sums in other orders); with
    ``recurrent_chunk`` 4 over 16 positions, the scans run in
    checkpointed chunks inside each checkpointed layer, as the
    reference's nested ``jax.checkpoint``s do."""
    cfg, port_cfg, params, tparams = _build(arch)
    cfg = dataclasses.replace(cfg, recurrent_chunk=chunk)
    port_cfg = dataclasses.replace(port_cfg, recurrent_chunk=chunk)
    toks, _ = _inputs(cfg, 2, 17, seed=8)
    want, wgrad = J_LOSS(cfg, params, jnp.asarray(toks))
    leaves = tm.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    loss = tm.lm_loss(port_cfg, leaves, _t(toks, True))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(wgrad)[0]
    scale = max(float(jnp.abs(g).max()) for _, g in flat)
    got = tree_paths(tm.tree_map(lambda x: x.grad, leaves))
    assert [p for p, _ in got] == ["/".join(k.key for k in kp)
                                   for kp, _ in flat]
    for (path, g), (_, w) in zip(got, flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale, err_msg=path)


def test_hymba_sliding_window_ring_cache():
    """The port's ``test_sliding_window_ring_cache`` for Hymba: a ring of
    W = 8 after a 12-token prefill, 6 decode steps, against a window-8
    full forward (the Mamba state sees every token, as there), and the
    prefill and each step against the reference's."""
    cfg, port_cfg, params, tparams = _build("hymba-1.5b")
    B, S, n_dec, W = 2, 12, 6, 8
    toks, _ = _inputs(cfg, B, S + n_dec, seed=11)
    fullw, _, _ = tm.forward(port_cfg, tparams, _t(toks, True), window=W)
    lg, cache = tm.prefill(port_cfg, tparams, _t(toks[:, :S], True),
                           cache_len=W, window=W)
    wl, wcache = jax.jit(jm.prefill, static_argnums=0,
                         static_argnames=("cache_len", "window"))(
        cfg, params, jnp.asarray(toks[:, :S]), cache_len=W, window=W)
    np.testing.assert_allclose(lg.numpy(), np.asarray(wl), atol=LOGIT_TOL)
    errs = [(lg[:, -1] - fullw[:, S - 1]).abs().max().item()]
    for i in range(n_dec):
        lg, cache = tm.decode_step(port_cfg, tparams, _t(toks[:, S + i], True),
                                   cache)
        wl, wcache = J_DECODE(cfg, params, jnp.asarray(toks[:, S + i]),
                              wcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        errs.append((lg[:, 0] - fullw[:, S + i]).abs().max().item())
    assert max(errs) < LOGIT_TOL, errs
    _assert_leaves(cache["blocks"], wcache["blocks"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_three_token_prompt_keeps_the_state_unpadded(arch):
    """A 3-token prompt into a ring of 16: the attention ring is padded
    to 16, but Mamba's conv state (L, B, K-1 = 3, d_in), whose axis 2
    also has length 3, stays the last three inputs, and mLSTM's likewise;
    the states equal the reference's and 4 decode steps follow it."""
    cfg, port_cfg, params, tparams = _build(arch)
    toks, _ = _inputs(cfg, 2, 3, seed=12)
    lg, cache = tm.prefill(port_cfg, tparams, _t(toks, True), cache_len=16)
    wl, wcache = J_PREFILL(cfg, params, jnp.asarray(toks), cache_len=16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(wl), atol=LOGIT_TOL)
    blocks = cache["blocks"]
    conv = blocks["ssm"]["conv"] if arch == "hymba-1.5b" \
        else blocks["m"]["conv"]
    assert conv.shape[1:3] == (2, 3)
    if arch == "hymba-1.5b":
        assert blocks["kv"]["k"].shape[2] == 16
    _assert_leaves(blocks, wcache["blocks"])
    tok = np.asarray(jnp.argmax(wl[:, -1], -1)).astype(np.int32)
    for _ in range(4):
        wl, wcache = J_DECODE(cfg, params, jnp.asarray(tok), wcache)
        lg, cache = tm.decode_step(port_cfg, tparams, _t(tok, True), cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      np.asarray(wcache["slot_pos"]))
        tok = np.asarray(jnp.argmax(wl[:, 0], -1)).astype(np.int32)
    _assert_leaves(cache["blocks"], wcache["blocks"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_decode_step_slots_equals_per_row_decode(arch):
    """Three slots prefilled with 2, 7 and 5 tokens, four per-slot steps,
    against each row's own batch-1 cache through ``decode_step``: the
    logits within ``LOGIT_TOL`` and the states within ``CACHE_TOL`` (f32
    products blocked differently for other batch shapes), and every
    state leaf written in place for every row."""
    _, port_cfg, _, tparams = _build(arch)
    from repro_torch.distributed.serving import slot_cache_insert
    W, lens = 12, (2, 7, 5)
    slots = tm.init_slot_cache(port_cfg, len(lens), W, device="cpu")
    rows = []
    for slot, S in enumerate(lens):
        toks, _ = _inputs(port_cfg, 1, S, seed=20 + slot)
        _, row = tm.prefill(port_cfg, tparams, _t(toks, True), cache_len=W)
        slot_cache_insert(slots, row, slot, S)
        _, own = tm.prefill(port_cfg, tparams, _t(toks, True), cache_len=W)
        rows.append(own)
    before = [t.clone() for _, t in tree_paths(slots["blocks"])]
    tok = torch.tensor([5, 1, 9])
    for _ in range(4):
        lg, slots = tm.decode_step_slots(port_cfg, tparams, tok, slots)
        for r in range(len(lens)):
            want, rows[r] = tm.decode_step(port_cfg, tparams, tok[r:r + 1],
                                           rows[r])
            np.testing.assert_allclose(lg[r].numpy(), want[0, 0].numpy(),
                                       rtol=0, atol=LOGIT_TOL)
        tok = torch.argmax(lg, -1)
    for r in range(len(lens)):
        for (path, a), (_, b) in zip(tree_paths(slots["blocks"]),
                                     tree_paths(rows[r]["blocks"])):
            if "kv" not in path:
                np.testing.assert_allclose(a[:, r].numpy(), b[:, 0].numpy(),
                                           rtol=0, atol=CACHE_TOL,
                                           err_msg=path)
    for (path, a), b in zip(tree_paths(slots["blocks"]), before):
        if "kv" not in path:
            assert not torch.equal(a, b), path     # the states moved
