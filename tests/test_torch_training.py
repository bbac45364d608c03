"""The port's training route against the JAX package's, on the CPU: the
chunked causal attention (forward and gradients), the model forward on
any positions, the LM losses and their gradients, layer remat, and the
token pipeline.

Tolerances: both sides compute in f32 and sum in other orders (other
matmul blockings, XLA's fused softmax), so an activation or gradient of
O(1) agrees to a few 1e-7 of its largest entry; each comparison below
allows 1e-5 of that largest entry (or rtol 1e-5 on a scalar loss). The
token pipeline draws with numpy on both sides and must be identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jm  # noqa: E402

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

torch.set_num_threads(2)

#: share of a tensor's largest entry within which the two packages agree
REL_TOL = 1e-5
#: (B, Sq, H, Hkv, hd) of the attention cases; chunk 16 pads 40 to 48
B, S, H, HKV, HD, CHUNK = 2, 40, 4, 2, 16, 16

J_INIT = jax.jit(jm.init_params, static_argnums=0)
J_FORWARD = jax.jit(jm.forward, static_argnums=0)


def _close(got, want, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL_TOL * scale, f"{what}: {err} > {REL_TOL} * {scale}"


def _qkv(Sq=S, Sk=S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, HD)).astype(np.float32),
            rng.standard_normal((B, Sk, HKV, HD)).astype(np.float32),
            rng.standard_normal((B, Sk, HKV, HD)).astype(np.float32))


#: (q positions, k positions): arange, offset by 7, and a query block at
#: 32..39 over 40 keys
POSITIONS = {"arange": (np.arange(S), np.arange(S)),
             "offset7": (np.arange(S) + 7, np.arange(S) + 7),
             "block32": (np.arange(32, 40), np.arange(S))}


@pytest.mark.parametrize("window", [None, 12], ids=["full", "window12"])
@pytest.mark.parametrize("pos", sorted(POSITIONS))
def test_chunked_attention_matches_the_reference(pos, window):
    """Forward and the gradients of q, k and v (the GQA repeat sums dK and
    dV over each group's query heads) against ``jax.grad`` of the
    reference, for a random cotangent."""
    q_pos, k_pos = POSITIONS[pos]
    q, k, v = _qkv(Sq=len(q_pos))
    ct = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    jq, jk = jnp.asarray(q_pos, jnp.int32), jnp.asarray(k_pos, jnp.int32)

    def jloss(a, b, c):
        out = jattn.chunked_causal_attention(a, b, c, jq, jk, window=window,
                                             chunk=CHUNK)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = tattn.chunked_causal_attention(tq, tk, tv, torch.tensor(q_pos),
                                         torch.tensor(k_pos), window=window,
                                         chunk=CHUNK)
    (got * torch.from_numpy(ct)).sum().backward()
    assert got.shape == q.shape
    _close(got.detach(), want, "out")
    for name, t, g in zip("qkv", (tq, tk, tv), grads):
        _close(t.grad, g, f"d{name}")


@pytest.mark.parametrize("window", [None, 12], ids=["full", "window12"])
def test_chunked_route_equals_the_flash_plain_version(window):
    """On ``arange`` positions the two routes compute one function: the
    chunked route against the flash op's plain version (its CPU route)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    pos = torch.arange(S)
    got = tattn.chunked_causal_attention(q, k, v, pos, pos, window=window,
                                         chunk=CHUNK)
    _close(got, flash_attention(q, k, v, window=window), "chunked vs flash")


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _configs(arch, prefix):
    """The reduced config of ``arch`` on both sides; with ``prefix``, a
    state frontend taking 2 prefix embeddings."""
    j, t = jcfg.reduced(jcfg.get_config(arch)), \
        tcfg.reduced(tcfg.get_config(arch))
    if prefix:
        j = dataclasses.replace(j, frontend="state", n_prefix_embeds=2)
        t = dataclasses.replace(t, frontend="state", n_prefix_embeds=2)
    return j, t


@pytest.fixture(scope="module")
def models():
    """(jax config, port config, jax params, port params) by (arch,
    prefix), built on first use."""
    cache = {}

    def get(arch, prefix=False):
        if (arch, prefix) not in cache:
            j, t = _configs(arch, prefix)
            params = J_INIT(j, jax.random.PRNGKey(0))
            tparams = model_params_from_jax(jax.tree.map(np.asarray, params),
                                            t, device="cpu")
            cache[arch, prefix] = (j, t, params, tparams)
        return cache[arch, prefix]

    return get


def _batch(cfg, step=0, seq_len=17):
    return TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, per_agent_batch=2,
        n_prefix_embeds=cfg.n_prefix_embeds if cfg.frontend != "none"
        else 0, d_model=cfg.d_model, seed=5), device="cpu").batch(step)


def test_forward_on_any_positions_matches_the_reference(models):
    """``attention="chunked"`` takes any positions, as the reference's
    ``forward(positions=)``; the flash route still refuses them."""
    j, t, params, tparams = models("llama3.2-1b")
    toks = _batch(t)["tokens"][0]
    pos = np.arange(toks.shape[1]) + 7
    want, _, _ = J_FORWARD(j, params, jnp.asarray(toks.numpy()),
                           positions=jnp.asarray(pos, jnp.int32))
    got, _, _ = tm.forward(t, tparams, toks, positions=torch.tensor(pos),
                           attention="chunked")
    _close(got, want, "logits")
    # arange positions through either route give one function
    flash, _, _ = tm.forward(t, tparams, toks)
    chunked, _, _ = tm.forward(t, tparams, toks, attention="chunked",
                               positions=torch.arange(toks.shape[1]))
    _close(chunked, flash.numpy(), "chunked vs flash logits")


def test_flash_route_refuses_other_positions_and_routes(models):
    _, t, _, tparams = models("llama3.2-1b")
    toks = _batch(t)["tokens"][0]
    with pytest.raises(ValueError, match="arange"):
        tm.forward(t, tparams, toks, positions=torch.arange(17) + 7)
    with pytest.raises(ValueError, match="attention"):
        tm.forward(t, tparams, toks, attention="sdpa")


def _jax_losses(cfg, params, toks, labels, pe):
    """Both reference losses and their gradients, one compiled call."""
    def both(p):
        a = jm.lm_loss(cfg, p, toks, pe)
        b = jm.lm_loss_labeled(cfg, p, toks, labels, pe)
        return a, b
    (a, b), vjp = jax.vjp(both, params)
    ga, = vjp((jnp.float32(1), jnp.float32(0)))
    gb, = vjp((jnp.float32(0), jnp.float32(1)))
    return a, b, ga, gb


J_LOSSES = jax.jit(_jax_losses, static_argnums=0)


def _port_grad(loss_fn, tparams):
    leaves = tm.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    loss = loss_fn(leaves)
    loss.backward()
    return loss.detach(), tm.tree_map(lambda x: x.grad, leaves)


@pytest.mark.parametrize("prefix", [False, True], ids=["tokens", "prefix"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-3b"])
def test_lm_losses_match_the_reference(models, arch, prefix):
    """``lm_loss`` and ``lm_loss_labeled`` (Qwen2.5-3B carries QKV bias),
    with and without prefix embeddings: the loss within rtol 1e-5 and
    every gradient leaf within 1e-5 of its largest entry."""
    j, t, params, tparams = models(arch, prefix)
    batch = _batch(t)
    toks, labels = batch["tokens"][0], batch["labels"][0]
    pe = batch["prefix_embeds"][0] if prefix else None
    want_a, want_b, ga, gb = J_LOSSES(
        j, params, jnp.asarray(toks.numpy()), jnp.asarray(labels.numpy()),
        None if pe is None else jnp.asarray(pe.numpy()))
    for name, fn, want, wgrad in [
            ("lm_loss", lambda p: tm.lm_loss(t, p, toks, pe), want_a, ga),
            ("lm_loss_labeled",
             lambda p: tm.lm_loss_labeled(t, p, toks, labels, pe), want_b,
             gb)]:
        loss, grads = _port_grad(fn, tparams)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5,
                                   err_msg=name)
        for path, g in jax.tree_util.tree_leaves_with_path(wgrad):
            key = [k.key for k in path]
            got = grads
            for k in key:
                got = got[k]
            _close(got, g, f"{name} d{'/'.join(key)}")


def test_remat_is_bit_equal(models):
    """Checkpointed layers recompute the same f32 ops in the same order:
    loss and gradients bit-equal to the run that keeps every activation."""
    _, t, _, tparams = models("qwen2.5-3b", True)
    batch = _batch(t)
    toks, pe = batch["tokens"][0], batch["prefix_embeds"][0]
    out = {}
    for remat in (True, False):
        def loss_fn(p):
            logits, aux, _ = tm.forward(t, p, toks[:, :-1], pe, remat=remat,
                                        attention="chunked")
            return tm._cross_entropy(logits[:, pe.shape[1]:],
                                     toks[:, 1:]) + aux
        out[remat] = _port_grad(loss_fn, tparams)
    assert torch.equal(out[True][0], out[False][0])
    for (pa, a), (pb, b) in zip(tree_paths(out[True][1]),
                                tree_paths(out[False][1])):
        assert pa == pb and torch.equal(a, b), pa


# ---------------------------------------------------------------------------
# Token pipeline
# ---------------------------------------------------------------------------


def test_token_pipeline_equals_the_reference():
    kw = dict(vocab_size=512, seq_len=33, per_agent_batch=2, n_agents=3,
              n_prefix_embeds=2, d_model=16, seed=7)
    want = jpipe.TokenPipeline(jpipe.DataConfig(**kw))
    got = TokenPipeline(DataConfig(**kw), device="cpu")
    for step in (0, 1, 17):
        w, g = want.batch(step), got.batch(step)
        assert set(w) == set(g) == {"tokens", "labels", "prefix_embeds"}
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert g["tokens"].dtype == g["labels"].dtype == torch.int32
        assert g["prefix_embeds"].dtype == torch.float32
    first = next(iter(got))
    assert torch.equal(first["tokens"], got.batch(0)["tokens"])


def test_token_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the error without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(DataConfig(vocab_size=8, seq_len=4, per_agent_batch=1))
