"""The port's multi-head latent attention (``repro_torch.models.attention``
MLA part) against the JAX package's on the CPU: the same weights (drawn by
the reference's ``init_mla``) and inputs give the same outputs and latent
caches.

Two configurations: reduced MiniCPM3-4B (query through the low-rank
``w_dq``/``w_uq`` pair) and reduced DeepSeek-V2-Lite with ``q_lora_rank``
0, as the full DeepSeek-V2-Lite has it (one ``wq``; ``reduced()`` sets
every MLA config's ``q_lora_rank`` to 48, so without the replace no test
would reach that branch).

Tolerances: both sides compute in f32 and sum in other orders, with
activations of O(1): outputs within 2e-5, latent caches within 5e-5 (as
``tests/test_torch_models.py`` holds K/V caches)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(2)

OUT_TOL = 2e-5
CACHE_TOL = 5e-5


def _cfgs(name):
    """(JAX cfg, port cfg) of reduced MiniCPM3-4B or reduced
    DeepSeek-V2-Lite with the plain ``wq`` query."""
    arch, q_lora = {"minicpm3": ("minicpm3-4b", None),
                    "deepseek_wq": ("deepseek-v2-lite-16b", 0)}[name]
    pair = [m.reduced(m.get_config(arch)) for m in (jcfg, tcfg)]
    if q_lora is not None:
        pair = [dataclasses.replace(c, mla=dataclasses.replace(
            c.mla, q_lora_rank=q_lora)) for c in pair]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _layer(name):
    """(JAX cfg, port cfg, JAX params, port params) of one MLA layer."""
    jc, tc = _cfgs(name)
    params = jattn.init_mla(jax.random.PRNGKey(5), jc, jnp.float32)
    assert ("wq" in params) == (name == "deepseek_wq")
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    return jc, tc, params, tp


@pytest.fixture(scope="module", params=["minicpm3", "deepseek_wq"])
def mla(request):
    """See :func:`_layer`."""
    return _layer(request.param)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


def test_init_mla_tree_matches_the_reference(mla):
    jc, tc, params, _ = mla
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = tattn.init_mla(gen, tc)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    assert tattn.mla_shapes(tc) == {k: tuple(v.shape)
                                    for k, v in params.items()}


@pytest.mark.parametrize("window", [None, 5])
def test_mla_forward_matches_the_reference(mla, window):
    """The chunked route (the one that takes any positions) at positions
    offset by 3 and 37 tokens; the window, when given, is
    ``mla_forward``'s own argument (it does not read
    ``cfg.sliding_window``)."""
    jc, tc, params, tp = mla
    x = np.random.default_rng(1).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    pos = np.arange(37) + 3
    want, (wc, wk) = jattn.mla_forward(params, jc, jnp.asarray(x),
                                       jnp.asarray(pos), window=window)
    got, (gc, gk) = tattn.mla_forward(tp, tc, torch.from_numpy(x),
                                      torch.from_numpy(pos), window=window,
                                      attention="chunked")
    assert got.shape == want.shape == x.shape
    _close(got, want, OUT_TOL)
    _close(gc, wc, CACHE_TOL)
    _close(gk, wk, CACHE_TOL)


def _cache(jc, B, W, seed):
    rng = np.random.default_rng(seed)
    return {"c": rng.standard_normal((B, W, jc.mla.kv_lora_rank)
                                     ).astype(np.float32),
            "k_rope": rng.standard_normal((B, W, jc.mla.qk_rope_head_dim)
                                          ).astype(np.float32)}


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_mla_decode_matches_the_reference(mla, absorb):
    """One decode step over a ring of 8 at position 11 (the ring wrapped:
    entry 3 holds 11), shared by the three rows, then per-slot rows at their
    own positions (3, 11, 0) against the reference run row by row."""
    jc, tc, params, tp = mla
    B, W = 3, 8
    x = np.random.default_rng(2).standard_normal(
        (B, 1, jc.d_model)).astype(np.float32)
    cache = _cache(jc, B, W, 3)
    pos = 11
    slot_pos = np.arange(W)
    slot_pos[pos % W] = pos
    want, wcache = jattn.mla_decode(
        params, jc, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(slot_pos),
        absorb=absorb)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = tattn.mla_decode(tp, tc, torch.from_numpy(x),
                                   torch.tensor(pos), tcache,
                                   torch.from_numpy(slot_pos), absorb=absorb)
    assert gcache is tcache                 # written in place
    _close(got, want, OUT_TOL)
    for k in cache:
        _close(gcache[k], wcache[k], CACHE_TOL)

    positions = np.array([3, 11, 0])
    # entry i holds the latest position q <= p with q % W == i (-1: none)
    latest = positions[:, None] - (positions[:, None] - np.arange(W)) % W
    per_slot = np.where(latest >= 0, latest, -1)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = tattn.mla_decode(tp, tc, torch.from_numpy(x),
                                   torch.from_numpy(positions), tcache,
                                   torch.from_numpy(per_slot), absorb=absorb)
    for b, p in enumerate(positions):
        want, wcache = jattn.mla_decode(
            params, jc, jnp.asarray(x[b:b + 1]), jnp.asarray(p, jnp.int32),
            {k: jnp.asarray(v[b:b + 1]) for k, v in cache.items()},
            jnp.asarray(per_slot[b]), absorb=absorb)
        _close(got[b:b + 1], want, OUT_TOL)
        for k in cache:
            _close(gcache[k][b:b + 1], wcache[k], CACHE_TOL)


def test_mla_absorbed_equals_naive_decode(mla):
    """The port's counterpart of ``tests/test_cache_equivalence.py``'s
    absorbed-vs-naive check: DeepSeek's weight absorption is an identity,
    so the two decodes agree to rounding (atol 1e-4, the reference's) and
    write the same cache entries."""
    _, tc, _, tp = mla
    B, W = 2, 8
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 1, tc.d_model)).astype(np.float32))
    cache = {k: torch.from_numpy(v) for k, v in _cache(tc, B, W, 5).items()}
    pos = torch.tensor(5)
    slot_pos = torch.arange(W)
    slot_pos[5] = 5
    out = {}
    for absorb in (True, False):
        c = {k: v.clone() for k, v in cache.items()}
        out[absorb] = tattn.mla_decode(tp, tc, x, pos, c, slot_pos,
                                       absorb=absorb)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0,
                               atol=1e-4)
    for k in cache:
        assert torch.equal(out[True][1][k], out[False][1][k])


def _head_block(tp, tc, b, m):
    """Block ``b`` of ``m`` of MLA's heads, as a rank on a "model" split of
    size m holds it: the head-major columns of the query projection,
    ``w_uk`` and ``w_uv``, the rows of ``wo``, ``w_dq`` and ``w_dkv``
    whole; and the config of its H/m heads."""
    a, hb = tc.mla, tc.n_heads // m
    width = {"wq": a.qk_nope_head_dim + a.qk_rope_head_dim,
             "w_uq": a.qk_nope_head_dim + a.qk_rope_head_dim,
             "w_uk": a.qk_nope_head_dim, "w_uv": a.v_head_dim,
             "wo": a.v_head_dim}
    out = {}
    for k, v in tp.items():
        cut = slice(b * hb * width[k], (b + 1) * hb * width[k]) \
            if k in width else slice(None)
        out[k] = v[cut] if k == "wo" else v[:, cut]
    return out, dataclasses.replace(tc, n_heads=hb, n_kv_heads=hb)


@pytest.mark.parametrize("m", [2, 4])
def test_mla_forward_on_head_blocks(mla, m):
    """m blocks of the heads, each through its rows of ``wo``, summed in
    block order, on the chunked route (the one autograd
    differentiates): the whole call's output and latent. Each block's
    ``enter`` hands its input on as a fresh leaf; the leaves' gradients
    summed over the blocks in block order and carried back through what
    entered give every block ``w_dq``'s, ``w_dkv``'s and ``x``'s whole
    gradients, and the block's own columns (rows of ``wo``) of the
    split leaves' gradients."""
    _, tc, _, tp = mla
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 13, tc.d_model)
                                             ).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)
                                             ).astype(np.float32))
    whole = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xw = x.clone().requires_grad_()
    want, (wc, wk) = tattn.mla_forward(whole, tc, xw, attention="chunked")
    want.backward(g)

    outs, runs = [], []
    for b in range(m):
        pb, cb = _head_block(tp, tc, b, m)
        pb = {k: v.clone().requires_grad_() for k, v in pb.items()}
        xb, entered = x.clone().requires_grad_(), []

        def enter(t, entered=entered):
            leaf = t.detach().requires_grad_()
            entered.append((t, leaf))
            return leaf
        out, (c, k_rope) = tattn.mla_forward(pb, cb, xb, enter=enter,
                                             attention="chunked")
        assert torch.equal(c, wc) and torch.equal(k_rope, wk)
        out.backward(g)            # a rank-order sum's backward: identity
        outs.append(out.detach())
        runs.append((pb, xb, entered))
    _close(sum(outs[1:], outs[0]), want.detach(), OUT_TOL)
    assert len(runs[0][2]) == 2     # the query's input, then the latent
    sums = [sum(r[2][i][1].grad for r in runs[1:]) + runs[0][2][i][1].grad
            for i in range(len(runs[0][2]))]
    for b, (pb, xb, entered) in enumerate(runs):
        torch.autograd.backward([t for t, _ in entered], sums)
        _close(xb.grad, xw.grad, OUT_TOL)
        ref, _ = _head_block({k: v.grad for k, v in whole.items()}, tc, b,
                             m)
        assert set(pb) == set(ref)
        for k, v in pb.items():
            _close(v.grad, ref[k], OUT_TOL)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
@pytest.mark.parametrize("m", [2, 4])
def test_mla_decode_on_head_blocks(mla, absorb, m):
    """A decode step at position 11 over a wrapped ring of 8, on m blocks
    of the heads summed in block order: the whole step's output, and
    every block writes the whole step's latent entries."""
    _, tc, _, tp = mla
    B, W = 3, 8
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 1, tc.d_model)).astype(np.float32))
    cache = {k: torch.from_numpy(v) for k, v in _cache(tc, B, W, 9).items()}
    slot_pos = torch.arange(W)
    slot_pos[3] = 11
    pos = torch.tensor(11)
    want, wcache = tattn.mla_decode(tp, tc, x, pos, {
        k: v.clone() for k, v in cache.items()}, slot_pos, absorb=absorb)
    outs = []
    for b in range(m):
        pb, cb = _head_block(tp, tc, b, m)
        out, bcache = tattn.mla_decode(pb, cb, x, pos, {
            k: v.clone() for k, v in cache.items()}, slot_pos,
            absorb=absorb)
        outs.append(out)
        for k in cache:
            assert torch.equal(bcache[k], wcache[k]), (b, k)
    _close(sum(outs[1:], outs[0]), want, OUT_TOL)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["G1", "G2"])
def test_chunked_attention_with_a_narrower_v(H, Hkv):
    """``chunked_causal_attention`` with v's head dim (16) below q/k's
    (24), as MLA gives it, with one KV head per query head (MLA's case)
    and with the GQA expand; 21 queries in chunks of 8 (the last one
    padded) at positions offset by 4."""
    rng = np.random.default_rng(6)
    B, S = 2, 21
    q = rng.standard_normal((B, S, H, 24)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, 24)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, 16)).astype(np.float32)
    pos = np.arange(S) + 4
    for window in (None, 6):
        want = jattn.chunked_causal_attention(
            *map(jnp.asarray, (q, k, v, pos, pos)), window=window, chunk=8)
        got = tattn.chunked_causal_attention(
            *map(torch.from_numpy, (q, k, v, pos, pos)), window=window,
            chunk=8)
        assert got.shape == want.shape == (B, S, H, 16)
        _close(got, want, OUT_TOL)


def _deepseek_head_dims():
    """(JAX cfg, port cfg, JAX params, port params) of a narrow MLA layer
    at DeepSeek-V2-Lite's head dims: q/k 128 + 64 = 192, v 128 (the flash
    kernel's hd-192 instance and its 32-key tiles), 3 heads, d 64."""
    pair = [dataclasses.replace(
        m.reduced(m.get_config("deepseek-v2-lite-16b")), d_model=64,
        n_heads=3, n_kv_heads=3, mla=m.MLAConfig(
            kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128)) for m in (jcfg, tcfg)]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    params = jattn.init_mla(jax.random.PRNGKey(6), pair[0], jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    return (*pair, params, tp)


@pytest.mark.parametrize("which", ["minicpm3", "deepseek_wq",
                                   "deepseek_head_dims"])
@pytest.mark.parametrize("window", [None, 9])
def test_mla_forward_flash_route_matches_the_reference(which, window):
    """``attention="flash"`` (serving's prefill) with v's head dim below
    q/k's (16 below 32 reduced; 128 below 192 at DeepSeek-V2-Lite's head
    dims): against the JAX package's ``mla_forward`` at positions
    ``arange(S)`` and against the port's chunked route, within the MLA
    tolerances; the latent caches are the same bits as the chunked
    route's (attention does not touch them). Two blocks of the heads on
    the flash route, summed in block order, give the whole call's
    output, as serving on each rank's heads sums them."""
    jc, tc, params, tp = _deepseek_head_dims() \
        if which == "deepseek_head_dims" else _layer(which)
    S = 45
    x = np.random.default_rng(11).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S)
    want, (wc, wk) = jattn.mla_forward(params, jc, jnp.asarray(x),
                                       jnp.asarray(pos), window=window)
    got, (gc, gk) = tattn.mla_forward(tp, tc, torch.from_numpy(x),
                                      window=window, attention="flash")
    chunked, (cc, ck) = tattn.mla_forward(tp, tc, torch.from_numpy(x),
                                          window=window,
                                          attention="chunked")
    assert got.shape == want.shape == x.shape
    _close(got, want, OUT_TOL)
    _close(got, chunked, OUT_TOL)
    _close(gc, wc, CACHE_TOL)
    _close(gk, wk, CACHE_TOL)
    assert torch.equal(gc, cc) and torch.equal(gk, ck)
    if tc.n_heads % 2 == 0:
        blocks = [tattn.mla_forward(*_head_block(tp, tc, b, 2),
                                    torch.from_numpy(x), window=window,
                                    attention="flash")[0] for b in (0, 1)]
        _close(blocks[0] + blocks[1], got, OUT_TOL)


def test_mla_flash_route_has_no_backward_and_takes_arange_only(mla):
    """The flash op has no backward (training runs the chunked route), and
    its kernel attends on absolute indices: other positions raise."""
    _, tc, _, tp = mla
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 9, tc.d_model)).astype(np.float32)).requires_grad_()
    out, _ = tattn.mla_forward(tp, tc, x, torch.arange(9),
                               attention="flash")
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()
    with pytest.raises(ValueError, match="arange"):
        tattn.mla_forward(tp, tc, x.detach(), torch.arange(9) + 3,
                          attention="flash")
    with pytest.raises(ValueError, match="attention must be"):
        tattn.mla_forward(tp, tc, x.detach(), attention="sdpa")
