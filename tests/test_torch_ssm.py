"""The port's recurrent blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the CPU: the same numpy inputs and
weights give the same outputs and states.

Configs are the reduced Hymba-1.5B (Mamba: d 256, d_in 512, N 8, conv 4)
and xLSTM-350M (d 256, mLSTM d_in 512 over 4 heads of 128). Tolerances:
both sides compute in f32 and sum their products in other orders, so
outputs of O(1) agree to a few 1e-6; ``ATOL`` 2e-5 on outputs and states
(the mLSTM matrix memory and sLSTM's c grow with the sequence, so theirs
are held relative to their largest entry, ``REL``). Gradients through a
chunked scan are held at 1e-5 of each leaf's largest entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_num_threads(2)

ATOL = 2e-5
REL = 1e-5
GRAD_REL = 1e-5
ARCH = {"mamba": "hymba-1.5b", "mlstm": "xlstm-350m", "slstm": "xlstm-350m"}
J_INIT = {"mamba": jssm.init_mamba, "mlstm": jssm.init_mlstm,
          "slstm": jssm.init_slstm}
J_FWD = {"mamba": jssm.mamba_forward, "mlstm": jssm.mlstm_forward,
         "slstm": jssm.slstm_forward}
T_FWD = {"mamba": tssm.mamba_forward, "mlstm": tssm.mlstm_forward,
         "slstm": tssm.slstm_forward}
J_STATE = {"mamba": jssm.init_mamba_state, "mlstm": jssm.init_mlstm_state,
           "slstm": jssm.init_slstm_state}
T_STATE = {"mamba": tssm.init_mamba_state, "mlstm": tssm.init_mlstm_state,
           "slstm": tssm.init_slstm_state}


def _cfgs(block, **kw):
    j = jcfg.reduced(jcfg.get_config(ARCH[block]))
    t = tcfg.reduced(tcfg.get_config(ARCH[block]))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _t(tree):
    """A JAX tree (dicts of arrays) -> the same tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _block(block, **kw):
    cfg, port_cfg = _cfgs(block, **kw)
    params = J_INIT[block](jax.random.PRNGKey(3), cfg, jnp.float32)
    return cfg, port_cfg, params, _t(params)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(
            got[name].detach().numpy(), w, rtol=0,
            atol=max(ATOL, REL * np.abs(w[np.abs(w) < 1e29]).max(
                initial=0.0)), err_msg=name)


# --- causal_conv1d -----------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_the_reference(K, S, with_state):
    rng = np.random.default_rng(K * 10 + S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    w = rng.standard_normal((K, 6)).astype(np.float32)
    st = rng.standard_normal((2, K - 1, 6)).astype(np.float32) \
        if with_state else None
    want_y, want_s = jlayers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), None if st is None
        else jnp.asarray(st))
    got_y, got_s = tlayers.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-6)
    assert tuple(got_s.shape) == (2, K - 1, 6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if K > 1:
        # the new state is the last K-1 inputs, the old state's included
        tail = np.concatenate([st if st is not None
                               else np.zeros((2, K - 1, 6), np.float32),
                               x], axis=1)[:, -(K - 1):]
        np.testing.assert_array_equal(got_s.numpy(), tail)


def test_causal_conv1d_k1_returns_the_state_unchanged():
    x = torch.ones((2, 5, 3))
    st = torch.zeros((2, 0, 3))
    y, new = tlayers.causal_conv1d(x, torch.full((1, 3), 2.0), st)
    assert new is st
    assert torch.equal(y, 2.0 * x)


# --- the blocks --------------------------------------------------------------

@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("from_state", [False, True])
def test_block_forward_matches_the_reference(block, from_state):
    """A sequence of 11 from no state, or from the state the reference
    reaches after 7 other tokens."""
    cfg, port_cfg, params, tparams = _block(block)
    x = _x(cfg, 2, 11, seed=1)
    state = tstate = None
    if from_state:
        _, state = J_FWD[block](params, cfg, jnp.asarray(_x(cfg, 2, 7, 2)))
        tstate = _t(state)
    want, wst = J_FWD[block](params, cfg, jnp.asarray(x), state)
    got, gst = T_FWD[block](tparams, port_cfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    _assert_state(gst, wst)


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_single_step_chain_matches_the_sequence(block):
    """Nine one-token steps, each from the last one's state (the decode
    path: ``mamba_decode`` for Mamba), against one pass over the nine,
    and the chain's final state against the reference's."""
    cfg, port_cfg, params, tparams = _block(block)
    x = torch.from_numpy(_x(cfg, 2, 9, seed=4))
    seq, seq_state = T_FWD[block](tparams, port_cfg, x)
    step = tssm.mamba_decode if block == "mamba" else T_FWD[block]
    state = T_STATE[block](port_cfg, 2)
    outs = []
    for t in range(9):
        y, state = step(tparams, port_cfg, x[:, t:t + 1], state)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), seq.numpy(),
                               rtol=0, atol=ATOL)
    _assert_state(state, {k: v.numpy() for k, v in seq_state.items()})
    _, want = J_FWD[block](params, cfg, jnp.asarray(x.numpy()))
    _assert_state(state, want)


# --- time_scan ---------------------------------------------------------------

@pytest.fixture
def checkpoints(monkeypatch):
    """Counts ``time_scan``'s checkpointed chunks."""
    calls = []
    orig = tssm.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(tssm, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_chunked_scan_forward_and_grad_match_jax(block, checkpoints):
    """recurrent_chunk 4 over 12 steps: three checkpointed chunks while
    autograd records, and the forward and every parameter's and the
    input's gradient equal ``jax.grad`` of the reference's
    ``jax.checkpoint``-ed scan (1e-5 of each leaf's largest entry)."""
    cfg, port_cfg, params, tparams = _block(block, recurrent_chunk=4)
    x = _x(cfg, 2, 12, seed=5)
    r = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, st = J_FWD[block](p, cfg, xx)
        return jnp.sum(y * r) + sum(jnp.sum(jnp.where(v > -1e29, v, 0.0))
                                    for v in st.values())

    want, (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, st = T_FWD[block](leaves, port_cfg, xt)
    loss = (y * torch.from_numpy(r)).sum() + sum(
        torch.where(v > -1e29, v, 0.0).sum() for v in st.values())
    assert len(checkpoints) == 3
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    for name, g in list(gp.items()) + [("x", gx)]:
        got = (xt if name == "x" else leaves[name]).grad
        g = np.asarray(g)
        np.testing.assert_allclose(
            got.numpy(), g, rtol=0,
            atol=GRAD_REL * max(np.abs(g).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("S,chunk", [(10, 4), (4, 4), (3, 4), (12, 0)])
def test_scan_falls_back_to_the_plain_loop(S, chunk, checkpoints):
    """S not a multiple of the chunk, S no longer than it, or no chunk:
    the plain loop, as the reference's ``time_scan``; with the same
    values as a chunked run where there is one to compare."""
    cfg, port_cfg, params, tparams = _block("mlstm", recurrent_chunk=chunk)
    x = torch.from_numpy(_x(cfg, 2, S, seed=7))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    y, _ = tssm.mlstm_forward(leaves, port_cfg, x)
    assert checkpoints == []
    want, _ = jssm.mlstm_forward(params, cfg, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_time_scan_values_do_not_depend_on_the_chunk(checkpoints):
    """The same step through the plain and the checkpointed loop: the
    same bits, carry and outputs."""
    rng = np.random.default_rng(8)
    xs = (torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)
                           ).requires_grad_(True),)

    def step(carry, inp):
        (c,) = carry
        c = 0.9 * c + torch.tanh(inp[0])
        return (c,), c * 2.0

    c0 = (torch.zeros(3),)
    plain = tssm.time_scan(step, c0, xs)
    chunked = tssm.time_scan(step, c0, xs, chunk=2)
    assert len(checkpoints) == 4
    assert torch.equal(plain[0][0], chunked[0][0])
    assert torch.equal(plain[1], chunked[1])


# --- constants and initial states ---------------------------------------------

def test_constants_equal_the_reference():
    """D, mLSTM's gate bias and the zero sLSTM bias bit for bit; A_log
    = log(1..N) correctly rounded, within an ulp of the reference's;
    dt_bias = log(expm1(exp(u))) with u on [log 1e-3, log 1e-1] (so
    softplus(dt_bias) lies in [1e-3, 1e-1]); sLSTM's r_h a normal cut at
    ±3 of scale d^-½·0.5; conv weights of scale 0.5."""
    for block in ("mamba", "mlstm", "slstm"):
        cfg, port_cfg, params, _ = _block(block)
        gen = torch.Generator()
        gen.manual_seed(0)
        fresh = {"mamba": tssm.init_mamba, "mlstm": tssm.init_mlstm,
                 "slstm": tssm.init_slstm}[block](gen, port_cfg)
        assert {k: tuple(v.shape) for k, v in fresh.items()} == \
            {k: tuple(v.shape) for k, v in params.items()}
        shapes = {"mamba": tssm.mamba_shapes, "mlstm": tssm.mlstm_shapes,
                  "slstm": tssm.slstm_shapes}[block](port_cfg)
        assert shapes == {k: tuple(v.shape) for k, v in params.items()}
        for name in {"mamba": ("D",), "mlstm": ("b_if",),
                     "slstm": ("b",)}[block]:
            assert fresh[name].dtype == torch.float32
            np.testing.assert_array_equal(fresh[name].numpy(),
                                          np.asarray(params[name]))
        if block == "mamba":
            # log(1..N), correctly rounded; XLA's f32 log on the CPU is
            # one ulp above it at 7, the only other difference
            n = np.arange(1, port_cfg.ssm.state_dim + 1)
            want = np.tile(np.log(n).astype(np.float32), (512, 1))
            assert fresh["A_log"].dtype == torch.float32
            np.testing.assert_array_equal(fresh["A_log"].numpy(), want)
            ref = np.asarray(params["A_log"])
            assert np.all(np.abs(ref.view(np.int32) - want.view(np.int32))
                          <= 1)
            dt = torch.nn.functional.softplus(fresh["dt_bias"].double())
            assert 1e-3 * (1 - 1e-5) <= dt.min().item()
            assert dt.max().item() <= 1e-1 * (1 + 1e-5)
            assert dt.max().item() / dt.min().item() > 20   # spread out
            np.testing.assert_allclose(
                torch.log(torch.expm1(torch.exp(torch.log(dt.float())))
                          ).numpy(), fresh["dt_bias"].numpy(), rtol=1e-4)
        if block == "slstm":
            scale = port_cfg.d_model ** -0.5 * 0.5
            assert fresh["r_h"].abs().max().item() <= 3 * scale * (1 + 1e-6)
            assert abs(fresh["r_h"].std().item() / scale - 0.98658) < 0.01
        if "conv_w" in fresh:
            assert fresh["conv_w"].abs().max().item() <= 1.5 * (1 + 1e-6)


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_initial_states_equal_the_reference(block):
    """mLSTM m = -1e30 with n and C zero; sLSTM n = 1 with h, c, m zero;
    Mamba h (f32) and conv zero; and a forward from no state equals one
    from the initial state."""
    cfg, port_cfg, params, tparams = _block(block)
    want = J_STATE[block](cfg, 3, jnp.float32)
    got = T_STATE[block](port_cfg, 3)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].dtype == torch.float32
    ptrs = {t.data_ptr() for t in got.values() if t.numel()}
    assert len(ptrs) == sum(1 for t in got.values() if t.numel())
    x = torch.from_numpy(_x(cfg, 3, 5, seed=9))
    a, sa = T_FWD[block](tparams, port_cfg, x)
    b, sb = T_FWD[block](tparams, port_cfg, x, got)
    assert torch.equal(a, b)
    for name in sa:
        assert torch.equal(sa[name], sb[name])
