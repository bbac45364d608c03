"""The port's sort-dispatch MoE (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` on the CPU: the same weights (drawn by
the reference's ``init_moe``) and the same inputs give the same outputs
and load-balance term.

Routing is discontinuous: a token picks its top-k experts, and a
rounding difference can swap the k-th and (k+1)-th when their router
probabilities are closer than the rounding. Each comparison asserts
first, as a stated precondition, that the smallest such gap exceeds
``ROUTE_MARGIN``, far above the two packages' probability difference
(checked below ``PROB_TOL``). Then the outputs agree to rounding: the
expert weights' init takes its fan-in from the expert axis (E, in the
reference's ``dense_init``), so expert outputs are O(100) rather than
O(1), and ``y`` is compared within ``Y_RTOL`` of its largest entry."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

ROUTE_MARGIN = 1e-5
PROB_TOL = 1e-6
Y_RTOL = 2e-6
AUX_RTOL = 1e-5


def _cfgs(arch, drops):
    """(JAX cfg, port cfg), reduced; without drops the capacity factor is
    E (``tests/test_cache_equivalence.py``'s ``_no_drop``), so every
    expert holds T·k + 1 slots."""
    pair = [m.reduced(m.get_config(arch)) for m in (jcfg, tcfg)]
    if not drops:
        pair = [dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.n_experts))) for c in pair]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _params(jc, seed=3):
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32)
    return params, jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                params)


J_MOE = jax.jit(jmoe.moe_forward, static_argnums=1)


def _drops(tc, probs, T):
    """Entries dropped for capacity, summed over rows."""
    top_e = torch.topk(probs, tc.moe.top_k, dim=-1).indices
    loads = torch.nn.functional.one_hot(top_e, tc.moe.n_experts).sum((1, 2))
    return int((loads - tmoe.capacity(tc, T)).clamp(min=0).sum())


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_moe_forward_matches_the_reference(arch, drops):
    """Four rows of 24 tokens that share a common component (as a
    sequence's hidden states do), so the router favours some experts:
    with the default capacity factor 1.25 some expert overflows
    (asserted) and drops its latest tokens; with capacity factor E none
    does. DeepSeek-V2-Lite adds its shared expert."""
    jc, tc = _cfgs(arch, drops)
    assert (tc.moe.n_shared_experts > 0) == (arch == "deepseek-v2-lite-16b")
    jp, tp = _params(jc)
    B, T = 4, 24
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, T, tc.d_model))
         + 2 * rng.standard_normal((B, 1, tc.d_model))).astype(np.float32)
    probs = tmoe.router_probs(tp, torch.from_numpy(x))
    want_p = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                               atol=PROB_TOL)
    margin = tmoe.top_k_margin(probs, tc.moe.top_k).item()
    assert margin > ROUTE_MARGIN, margin
    n_drop = _drops(tc, probs, T)
    assert (n_drop > 0) == drops, n_drop

    want_y, want_aux = J_MOE(jp, jc, jnp.asarray(x))
    y, aux = tmoe.moe_forward(tp, tc, torch.from_numpy(x))
    want_y = np.asarray(want_y)
    assert y.shape == want_y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), want_y,
                               atol=Y_RTOL * np.abs(want_y).max())
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_rows_route_alone(arch):
    """A row's output depends only on its own tokens (the capacity and
    the sort are per row: T is the row's length, not the batch's token
    count), so one row run alone equals that row in a batch, up to the
    expert products' blocking over other row counts; decode slots rely
    on it."""
    _, tc = _cfgs(arch, drops=True)
    _, tp = _params(_cfgs(arch, drops=True)[0], seed=4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 20, tc.d_model)).astype(np.float32))
    assert tmoe.top_k_margin(tmoe.router_probs(tp, x),
                             tc.moe.top_k).item() > ROUTE_MARGIN
    y, _ = tmoe.moe_forward(tp, tc, x)
    for b in range(3):
        yb, _ = tmoe.moe_forward(tp, tc, x[b:b + 1])
        torch.testing.assert_close(yb[0], y[b], rtol=0,
                                   atol=Y_RTOL * y.abs().max().item())


def test_capacity_and_init_match_the_reference():
    """``cap`` in the reference's float arithmetic at decode (T = 1) and
    prefill sizes, and ``init_moe``'s tree: router f32, (E, d, f) expert
    weights with the reference's fan-in from E, the shared SwiGLU."""
    for arch in ("grok-1-314b", "deepseek-v2-lite-16b"):
        cfg = tcfg.get_config(arch)
        m = cfg.moe
        for T in (1, 16, 128, 256):
            assert tmoe.capacity(cfg, T) == int(
                T * m.top_k * m.capacity_factor / m.n_experts + 1)
    assert tmoe.capacity(tcfg.get_config("grok-1-314b"), 1) == 1
    assert tmoe.capacity(tcfg.get_config("deepseek-v2-lite-16b"), 256) == 31
    jc, tc = _cfgs("deepseek-v2-lite-16b", drops=True)
    jp, _ = _params(jc)
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tmoe.init_moe(gen, tc, torch.float64)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == jax.tree.map(
        lambda a: tuple(a.shape), tp)
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.float64
    E = tc.moe.n_experts
    assert tp["w_up"].abs().max().item() <= 3 * E ** -0.5 + 1e-7
    assert tmoe.moe_shapes(tc) == jax.tree.map(
        lambda a: tuple(a.shape), tp, is_leaf=lambda a: hasattr(a, "shape"))
