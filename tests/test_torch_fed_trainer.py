"""``repro_torch.distributed.fed_trainer`` against the JAX package's
``repro.distributed.fed_trainer`` on the CPU.

Both packages start from the same mid-run state (made with numpy from a
seed, carried across by ``convert.fed_state_from_jax``: ``prev ≠
params``, ``v ≠ 0``, Adam's step 3), take the same batch and the
reference's draws (``torch_parity.replay_fed_noise``), and run one step
with the PAGE coin 1 and 0: the tree trainer for each ``fed_aggregator``
× attack, the flat trainer for each registry aggregator × attack (RFA
buckets by Lemma 3 with the replayed permutation), a frontend family
with prefix embeddings on both. The JAX steps are jitted once per
aggregator (its four attacks in one program) with a traced coin, every
program sharing one trace of the model's loss
(``torch_parity.shared_loss_trace``). Then the window against the
per-step loop, the tree trainer against the flat one, the flat step's
``sharded=True`` route on one process against ``sharded=None``, and
``common_sample_coin``.

Tolerances: the per-agent gradients are f32 sums over the batch's
positions in other orders, and Adam divides by √v̂ ≥ 1e-2 here, so θ
and the moments agree to 2e-6 of their largest entry (v to 2e-6 of the
larger of its own and the new Adam m's, since the mean of avg_zero's
messages cancels to about 0), the losses to 1e-6 relative (the gaps measured here: θ below 1e-7, v below 6e-7 of
their largest entries). Krum's winner is a discontinuity: every Krum
case asserts its margin first (``_krum_margin``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.distributed import fed_trainer as jft  # noqa: E402
from repro.optim.optimizers import AdamState as JAdamState  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.convert import fed_state_from_jax  # noqa: E402
from repro_torch.core import aggregators as taggs  # noqa: E402
from repro_torch.core.noise import FedNoise, draw_fed_coins  # noqa: E402
from repro_torch.core.tree import (ravel_tree, tree_paths,  # noqa: E402
                                   unravel_tree)
from repro_torch.distributed import aggregation as tagg  # noqa: E402
from repro_torch.distributed import fed_trainer as tft  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402

from torch_parity import replay_fed_noise, shared_loss_trace  # noqa: E402

torch.set_num_threads(2)

K, B, S = 4, 2, 16
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=128, head_dim=16)
AGGS = ["mean", "krum", "rfa", "trimmed_mean"]
ATTACKS = ("none", "large_noise(sigma=10)", "avg_zero", "sign_flip")
#: share of each state's largest entry within which the two packages agree
STATE_RTOL = 2e-6
LOSS_RTOL = 1e-6


def _cfgs(arch="llama3.2-1b"):
    jc = dataclasses.replace(jreduced(jget_config(arch)), **TINY)
    tc = dataclasses.replace(reduced(get_config(arch)), **TINY)
    return jc, tc


def _feds(**kw):
    kw = {"kappa": 2, "n_byz": 1, "lr": 1e-3, **kw}
    return jft.FedConfig(**kw), tft.FedConfig(**kw)


def _batch(jcfg, t=0):
    prefix = jcfg.n_prefix_embeds if jcfg.frontend != "none" else 0
    return JPipeline(JDataConfig(jcfg.vocab_size, S, B, K,
                                 n_prefix_embeds=prefix,
                                 d_model=jcfg.d_model, seed=3)).batch(t)


def _mid_state(jcfg, jfed, flat: bool, seed: int = 0, k: int = K):
    """A reference state as it stands mid-run: θ spread around the common
    init, prev near θ, a running v, Adam moments and counters at 3."""
    key = jax.random.PRNGKey(0)
    if flat:
        st, unravel = jft.init_flat_fed_state(jcfg, jfed, k, key)
        stacks = st.theta
    else:
        st, unravel = jft.init_fed_state(jcfg, jfed, k, key), None
        stacks = st.params
    rng = np.random.default_rng(seed)

    def like(scale, base=None):
        def f(leaf):
            n = scale * rng.standard_normal(leaf.shape)
            return (n if base is None else np.asarray(base(leaf)) + n
                    ).astype(np.float32)
        return f

    theta = jax.tree.map(like(0.02, lambda x: x), stacks)
    prev = jax.tree.map(like(0.01, lambda x: x), theta)
    v = jax.tree.map(like(0.1), stacks)
    m = jax.tree.map(like(0.05), stacks)
    vv = jax.tree.map(lambda x: (x ** 2 + 1e-4).astype(np.float32),
                      jax.tree.map(like(0.05), stacks))
    opt = JAdamState(np.full((k,), 3, np.int32), m, vv)
    cls = jft.FlatFedState if flat else jft.FedState
    state = cls(theta, prev, v, opt, np.int32(3))
    return jax.tree.map(jnp.asarray, state), unravel


def _largest(tree) -> float:
    return max(float(np.abs(np.asarray(x)).max())
               for x in jax.tree.leaves(tree))


def _close(want, got, rtol=STATE_RTOL, what="", scale=None):
    """Trees leaf by leaf within ``rtol`` of ``scale`` (default: the
    tree's largest entry)."""
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    g = [x.detach().numpy() for _, x in tree_paths(got)]
    assert len(w) == len(g), what
    scale = scale or _largest(want) or 1.0
    for a, b in zip(w, g):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * scale,
                                   err_msg=what)


def _check_state(want, got):
    if isinstance(got, tft.FlatFedState):
        pairs = [(want.theta, got.theta, "theta"), (want.prev, got.prev,
                 "prev"), (want.v, got.v, "v")]
    else:
        pairs = [(want.params, got.params, "params"),
                 (want.prev_params, got.prev_params, "prev"),
                 (want.v, got.v, "v")]
    pairs += [(want.opt_state.m, got.opt_state.m, "m"),
              (want.opt_state.v, got.opt_state.v, "adam v")]
    for a, b, what in pairs:
        # the aggregate v may cancel to ~0 (the mean of avg_zero's
        # messages): it is held on the scale of the new Adam m it entered
        scale = max(_largest(a), _largest(want.opt_state.m)) \
            if what == "v" else None
        _close(a, b, what=what, scale=scale)
    np.testing.assert_array_equal(got.opt_state.step.numpy(),
                                  np.asarray(want.opt_state.step))
    assert int(got.step) == int(want.step)


def _check_metrics(want, got):
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    scale = max(float(want["diameter"]), 1e-6)
    assert abs(float(got["diameter"]) - float(want["diameter"])) \
        <= 1e-5 * scale
    if "grad_norm" in want:
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-5)
    if "rejected" in want:
        np.testing.assert_array_equal(got["rejected"].numpy(),
                                      np.asarray(want["rejected"]))


def _krum_margin(x):
    """Krum's winning margin on the (K, d) stack it scored: the gap
    between the winner's score and the next score above it, as a share of
    the largest squared norm among the two agents and their scored
    neighbours (the Gram identity's rounding scales with those norms, not
    with a far Byzantine's). With one neighbour the closest pair ties
    exactly (d2 symmetric, asserted) and the first wins, so the margin is
    to the next pair."""
    g = tagg.stacked_gram(x).numpy()
    d2 = tagg.stacked_sq_dists(x).numpy()
    assert np.array_equal(d2, d2.T)
    n_near = max(x.shape[0] - 1 - 2, 1)
    order = np.argsort(d2, axis=1, kind="stable")[:, 1:n_near + 1]
    scores = np.take_along_axis(d2, order, axis=1).sum(1)
    w = int(np.argmin(scores))
    r = int(np.argmin(np.where(scores > scores[w], scores, np.inf)))
    involved = {w, r, *order[w], *order[r]}
    scale = max(g[i, i] for i in involved)
    return (scores[r] - scores[w]) / scale


@pytest.fixture
def krum_inputs(monkeypatch):
    """The stacks the tree and flat Krum score, recorded."""
    seen = []
    agg_krum, krum = tagg.agg_krum, taggs.krum

    def tree_krum(tree, n_byz):
        seen.append(torch.cat([leaf.reshape(leaf.shape[0], -1)
                               for _, leaf in tree_paths(tree)], dim=1))
        return agg_krum(tree, n_byz)

    def flat_krum(x, n_byz, m=1, sharded=None):
        seen.append(x[0])
        return krum(x, n_byz, m, sharded)

    monkeypatch.setattr(tagg, "agg_krum", tree_krum)
    monkeypatch.setattr(taggs, "krum", flat_krum)
    return seen


def _unravel(tcfg):
    return functools.partial(unravel_tree, shapes=param_shapes(tcfg))


def _telemetry(attack: str, flat: bool) -> bool:
    """Telemetry on for one attack of each trainer: avg_zero on the tree
    (``grad_norm``), large_noise on the flat one (and ``rejected``)."""
    return attack.startswith("large_noise") if flat else attack == "avg_zero"


@functools.lru_cache(maxsize=None)
def _reference(aggregator, flat, arch="llama3.2-1b", attacks=ATTACKS,
               seed=0, k=K, n_byz=1):
    """The reference's steps from one mid-run state, one for each attack,
    in one jitted program with a traced coin, run for coin 1 and 0.
    Returns the inputs and ``{"attack|large": (state, metrics)}``."""
    jcfg, _ = _cfgs(arch)
    feds = {att: _feds(aggregator=aggregator, attack=att, n_byz=n_byz,
                       telemetry=_telemetry(att, flat))[0]
            for att in attacks}
    jstate, unravel = _mid_state(jcfg, feds[attacks[0]], flat, seed, k)
    batch = {key: val[:k] for key, val in _batch(jcfg).items()}
    mask = np.arange(k) < n_byz
    key = jax.random.PRNGKey(11 + seed)

    def run(s, b, m, kk, large):
        if flat:
            return {att: jft.fed_train_step_flat(jcfg, jfed, s, unravel, b,
                                                 m, kk, large=large)
                    for att, jfed in feds.items()}
        return {att: jft.fed_train_step(jcfg, jfed, s, b, m, kk, large=large)
                for att, jfed in feds.items()}

    step = jax.jit(run)
    out = {}
    with shared_loss_trace():
        for large in (True, False):
            for att, res in step(jstate, batch, jnp.asarray(mask), key,
                                 jnp.asarray(large)).items():
                out[f"{att}|{large}"] = res
    return jstate, batch, mask, key, out


def _run_case(aggregator, attack, flat, krum_inputs, arch="llama3.2-1b",
              **kw):
    """The port's step for one aggregator and attack, coin 1 and 0, from
    the reference's state and draws, against :func:`_reference`."""
    attacks = kw.pop("attacks", ATTACKS)
    jstate, batch, mask, key, want = _reference(aggregator, flat, arch,
                                                attacks, **kw)
    _, tcfg = _cfgs(arch)
    _, tfed = _feds(aggregator=aggregator, attack=attack,
                    n_byz=kw.get("n_byz", 1),
                    telemetry=_telemetry(attack, flat))
    tstate = fed_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tmask = torch.from_numpy(mask)
    noise = replay_fed_noise(key, jstate.theta if flat else jstate.params,
                             mask, tfed, flat)
    for large in (True, False):
        if flat:
            got_state, got_m = tft.fed_train_step_flat(
                tcfg, tfed, tstate, _unravel(tcfg), tbatch, tmask, noise,
                large=large)
        else:
            got_state, got_m = tft.fed_train_step(
                tcfg, tfed, tstate, tbatch, tmask, noise, large=large)
        if krum_inputs:
            assert _krum_margin(krum_inputs[-1]) > 1e-4
        want_state, want_m = want[f"{attack}|{large}"]
        _check_metrics(want_m, got_m)
        _check_state(want_state, got_state)
    # the step never writes into the state it is given
    again = fed_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for (_, a), (_, b) in zip(tree_paths(tstate), tree_paths(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("aggregator", AGGS)
def test_tree_step_matches_the_reference(aggregator, attack, krum_inputs):
    """``fed_train_step`` for each ``fed_aggregator`` × attack, coin 1
    and 0, from a carried mid-run state; telemetry on with avg_zero."""
    _run_case(aggregator, attack, False, krum_inputs)


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("aggregator", AGGS)
def test_flat_step_matches_the_reference(aggregator, attack, krum_inputs):
    """``fed_train_step_flat`` for each registry aggregator × attack,
    coin 1 and 0; bucketed RFA on the replayed permutation; telemetry on
    (``grad_norm`` and the ``rejected`` mask) with large_noise."""
    _run_case(aggregator, attack, True, krum_inputs, seed=1)


@pytest.mark.parametrize("flat", [False, True])
def test_frontend_family_steps(flat, krum_inputs):
    """Reduced Pixtral (a vlm: prefix embeddings in every batch) through
    both trainers."""
    jcfg, _ = _cfgs("pixtral-12b")
    assert jcfg.frontend != "none" and jcfg.n_prefix_embeds > 0
    _run_case("rfa", "large_noise(sigma=10)", flat, krum_inputs,
              "pixtral-12b", attacks=("large_noise(sigma=10)",), seed=2)


def test_single_agent_step(krum_inputs):
    """K = 1: no attack, no aggregation, diameter 0."""
    _run_case("rfa", "none", False, krum_inputs, attacks=("none",), seed=3,
              k=1, n_byz=0)


@pytest.mark.parametrize("aggregator", ["rfa", "krum", "trimmed_mean"])
def test_sharded_flat_step_on_one_process_is_bit_equal(aggregator):
    """``fed_train_step_flat(sharded=True)`` on a plain state is the
    D-sharded route with one shard: θ, prev, v, Adam's state and every
    metric (telemetry on) equal the ``sharded=None`` step bit for bit,
    coin 1 and 0, under ``large_noise`` (bucketed RFA included). The
    multi-rank route is ``tests/test_torch_sharded_aggregation.py``'s."""
    jcfg, tcfg = _cfgs()
    jfed, tfed = _feds(aggregator=aggregator,
                       attack="large_noise(sigma=10)", telemetry=True)
    jstate, _ = _mid_state(jcfg, jfed, True, seed=6)
    jstate = jax.tree.map(np.asarray, jstate)
    mask = np.arange(K) < 1
    noise = replay_fed_noise(jax.random.PRNGKey(13), jstate.theta, mask,
                             tfed, True)
    b = {k: torch.from_numpy(np.array(v)) for k, v in _batch(jcfg).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # one thread: the CPU's sums in one order
    try:
        for large in (True, False):
            runs = [tft.fed_train_step_flat(
                tcfg, tfed, fed_state_from_jax(jstate, "cpu"),
                _unravel(tcfg), b, torch.from_numpy(mask), noise,
                large=large, sharded=sharded) for sharded in (None, True)]
            (a, am), (c, cm) = runs
            for (_, x), (_, y) in zip(tree_paths(a), tree_paths(c)):
                assert torch.equal(x, y)
            assert am.keys() == cm.keys()
            for key in am:
                assert torch.equal(am[key], cm[key]), key
    finally:
        torch.set_num_threads(threads)


def test_init_states_match_the_reference_layout():
    """The common init in K materialised rows, params and prev separate
    tensors, v zero, the optimizer state leaf by leaf with a (K,)
    counter; the flat θ is the ravel of the tree's row."""
    _, tcfg = _cfgs()
    _, tfed = _feds()
    st = tft.init_fed_state(tcfg, tfed, K, 5, device="cpu")
    flat, unravel = tft.init_flat_fed_state(tcfg, tfed, K, 5, device="cpu")
    for (_, p), (_, q) in zip(tree_paths(st.params),
                              tree_paths(st.prev_params)):
        assert p.data_ptr() != q.data_ptr() and torch.equal(p, q)
        assert p.stride(0) != 0 and torch.equal(p[0], p[-1])
    assert st.opt_state.step.shape == (K,)
    assert [k for k, _ in tree_paths(st.opt_state.m)] == \
        [k for k, _ in tree_paths(st.params)]
    row = ravel_tree(_row(st.params, 0))
    assert torch.equal(flat.theta[2], row)
    assert flat.theta.data_ptr() != flat.prev.data_ptr()
    assert torch.equal(ravel_tree(unravel(flat.theta[1])), flat.theta[1])
    assert not bool(flat.v.any()) and flat.v.shape == flat.theta.shape


def test_tree_and_flat_trainers_agree():
    """The reference's invariant (``tests/test_flat_aggregation.py``):
    with the mean and no attack the two trainers take the same step from
    the same init and batch: the same honest loss and raveled θ, to 1e-6
    of max|θ| (the Gram and mixing sums run leaf by leaf on one side and
    over the ravel on the other)."""
    jcfg, tcfg = _cfgs()
    _, tfed = _feds(aggregator="mean", attack="none")
    tree_st = tft.init_fed_state(tcfg, tfed, K, 0, device="cpu")
    flat_st, unravel = tft.init_flat_fed_state(tcfg, tfed, K, 0,
                                               device="cpu")
    mask = torch.arange(K) < 1
    for t in range(3):
        b = {k: torch.from_numpy(np.array(v))
             for k, v in _batch(jcfg, t).items()}
        tree_st, tm = tft.fed_train_step(tcfg, tfed, tree_st, b, mask,
                                         large=t != 1)
        flat_st, fm = tft.fed_train_step_flat(tcfg, tfed, flat_st, unravel,
                                              b, mask, large=t != 1)
        assert abs(tm["loss"].item() - fm["loss"].item()) <= 1e-6
        raveled = torch.stack([ravel_tree(_row(tree_st.params, k))
                               for k in range(K)])
        torch.testing.assert_close(raveled, flat_st.theta, rtol=0,
                                   atol=1e-6 * flat_st.theta.abs().max())


def _row(tree, k):
    if isinstance(tree, dict):
        return {key: _row(v, k) for key, v in tree.items()}
    return tree[k]


def _window_batches(jcfg, ts):
    bs = [_batch(jcfg, t) for t in ts]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def test_window_matches_the_per_step_loop_and_the_reference():
    """``fed_train_window`` draws its coins and each step's noise from one
    generator: the per-step loop fed those draws gives the same state
    bit for bit. Against the reference's window: its in-scan coins
    (``page_coin(fed_coin_key(fed), t, p)``) and step keys
    (``fold_in(key, t)``) replayed into the port's window."""
    jcfg, tcfg = _cfgs()
    jfed, tfed = _feds(aggregator="rfa", attack="large_noise(sigma=10)",
                       page_p=0.5, seed=4)
    ts = np.arange(2, 6)
    batches = _window_batches(jcfg, ts)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    mask = np.arange(K) < 1
    tmask = torch.from_numpy(mask)
    jstate, _ = _mid_state(jcfg, jfed, False, seed=5)
    tstate = fed_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")

    gen = torch.Generator()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # one thread: the CPU's sums in one order
    try:
        gen.manual_seed(9)
        win_state, win_m = tft.fed_train_window(tcfg, tfed, tstate, tb,
                                                tmask, ts, gen)
        gen.manual_seed(9)
        coins = draw_fed_coins(gen, ts, tfed.page_p)
        assert coins == win_m["coin"].tolist()
        st = tstate
        for i in range(len(ts)):
            nz = tft.fed_noise(gen, tfed, st, 1)
            st, m = tft.fed_train_step(tcfg, tfed, st,
                                       {k: v[i] for k, v in tb.items()},
                                       tmask, nz, large=coins[i])
            assert torch.equal(m["loss"], win_m["loss"][i])
    finally:
        torch.set_num_threads(threads)
    for (_, a), (_, b) in zip(tree_paths(st), tree_paths(win_state)):
        assert torch.equal(a, b)

    key = jax.random.PRNGKey(21)
    with shared_loss_trace():
        want_state, want_m = jax.jit(lambda s, b, k: jft.fed_train_window(
            jcfg, jfed, s, b, jnp.asarray(mask), jnp.asarray(ts), k))(
                jstate, batches, key)
    coin_key = jft.fed_coin_key(jfed)
    coins = [bool(jengine.page_coin(coin_key, int(t), jfed.page_p))
             for t in ts]
    assert coins == [bool(c) for c in np.asarray(want_m["coin"])]
    assert coins != [coins[0]] * len(coins)      # both branches ran
    steps = [replay_fed_noise(jax.random.fold_in(key, int(t)),
                              jstate.params, mask, tfed, False) for t in ts]
    got_state, got_m = tft.fed_train_window(tcfg, tfed, tstate, tb, tmask,
                                            ts, noise=(coins, steps))
    np.testing.assert_allclose(got_m["loss"].numpy(),
                               np.asarray(want_m["loss"]), rtol=LOSS_RTOL)
    _check_state(want_state, got_state)


@pytest.mark.parametrize("seed,p", [(0, 0.1), (1, 0.25), (7, 0.5),
                                    (12345, 0.9)])
def test_common_sample_coin_is_the_reference_coin(seed, p):
    steps = range(1000)
    got = [tft.common_sample_coin(t, seed, p) for t in steps]
    assert got == [jft.common_sample_coin(t, seed, p) for t in steps]
    assert got[0] and 0 < sum(got) < 1000


def test_fed_noise_draws_only_what_the_step_takes():
    """The attack's normals for the Byzantine rows only (n_byz, D), and a
    permutation only for the flat trainer's bucketing aggregator."""
    _, tcfg = _cfgs()
    _, tfed = _feds(aggregator="rfa", attack="large_noise(sigma=10)")
    st = tft.init_fed_state(tcfg, tfed, K, 0, device="cpu")
    flat, _ = tft.init_flat_fed_state(tcfg, tfed, K, 0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    nz = tft.fed_noise(gen, tfed, st, 1)
    assert nz.attack.shape == (1, flat.theta.shape[1]) and nz.perm is None
    nz = tft.fed_noise(gen, tfed, flat, 1)
    assert nz.perm.shape == (1, K) and sorted(nz.perm[0].tolist()) == \
        list(range(K))
    _, tfed = _feds(aggregator="krum", attack="avg_zero")
    assert tft.fed_noise(gen, tfed, flat, 1) == FedNoise(None, None)


@pytest.mark.parametrize("flat", [False, True])
def test_carried_state_round_trips_leaf_by_leaf(flat):
    """``convert.fed_state_from_jax`` keeps every leaf (values, dtype and
    key path: NamedTuple fields, dict keys) of a mid-run reference
    state."""
    jcfg, _ = _cfgs()
    jstate, _ = _mid_state(jcfg, _feds()[0], flat)
    tstate = fed_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert isinstance(tstate, tft.FlatFedState if flat else tft.FedState)

    def name(k):
        for attr in ("name", "key", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    want = [("/".join(map(name, path)), np.asarray(leaf)) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    got = tree_paths(tstate)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
    assert bool((tstate.opt_state.step == 3).all())


def test_entry_points_default_to_cuda():
    """Without a card, the inits and the carry raise unless the CPU is
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tcfg = _cfgs()
    _, tfed = _feds()
    for init in (tft.init_fed_state, tft.init_flat_fed_state):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(tcfg, tfed, 2, 0)
    jstate, _ = _mid_state(jcfg, _feds()[0], True, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_state_from_jax(jax.tree.map(np.asarray, jstate))
