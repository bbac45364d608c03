"""The tree trainer's forward and backward on each rank's rows and blocks:
``fed_train_step`` on a placed state (``_estimate_placed`` ->
``_estimate_blocks``), on the CPU over four gloo ranks, a ("data",
"model") = (2, 2) mesh spawned once (:mod:`torch_ranks`).

Every case starts from a mid-run state (θ around the common init, prev
near θ, a running v, Adam at step 3; numpy leaves carried by
``convert.fed_state_from_jax(..., mesh=, cfg=)``) and takes the step of
each PAGE coin, 1 and 0, with ``mean`` aggregation and one agreement
round:

* reduced Llama-3.2-1B, ``fed_axis="data"`` (K = 2): column- and
  row-parallel projections, a vocabulary-parallel embedding and loss;
* reduced Grok-1 (its ``fed_axis="pod"``, ``fsdp_layers``: K = 1): the
  experts over "model", the layer stack and the rows over "data";
* reduced DeepSeek-V2-Lite (its ``fed_axis="pod"``: K = 1): MLA on
  blocks of its heads, the experts over "model", the rows over "data"
  (reduced MiniCPM3-4B and the ``wq`` route are in
  ``test_torch_mla_blocks.py``);
* reduced Hymba-1.5B, ``fed_axis="data"`` (K = 2): attention heads on
  blocks beside Mamba's whole leaves;
* reduced xLSTM-350M, ``fed_axis="data"``: nothing split, the plain
  step;
* reduced Llama-3.2-1B with ``intra_agent_dp`` (K = 2): the rows over
  "model", the leaves whole.

The parent holds every rank against the port's one-process
``fed_train_step`` from the same state: the aggregated direction v
within ``V_TOL`` of max|v| (blocks sum in another order than the whole
leaf), θ within ``THETA_TOL`` of max|θ| and the honest loss within
``LOSS_TOL``; the case with no split bit for bit. The ranks of a "model"
group hold the same bits. Each rank's loss reads its own rows only
(rows / ranks over the row dimensions). Under ``CollectiveWatch`` only
``all_gather``s, exactly the list of ``analysis.fed_step_gathers``, in
order, for the rank's coordinate; by the labels of its plan
(``analysis.estimate_plan``) none gathers a leaf that ``serve_use``
marks as used on blocks, ``v`` or the logits. Each rank's peak of new
bytes across the estimate (``analysis.memcheck.LiveBytes``) lies within
the direction blocks it returns, the dry run's ``train_gathered_bytes``
of its plan, the one-process loss's own activations and one more of the
call's largest gathers; where a mesh dimension splits the leaves, the
peak above what it returns is below the agent's whole gradients and the
one-process activations, at least one agent's whole leaves below what
the route on whole leaves held. The Llama case also meets the
reference's jitted ``fed_train_step``.

The module imports no JAX at its top, so the ranks start without it.
About 60 s on one worker.
"""
import contextlib
import dataclasses
import functools
import gc
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.memcheck import LiveBytes  # noqa: E402
from repro_torch.carriers import placed  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.convert import fed_state_from_jax  # noqa: E402
from repro_torch.core.tree import tree_map, tree_paths  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import fed_trainer as ft  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402

from torch_ranks import CollectiveWatch, Meshes  # noqa: E402

SHAPE, NAMES = (2, 2), ("data", "model")
#: case -> (arch, config overrides)
CASES = {
    "llama": ("llama3.2-1b", {"fed_axis": "data"}),
    "grok": ("grok-1-314b", {}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "hymba": ("hymba-1.5b", {"fed_axis": "data"}),
    "xlstm": ("xlstm-350m", {"fed_axis": "data"}),
    "dp": ("llama3.2-1b", {"fed_axis": "data", "intra_agent_dp": True}),
}
#: the cases that no mesh dimension of more than one rank splits
PLAIN = ("xlstm",)
#: rows and tokens per agent
B, S = 4, 8
#: the rank's direction v within this share of max|v|: the f32 rounding
#: of sums over a few hundred terms taken in another order (the ranks
#: measured up to about 8 ulps of max|v|, 1e-6)
V_TOL = 4e-6
#: θ within this share of max|θ| (Adam's moments are mid-run, so a
#: rounding of v moves θ by far less than lr)
THETA_TOL = 1e-6
#: the honest loss, relative
LOSS_TOL = 1e-6
#: against the reference: the trainer tests' tolerances
REF_RTOL, REF_LOSS_RTOL = 2e-6, 1e-6


def _cfg(name, cases=CASES):
    """A case's reduced config, with its overrides ("mla" replaces fields
    of the MLA config) and experts of width 64."""
    arch, over = cases[name]
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:
        over = dict(over, moe=dataclasses.replace(cfg.moe, d_ff_expert=64))
    if "mla" in over:
        over = dict(over, mla=dataclasses.replace(cfg.mla, **over["mla"]))
    return dataclasses.replace(cfg, **over)


def _fed():
    return ft.FedConfig(aggregator="mean", attack="none", kappa=1,
                        n_byz=0, lr=1e-3)


def _K(cfg) -> int:
    return tsh.n_agents(cfg, tsh.AbstractMesh(SHAPE, NAMES))


def _mid_state(cfg, K, seed=0):
    """A tree state mid-run, numpy leaves in the port's classes."""
    st = ft.init_fed_state(cfg, _fed(), K, 0, device="cpu")
    rng = np.random.default_rng(seed)

    def like(tree, scale, base=None):
        return tree_map(lambda x, b=None: (
            scale * rng.standard_normal(tuple(x.shape))
            + (0 if base is None else b)).astype(np.float32),
            tree, *([] if base is None else [base]))

    p0 = tree_map(lambda x: x.numpy(), st.params)
    theta = like(st.params, 0.02, p0)
    prev = like(st.params, 0.01, theta)
    v, m = like(st.params, 0.1), like(st.params, 0.05)
    vv = tree_map(lambda x: (x ** 2 + 1e-4).astype(np.float32),
                  like(st.params, 0.05))
    opt = AdamState(np.full((K,), 3, np.int32), m, vv)
    return ft.FedState(theta, prev, v, opt, np.int32(3))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    return _inputs_of(_cfg(name))


def _inputs_of(cfg):
    """A mid-run state, a batch and a mask of ``cfg``'s K agents."""
    K = _K(cfg)
    batch = {k: v.numpy() for k, v in TokenPipeline(DataConfig(
        cfg.vocab_size, S, B, K, seed=3), device="cpu").batch(0).items()}
    return {"state": _mid_state(cfg, K), "batch": batch,
            "mask": np.zeros(K, bool)}


def _blocks(tree):
    """(path, the rank's block, its index) of a placed tree."""
    out = []
    for path, x in tree_paths(tree):
        lay = placed.layout(x)
        out.append((path, placed.local(x).detach().clone(),
                    None if lay is None else [(s.start, s.stop)
                                              for s in lay.index()]))
    return out


@contextlib.contextmanager
def _measured(out):
    """``LiveBytes`` on the CPU over the block, Python's cycle collector
    off inside; ``out["peak"]`` its peak."""
    gc.collect()
    gc.disable()
    try:
        with LiveBytes("cpu") as live:
            yield
    finally:
        gc.enable()
    out["peak"] = live.peak


def _rank_case(cfg, mesh, inp):
    """One case's step of each coin on this rank: its blocks of θ and v,
    the loss, each estimate's peak and the rows each loss read, under
    ``CollectiveWatch``."""
    fed = _fed()
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    mask = torch.from_numpy(inp["mask"])
    est, loss = ft._estimate_placed, ft._loss
    out = {"steps": {}, "coord": tuple(mesh.get_coordinate())}

    def measured(*args, **kw):
        rec = {}
        with _measured(rec):
            tilde_v, losses = est(*args, **kw)
        rec["new"] = sum(placed.local(x).nbytes
                         for _, x in tree_paths(tilde_v))
        out["estimate"].append(rec)
        return tilde_v, losses

    def rows(cfg_, params, b, par=None):
        out["rows"].append(tuple(b["tokens"].shape))
        return loss(cfg_, params, b, par)

    ft._estimate_placed, ft._loss = measured, rows
    try:
        for large in (True, False):
            out["estimate"], out["rows"] = [], []
            state = fed_state_from_jax(inp["state"], "cpu", mesh, cfg)
            res = {}
            with CollectiveWatch(res):
                new, m = ft.fed_train_step(cfg, fed, state, batch, mask,
                                           large=large)
            out["steps"][large] = {
                "params": _blocks(new.params), "v": _blocks(new.v),
                "loss": m["loss"].clone(), "estimate": out["estimate"],
                "rows": out["rows"], **res}
    finally:
        ft._estimate_placed, ft._loss = est, loss
    return out


def _rank_main(rank, world, port, kind, inp, dst):
    """One spawned rank: join the gloo group, build the (2, 2) mesh, run
    every case, write the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        mesh = make_debug_mesh(*SHAPE, device_type="cpu")
        with open(inp, "rb") as f:
            inputs = pickle.load(f)
        torch.save({name: _rank_case(_cfg(name), mesh, inputs[name])
                    for name in CASES}, dst)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The four ranks, started when the module starts and stopped when it
    ends."""
    meshes = Meshes("test_torch_fed_blocks", {"mesh": math.prod(SHAPE)},
                    {"mesh": {name: _inputs(name) for name in CASES}},
                    str(tmp_path_factory.mktemp("fed_blocks")))
    try:
        yield meshes
    finally:
        meshes.stop()


@pytest.fixture(scope="module")
def ranks(_started):
    """Case -> the ranks' results, in rank order."""
    out = _started.results()["mesh"]
    return {name: [r[name] for r in out] for name in CASES}


@contextlib.contextmanager
def _one_thread():
    """One CPU thread, as the ranks run (the sums of several threads are
    not always the same bits; other modules of a worker may set more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _one_process(name):
    return _one_process_of(_cfg(name), _inputs(name))


def _one_process_of(cfg, inp):
    """The port's one-process step of each coin from the same inputs."""
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    with _one_thread():
        return {large: ft.fed_train_step(
            cfg, _fed(), fed_state_from_jax(inp["state"], "cpu"), batch,
            torch.from_numpy(inp["mask"]), large=large)
            for large in (True, False)}


def _check(name, got, want, tol_v, tol_theta, loss_tol):
    wstate, wm = want
    for field, wtree, tol in (("v", wstate.v, tol_v),
                              ("params", wstate.params, tol_theta)):
        leaves = [x for _, x in tree_paths(wtree)]
        scale = max(float(x.abs().max()) for x in leaves)
        for (path, block, idx), w in zip(got[field], leaves):
            wb = w if idx is None else w[tuple(slice(*i) for i in idx)]
            what = f"{name} {field} {path}"
            if tol is None:
                assert torch.equal(block, wb), what
            else:
                np.testing.assert_allclose(block, wb, rtol=0,
                                           atol=tol * scale, err_msg=what)
    if loss_tol is None:
        assert torch.equal(got["loss"], wm["loss"]), name
    else:
        np.testing.assert_allclose(float(got["loss"]), float(wm["loss"]),
                                   rtol=loss_tol, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_step_matches_one_process(ranks, name):
    """Every rank against the one-process step, both coins: v within
    V_TOL of max|v|, θ within THETA_TOL of max|θ|, the loss within
    LOSS_TOL; the case with no split bit for bit. Each rank's loss reads
    its own rows only."""
    _check_steps(ranks[name], name, _cfg(name), _one_process(name),
                 name in PLAIN)


def _check_steps(results, name, cfg, want, plain):
    """:func:`test_blocks_step_matches_one_process`' check of one case's
    ranks against ``want``, its :func:`_one_process_of` step."""
    n = math.prod(SHAPE[NAMES.index(a)] for a in tsh.batch_axes(
        cfg, tsh.AbstractMesh(SHAPE, NAMES)))
    for res in results:
        for large, got in res["steps"].items():
            if plain:
                _check(name, got, want[large], None, None, None)
            else:
                _check(name, got, want[large], V_TOL, THETA_TOL, LOSS_TOL)
            K_rank = _K(cfg) // SHAPE[0] if cfg.fed_axis == "data" \
                else _K(cfg)
            assert got["rows"] == [(B // n, S)] * (
                K_rank * (1 if large else 2)), (name, large)


@pytest.mark.parametrize("name", list(CASES))
def test_model_group_holds_the_same_bits(ranks, name):
    """The ranks of a "model" group (one "data" coordinate) hold the same
    losses and the same bits of every leaf block they share."""
    _check_same_bits(ranks[name], name)


def _check_same_bits(results, name):
    by_data = {}
    for res in results:
        by_data.setdefault(res["coord"][0], []).append(res)
    for group in by_data.values():
        first = group[0]
        for res in group[1:]:
            for large, got in res["steps"].items():
                ref = first["steps"][large]
                assert torch.equal(got["loss"], ref["loss"])
                for field in ("params", "v"):
                    for (path, a, ia), (_, b, ib) in zip(got[field],
                                                         ref[field]):
                        if ia == ib:
                            assert torch.equal(a, b), (name, field, path)


def _plan(cfg):
    mesh = tsh.AbstractMesh(SHAPE, NAMES)
    _, state_shape, batch, (state_sh, batch_sh, _) = ft.make_fed_step(
        cfg, _fed(), mesh, large=True, per_agent_batch=B, seq_len=S)
    return mesh, state_shape, state_sh, batch, batch_sh


@pytest.mark.parametrize("name", list(CASES))
def test_only_the_reckoned_gathers(ranks, name):
    """Only ``all_gather``s, each the one ``fed_step_gathers`` reckons
    for the rank's coordinate, in order; no DTensor operator. By the
    plan's labels, a leaf is gathered whole only where ``serve_use``
    marks it "gather" (one layer at a time), no leaf used on blocks, no
    direction and no logits; with no split the estimate gathers
    nothing."""
    _check_gathers(ranks[name], name, _cfg(name), name in PLAIN)


def _check_gathers(results, name, cfg, plain):
    """:func:`test_only_the_reckoned_gathers`' check of one case's ranks;
    an MLA leaf is never gathered whole where its heads divide."""
    mesh, state_shape, state_sh, batch, batch_sh = _plan(cfg)
    plan = analysis.estimate_plan(cfg, mesh, state_shape, state_sh, batch,
                                  batch_sh)
    specs = tsh.param_shardings(cfg, init_params(cfg, 0, device="meta"),
                                mesh)
    uses = {p: tsh.serve_use(cfg, p, s, mesh) for p, s in tree_paths(specs)}
    kinds = {kind for (kind, _), _, _ in plan}
    assert kinds <= {"sum", "layer", "whole", "max", "enter",
                     "layer-grad", "grad"}, kinds
    for (kind, path), _, g in plan:
        if kind == "whole":
            assert uses[path] == "gather", path
            assert cfg.mla is None or cfg.n_heads % g, path
    if plain:
        assert plan == []
    for res in results:
        for large, got in res["steps"].items():
            assert got["dtensor_ops"] == []
            assert set(got["comm"]) <= {"c10d.allgather_"}, got["comm"]
            want = analysis.fed_step_gathers(
                _fed(), mesh, state_shape, state_sh, batch, batch_sh,
                large=large, coord=res["coord"], cfg=cfg)
            assert [tuple(g) for g in got["gathers"]] == want, \
                (name, large, res["coord"])


@functools.lru_cache(maxsize=None)
def _activations(name):
    return _activations_of(_cfg(name), _inputs(name))


def _activations_of(cfg, inp):
    """The one-process loss's own bytes: its peak of new bytes across one
    agent's loss and gradient less the whole gradients it returns."""
    state = fed_state_from_jax(inp["state"], "cpu")
    params = tree_map(lambda x: x[0], state.params)
    b = {k: torch.from_numpy(v[0]) for k, v in inp["batch"].items()}
    rec = {}
    with _one_thread(), _measured(rec):
        _, grads = ft._agent_grad(cfg, params, b)
    return rec["peak"] - sum(g.nbytes for g in grads)


@pytest.mark.parametrize("name", [n for n in CASES if n not in PLAIN])
def test_estimate_peak_within_the_reckoning(ranks, name):
    """Each rank's peak of new bytes across the estimate within the
    direction blocks it returns, ``train_gathered_bytes`` of its plan
    (one agent's gradient blocks, two of them on a PAGE step), the
    one-process activations and one more of the largest gathers (gloo's
    thread may release a finished gather late); where a mesh dimension
    splits the leaves, the peak above what it returns is below the
    agent's whole gradients (two at c = 0) and the one-process
    activations: at least one agent's whole leaves below what the route
    on whole leaves held (those and the leaves gathered whole)."""
    _check_peak(ranks[name], name, _cfg(name), _activations(name))


def _check_peak(results, name, cfg, act):
    """:func:`test_estimate_peak_within_the_reckoning`'s check of one
    case's ranks, ``act`` its :func:`_activations_of`."""
    mesh, state_shape, state_sh, batch, batch_sh = _plan(cfg)
    plan = analysis.estimate_plan(cfg, mesh, state_shape, state_sh, batch,
                                  batch_sh)
    leaves = [analysis.Leaf.of(t, s, mesh) for (_, t), (_, s) in zip(
        tree_paths(state_shape.params), tree_paths(state_sh.params))]
    grads = sum(math.prod(x.block[1:]) * x.itemsize for x in leaves)
    whole = sum(math.prod(x.shape[1:]) * x.itemsize for x in leaves)
    big = max(b for _, b, _ in plan)
    split = any(x.parts(d) > 1 for x in leaves
                for d in range(1, len(x.shape)))
    for res in results:
        for large, got in res["steps"].items():
            for rec in got["estimate"]:
                bound = rec["new"] + dryrun.train_gathered_bytes(
                    plan, grads * (1 if large else 2)) + act + big
                assert rec["peak"] <= bound, (name, large, rec, bound)
                if split:
                    # the whole-leaf route held the agent's whole leaves,
                    # its whole gradients (two at c = 0) and the same
                    # activations: at least one agent's leaves more
                    grads_whole = whole * (1 if large else 2)
                    assert rec["peak"] - rec["new"] < grads_whole + act, \
                        (name, large, rec, whole, act)


def test_blocks_step_matches_the_reference(ranks):
    """The Llama case's ranks against the reference's jitted
    ``fed_train_step`` from the same state, at the trainer tests'
    tolerances."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import reduced as jreduced
    from repro.distributed import fed_trainer as jft
    from repro.optim.optimizers import AdamState as JAdamState
    from torch_parity import shared_loss_trace

    name = "llama"
    arch, over = CASES[name]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **over)
    jfed = jft.FedConfig(aggregator="mean", attack="none", kappa=1,
                         n_byz=0, lr=1e-3)
    inp = _inputs(name)
    st = inp["state"]
    jstate = jft.FedState(*(jax.tree.map(jnp.asarray, x) for x in (
        st.params, st.prev_params, st.v)), JAdamState(
        *(jax.tree.map(jnp.asarray, f) for f in st.opt_state)),
        jnp.asarray(st.step))
    step = jax.jit(lambda s, b, m, k, large: jft.fed_train_step(
        jcfg, jfed, s, b, m, k, large=large))
    with shared_loss_trace():
        for large in (True, False):
            wstate, wm = step(jstate, inp["batch"], jnp.asarray(inp["mask"]),
                              jax.random.PRNGKey(0), jnp.asarray(large))
            leaves = [np.asarray(x) for x in jax.tree.leaves(wstate.params)]
            scale = max(np.abs(x).max() for x in leaves)
            for res in ranks[name]:
                got = res["steps"][large]
                np.testing.assert_allclose(float(got["loss"]),
                                           float(wm["loss"]),
                                           rtol=REF_LOSS_RTOL)
                for (path, block, idx), w in zip(got["params"], leaves):
                    wb = w if idx is None else w[tuple(slice(*i)
                                                       for i in idx)]
                    np.testing.assert_allclose(
                        block, wb, rtol=0, atol=REF_RTOL * scale,
                        err_msg=f"{large} {path}")
