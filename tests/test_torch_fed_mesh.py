"""The tree federated trainer under a mesh: the leaf placement rules of
``repro_torch.distributed.sharding``, ``fed_state_shardings``,
``make_fed_step`` and ``fed_train_step`` on placed states, on the CPU.

The rules against the reference's ``repro.distributed.sharding`` (on a
``jax.sharding.AbstractMesh``, no devices) for every config, full and
reduced, on the meshes (2, 4) ("data", "model"), (2, 2, 2) ("pod",
"data", "model") and (1, 8), with the config's own federation axis and
the overrides "data", "pod", "all" and ``intra_agent_dp``: ``fed_axes``,
``n_agents``, ``batch_axes``, every leaf's ``param_spec`` (stacked and
not), ``batch_spec``, ``cache_shardings`` (the port's ``init_cache`` tree
has the reference's leaf names and ranks) and ``make_fed_step``'s K,
state and batch shapes and specs. A tuple of axes is placed in JAX's
order (a subprocess with 8 fake XLA devices and a fake process group).

The step over gloo ranks (:mod:`torch_ranks`), spawned once per mesh in
a module fixture: a (2, 2) ("data", "model") mesh with ``fed_axis="data"``
(K = 2, leaves split over "model") and with ``fed_axis="all"`` (K = 4,
leaves whole), reduced Grok-1 on ("pod", "data", "model") = (2, 2, 1)
(its ``fed_axis="pod"`` and ``fsdp_layers``: K over "pod", the batch and
the layer stack over "data"), and ``make_fed_step`` on a one-rank (1, 1)
mesh. Every rank runs each fed_aggregator, each fed_attack and GDA with
``mix_block`` and bf16 mixing (``CASES``), coin 1 and 0, from a mid-run
state carried by ``fed_state_from_jax(..., mesh=, cfg=)``, and returns
its blocks; the parent holds them against the port's one-process
``fed_train_step``:

* on the meshes where no dimension of more than one rank splits an
  agent's leaves or rows ("all", the one-rank mesh) the losses bit for
  bit, and the trimmed mean (and on the one-rank mesh everything) bit
  for bit: the coordinate-wise reduce and GDA's mix take the same
  operands per coordinate;
* where the leaves or the rows are split ("data", "pod": each agent's
  loss and gradient run on the rank's rows and blocks, whose partial
  sums add in another order than the whole leaf's) the losses within
  ``LOSS_TOL`` and every state within ``STATE_TOL``;
* the other states within ``STATE_TOL`` of their largest entry (the
  leaves' Gram partials summed over ranks in another order), Krum's
  margin asserted first (K = 4; at K = 2 the two scores tie exactly, d²
  symmetric on every rank, and the first agent wins);
* under ``CommDebugMode`` only ``all_gather``s (none on one rank), and no
  operator dispatched on a DTensor.

One case (trimmed mean under ``large_noise``, K = 4) also goes against
the reference's jitted ``fed_train_step`` at the trainer tests'
tolerances.
"""
import contextlib
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.distributed import fed_trainer as jft  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.optimizers import AdamState as JAdamState  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.convert import fed_state_from_jax  # noqa: E402
from repro_torch.core.noise import FedNoise  # noqa: E402
from repro_torch.core.tree import tree_map, tree_paths  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import aggregation as tagg  # noqa: E402
from repro_torch.distributed import fed_trainer as tft  # noqa: E402
from repro_torch.carriers import placed  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

from torch_parity import replay_fed_noise, shared_loss_trace  # noqa: E402
from torch_ranks import SRC, CollectiveWatch, Meshes  # noqa: E402

torch.set_num_threads(2)

#: the rule meshes: shape, names
RULE_MESHES = [((2, 4), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model")),
               ((1, 8), ("data", "model"))]
#: the config's own fed_axis, then the overrides
VARIANTS = [None, {"fed_axis": "data"}, {"fed_axis": "pod"},
            {"fed_axis": "all"}, {"fed_axis": "data", "intra_agent_dp": True}]

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=128, head_dim=16)
#: the step meshes: config, its override, the mesh, K (None: n_agents)
STEP_MESHES = {
    "data": ("llama3.2-1b", {"fed_axis": "data"}, (2, 2),
             ("data", "model"), None),
    "all": ("llama3.2-1b", {"fed_axis": "all"}, (2, 2), ("data", "model"),
            None),
    "pod": ("grok-1-314b", {}, (2, 2, 1), ("pod", "data", "model"), None),
    "one": ("llama3.2-1b", {"fed_axis": "data"}, (1, 1), ("data", "model"),
            4),
}
#: the process groups: the step meshes of one mesh shape run in one
GROUPS = {"2x2": ("data", "all"), "pod": ("pod",), "one": ("one",)}
#: aggregator, attack, GDA options ("half": mix_block K // 2, bf16 mix)
CASES = [("mean", "none", None), ("rfa", "none", None),
         ("krum", "large_noise(sigma=10)", None),
         ("trimmed_mean", "large_noise(sigma=10)", None),
         ("mean", "avg_zero", None), ("trimmed_mean", "sign_flip", None),
         ("mean", "none", "half")]
B, S = 2, 16
#: the mesh and case that also meet the reference's step, and its key
REF_KIND, REF_CASE, REF_KEY = "all", 3, jax.random.PRNGKey(11)
#: the states over ranks against one process, as a share of the largest
#: entry (v on the larger of its own and Adam m's, as the trainer tests)
STATE_TOL = 1e-6
#: the step meshes whose agents' leaves or rows a mesh dimension of more
#: than one rank splits: their losses run on the ranks' rows and blocks
BLOCK_KINDS = ("data", "pod")
#: their losses against one process, relative
LOSS_TOL = 1e-6
#: against the reference: the trainer tests' tolerances
STATE_RTOL, LOSS_RTOL = 2e-6, 1e-6


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def _variant(cfg, over):
    return cfg if over is None else dataclasses.replace(cfg, **over)


@functools.lru_cache(maxsize=None)
def _shapes(arch, red):
    """The reference's parameter and cache shapes and the port's, on the
    meta device."""
    jc, tc = jget_config(arch), get_config(arch)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    key = jax.random.PRNGKey(0)
    jp = jax.eval_shape(lambda k: jmodel.init_params(jc, k), key)
    jcache = jax.eval_shape(lambda: jmodel.init_cache(jc, 8, 16))
    tp = tmodel.init_params(tc, 0, device="meta")
    tcache = tmodel.init_cache(tc, 8, 16, device="meta")
    return jc, tc, jp, jcache, tp, tcache


def _jpaths(tree):
    return [("/".join(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _spec(s):
    """A reference spec (or a NamedSharding's) as the port's tuple."""
    return tuple(getattr(s, "spec", s))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_rules_match_the_reference(arch, red):
    """Every rule, every leaf, every mesh and federation variant; then
    ``make_fed_step``'s K, shapes and specs with the config's own axis."""
    jc0, tc0, jp, jcache, tp, tcache = _shapes(arch, red)
    jleaves, tleaves = _jpaths(jp), tree_paths(tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    jcl, tcl = _jpaths(jcache), tree_paths(tcache)
    assert [(p, tuple(x.shape)) for p, x in jcl] == \
        [(p, tuple(x.shape)) for p, x in tcl]
    for shape, names in RULE_MESHES:
        jm, tm = JAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
        for over in VARIANTS:
            jc, tc = _variant(jc0, over), _variant(tc0, over)
            what = f"{arch} {shape} {over}"
            assert tsh.fed_axes(tc, tm) == jsh.fed_axes(jc, jm), what
            K = tsh.n_agents(tc, tm)
            assert K == jsh.n_agents(jc, jm), what
            assert tsh.batch_axes(tc, tm) == jsh.batch_axes(jc, jm), what
            for stacked in (False, True):
                assert tsh.batch_spec(tc, tm, stacked) == \
                    _spec(jsh.batch_spec(jc, jm, stacked)), what
                lead = (K,) if stacked else ()
                for (path, jl), (_, tl) in zip(jleaves, tleaves):
                    js = jsh.param_spec(
                        jc, [jax.tree_util.DictKey(k)
                             for k in path.split("/")],
                        jax.ShapeDtypeStruct(lead + jl.shape, jl.dtype), jm,
                        stacked)
                    ts = tsh.param_spec(
                        tc, path, torch.empty(lead + tuple(tl.shape),
                                              device="meta"), tm, stacked)
                    assert ts == _spec(js), f"{what} {path} {stacked}"
        jspecs = [_spec(s) for s in jax.tree.leaves(
            jsh.cache_shardings(jc0, jcache, jm))]
        tspecs = [s for _, s in tree_paths(
            tsh.cache_shardings(tc0, tcache, tm))]
        assert tspecs == jspecs, f"{arch} cache {shape}"

        fed = dict(aggregator="rfa", kappa=2, n_byz=1)
        sizes = dict(per_agent_batch=2, seq_len=jc0.n_prefix_embeds + 32)
        jstep = jft.make_fed_step(jc0, jft.FedConfig(**fed), jm, large=True,
                                  **sizes)
        tstep = tft.make_fed_step(tc0, tft.FedConfig(**fed), tm, large=True,
                                  **sizes)
        for j, t in ((jstep[1], tstep[1]), (jstep[2], tstep[2])):
            jl, tl = _jpaths(j), tree_paths(t)
            assert [(p, tuple(x.shape), _dtype(x.dtype)) for p, x in jl] \
                == [(p, tuple(x.shape), _dtype(x.dtype)) for p, x in tl]
            assert all(x.device.type == "meta" for _, x in tl)
        jsh_state, jsh_batch, jrep = jstep[3]
        tsh_state, tsh_batch, trep = tstep[3]
        assert [p for p, _ in _jpaths(jsh_state)] == \
            [p for p, _ in tree_paths(tsh_state)]
        assert [s for _, s in tree_paths(tsh_state)] == \
            [_spec(s) for s in jax.tree.leaves(jsh_state)]
        assert {k: tuple(v) for k, v in tsh_batch.items()} == \
            {k: _spec(v) for k, v in jsh_batch.items()}
        assert trep == _spec(jrep) == ()
        assert tft.fed_state_shardings(tc0, tstep[1], tm) == tsh_state


def test_param_spec_reference_cases():
    """The reference's own ``test_param_spec_rules`` on the port: on a
    (2, 4) mesh Qwen2-7B's embedding is vocab-parallel and its
    projections split over "model"; Hymba's 32001-entry vocabulary does
    not divide, so its embedding is replicated."""
    mesh = tsh.AbstractMesh((2, 4), ("data", "model"))
    cfg = get_config("qwen2_7b")
    specs = dict(tree_paths(tsh.param_shardings(
        cfg, tmodel.init_params(cfg, 0, device="meta"), mesh)))
    assert specs["embed"] == ("model", None)
    assert specs["blocks/attn/wq"][-1] == "model"
    assert specs["blocks/attn/wo"][-2] == "model"
    assert specs["blocks/mlp/w_down"][-2] == "model"
    cfg2 = get_config("hymba_1_5b")
    specs2 = dict(tree_paths(tsh.param_shardings(
        cfg2, tmodel.init_params(cfg2, 0, device="meta"), mesh)))
    assert specs2["embed"] == (None, None)


def test_placements_and_specs():
    """The converter: ``Shard(d)`` on each mesh dimension of a tuple, in
    mesh order (another order, an unknown name or a mesh dimension used
    twice raises); a one-name tuple is the name."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = tsh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    P = tsh.PartitionSpec
    assert tsh.placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(P(), mesh) == (Replicate(),) * 3
    assert P(("data",), ()) == ("data", None)
    for bad in (P(("data", "pod")), P("x"), P("data", "data")):
        with pytest.raises(ValueError):
            tsh.placements(bad, mesh)


def test_shard_order_matches_jax():
    """Each of 8 ranks' block of a placed leaf (``placed.place`` under a
    fake process group) is the block JAX gives the device at the same
    mesh coordinate (8 fake CPU devices), for tuples of axes on one
    dimension and splits of several."""
    code = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.carriers import placed
from repro_torch.distributed.sharding import PartitionSpec, placements
names = ("pod", "data", "model")
specs = [(("pod", "data"), "model", None), ("pod", None, ("data", "model")),
         (("pod", "data", "model"),), (None, ("pod", "model"), "data")]
shape = (8, 4, 8)
jmesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), names)
full = torch.arange(np.prod(shape)).reshape(shape)
bad = 0
for r in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=names)
    for s in specs:
        idx = NamedSharding(jmesh, JP(*s)).devices_indices_map(shape)
        want = full[idx[jax.devices()[r]]]
        got = placed.place(full, mesh, placements(PartitionSpec(*s),
                                                  mesh)).to_local()
        bad += not torch.equal(got, want)
    dist.destroy_process_group()
print(json.dumps({"bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == {"bad": 0}


def test_hints_are_no_ops_without_a_mesh():
    """``shard_hint`` without a mesh and ``maybe_shard`` outside
    ``use_mesh`` give the tensor back; ``ctx_mesh`` is the installed
    mesh."""
    x = torch.ones(4, 2)
    assert tsh.shard_hint(x, None, tsh.PartitionSpec("data")) is x
    assert tsh.ctx_mesh() is None and tsh.maybe_shard(x, "data") is x
    mesh = tsh.AbstractMesh((1,), ("data",))
    with tsh.use_mesh(mesh):
        assert tsh.ctx_mesh() is mesh
    assert tsh.ctx_mesh() is None


# ---------------------------------------------------------------------------
# The step over gloo ranks
# ---------------------------------------------------------------------------

def _cfgs(kind):
    arch, over, shape, names, _ = STEP_MESHES[kind]
    jc, tc = jreduced(jget_config(arch)), reduced(get_config(arch))
    kw = dict(TINY, **over)
    if jc.moe is not None:
        kw["moe"] = dataclasses.replace(jc.moe, d_ff_expert=32)
    jc = dataclasses.replace(jc, **kw)
    if tc.moe is not None:
        kw["moe"] = dataclasses.replace(tc.moe, d_ff_expert=32)
    return jc, dataclasses.replace(tc, **kw)


def _K(kind) -> int:
    _, _, shape, names, k = STEP_MESHES[kind]
    return k or tsh.n_agents(_cfgs(kind)[1], tsh.AbstractMesh(shape, names))


def _feds(case, K):
    agg, attack, gda = CASES[case]
    kw = dict(aggregator=agg, attack=attack, kappa=2, n_byz=1, lr=1e-3,
              telemetry=True)
    if gda == "half":
        kw.update(mix_block=K // 2, mix_dtype="bfloat16")
    return jft.FedConfig(**kw), tft.FedConfig(**kw)


def _mid_state(tcfg, tfed, K, seed=0):
    """A tree state mid-run (the trainer tests' recipe, on the port's
    common init): θ around θ₀, prev near θ, a running v, Adam at step 3;
    numpy leaves in the reference's types, which every rank and the
    one-process run carry over with ``fed_state_from_jax``."""
    st = tft.init_fed_state(tcfg, tfed, K, 0, device="cpu")
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
    opt = JAdamState(np.full((K,), 3, np.int32), m, vv)
    return jft.FedState(theta, prev, v, opt, np.int32(3))


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    """One mesh's inputs: the mid-run state, a batch, the mask and the
    attack's normals (the reference's draw from key 11 on the mesh that
    meets the reference, seeded numpy normals elsewhere)."""
    _, tcfg = _cfgs(kind)
    K = _K(kind)
    _, tfed = _feds(0, K)
    state = _mid_state(tcfg, tfed, K)
    prefix = tcfg.n_prefix_embeds if tcfg.frontend != "none" else 0
    batch = {k: v.numpy() for k, v in TokenPipeline(DataConfig(
        tcfg.vocab_size, S, B, K, n_prefix_embeds=prefix,
        d_model=tcfg.d_model, seed=3), device="cpu").batch(0).items()}
    mask = np.arange(K) < 1
    if kind == REF_KIND:
        _, tfed = _feds(REF_CASE, K)
        normals = replay_fed_noise(REF_KEY, state.params, mask, tfed,
                                   False).attack
    else:
        D = sum(int(np.prod(x.shape[1:])) for _, x in tree_paths(
            state.params))
        normals = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (1, D)).astype(np.float32))
    noise = [FedNoise(normals if "large_noise" in CASES[c][1] else None,
                      None) for c in range(len(CASES))]
    return {"state": state, "batch": batch, "mask": mask, "noise": noise}


def _fields(st):
    return {"params": st.params, "prev": st.prev_params, "v": st.v,
            "m": st.opt_state.m, "adam v": st.opt_state.v}


def _blocks(st):
    """A (placed) state's fields as (path, the rank's block, its index)."""
    out = {}
    for name, tree in _fields(st).items():
        rows = []
        for path, x in tree_paths(tree):
            lay = placed.layout(x)
            idx = None if lay is None else [(s.start, s.stop)
                                            for s in lay.index()]
            rows.append((path, placed.local(x).detach().clone(), idx))
        out[name] = rows
    out["counters"] = (st.opt_state.step.clone(), st.step.clone())
    return out


def _rank_cases(kind, mesh, inputs):
    """Every case on this rank, coin 1 and 0 each from the carried state:
    the blocks, metrics and Krum's distances; the collectives."""
    jcfg, tcfg = _cfgs(kind)
    K = _K(kind)
    tmask = torch.from_numpy(inputs["mask"])
    tbatch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    out = {"steps": {}, "d2": []}
    agg_krum = tagg.agg_krum

    def krum(tree, n_byz):
        out["d2"].append(tagg.stacked_sq_dists(tree))
        return agg_krum(tree, n_byz)

    tagg.agg_krum = krum
    try:
        for case in range(len(CASES)):
            _, tfed = _feds(case, K)
            for large in (True, False):
                # the PAGE step (coin 0) runs every operation of coin 1's;
                # one rank runs no collective, so one case shows it
                watch = CollectiveWatch(out) if not large and (
                    kind != "one" or case == 0) else contextlib.nullcontext()
                with watch:
                    if kind == "one":
                        state = fed_state_from_jax(inputs["state"],
                                                   "cpu")
                        step = tft.make_fed_step(tcfg, tfed, mesh,
                                                 large=large)[0]
                        new, m = step(state, tbatch, tmask,
                                      inputs["noise"][case])
                    else:
                        state = fed_state_from_jax(inputs["state"], "cpu",
                                                   mesh, tcfg)
                        new, m = tft.fed_train_step(
                            tcfg, tfed, state, tbatch, tmask,
                            inputs["noise"][case], large=large)
                out["steps"][case, large] = (
                    _blocks(new), {k: v.clone() for k, v in m.items()})
    finally:
        tagg.agg_krum = agg_krum
    out["placements"] = [(p, tuple(x.placements))
                         for p, x in tree_paths(new.params)]
    out["coord"] = tuple(mesh.get_coordinate())
    if kind == "data":
        x = torch.arange(16.0).reshape(4, 4)
        P = tsh.PartitionSpec
        a = tsh.shard_hint(x, mesh, P("data", "model"))
        with tsh.use_mesh(mesh):
            b = tsh.maybe_shard(x, None, "model")
        c = tsh.shard_hint(a, mesh, P(None, "model"))
        out["hints"] = [(tuple(t.placements), t.to_local().clone())
                        for t in (a, b, c)]
        out["hints_same"] = tsh.shard_hint(a, mesh, P("data", "model")) is a
    return out


def _rank_main(rank, world, port, group, inp, dst):
    """One spawned rank: join the gloo group, build the mesh, run every
    case of each of the group's kinds, write the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        shape = STEP_MESHES[GROUPS[group][0]][2]
        mesh = (make_debug_mesh(2, 1, multi_pod=True, device_type="cpu")
                if len(shape) == 3 else
                make_debug_mesh(*shape, device_type="cpu"))
        with open(inp, "rb") as f:
            inputs = pickle.load(f)
        torch.save({kind: _rank_cases(kind, mesh, inputs[kind])
                    for kind in GROUPS[group]}, dst)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The step meshes' ranks, started when the module starts (they run
    beside its other tests) and stopped when it ends: one process group
    per mesh shape, "data" and "all" sharing the (2, 2) one."""
    meshes = Meshes(
        "test_torch_fed_mesh",
        {g: int(np.prod(STEP_MESHES[kinds[0]][2]))
         for g, kinds in GROUPS.items()},
        {g: {kind: _inputs(kind) for kind in kinds}
         for g, kinds in GROUPS.items()},
        str(tmp_path_factory.mktemp("fed_mesh")))
    try:
        yield meshes
    finally:
        meshes.stop()


@pytest.fixture(scope="module")
def ranks(_started):
    """Kind -> the ranks' results, in rank order."""
    out = _started.results()
    return {kind: [r[kind] for r in out[g]]
            for g, kinds in GROUPS.items() for kind in kinds}


@functools.lru_cache(maxsize=None)
def _one_process(kind):
    """The port's one-process steps from the same inputs, and the stacks
    Krum scored: {(case, large): (state, metrics)}, [stacks]."""
    _, tcfg = _cfgs(kind)
    K = _K(kind)
    inp = _inputs(kind)
    tmask = torch.from_numpy(inp["mask"])
    tbatch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    seen, agg_krum = [], tagg.agg_krum

    def krum(tree, n_byz):
        seen.append(torch.cat([leaf.reshape(K, -1)
                               for _, leaf in tree_paths(tree)], dim=1))
        return agg_krum(tree, n_byz)

    tagg.agg_krum = krum
    try:
        out = {}
        for case in range(len(CASES)):
            _, tfed = _feds(case, K)
            for large in (True, False):
                out[case, large] = tft.fed_train_step(
                    tcfg, tfed, fed_state_from_jax(inp["state"], "cpu"),
                    tbatch, tmask, inp["noise"][case], large=large)
    finally:
        tagg.agg_krum = agg_krum
    return out, seen


def _krum_margin(x) -> float:
    """Krum's winning margin over the largest squared norm involved (the
    trainer tests' rule; n_near 1, the closest pair's exact tie to the
    first, the margin to the next pair)."""
    g = (x.double() @ x.double().T).numpy()
    sq = np.diag(g)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * g, 0)
    order = np.argsort(d2, axis=1, kind="stable")[:, 1:2]
    scores = np.take_along_axis(d2, order, axis=1).sum(1)
    w = int(np.argmin(scores))
    r = int(np.argmin(np.where(scores > scores[w], scores, np.inf)))
    involved = {w, r, *order[w], *order[r]}
    return (scores[r] - scores[w]) / max(g[i, i] for i in involved)


def _check_rank(kind, res, case, large, want, bits):
    wstate, wm = want
    got, gm = res["steps"][case, large]
    if kind in BLOCK_KINDS:
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                                   rtol=LOSS_TOL,
                                   err_msg=f"{kind} {case} {large} loss")
    else:
        assert torch.equal(gm["loss"], wm["loss"]), (kind, case, large)
    for k in ("diameter", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{kind} {case} {k}")
    wf = _fields(wstate)
    m_scale = max(float(x.abs().max()) for _, x in tree_paths(wf["m"]))
    for name, rows in got.items():
        if name == "counters":
            assert torch.equal(rows[0], wstate.opt_state.step)
            assert torch.equal(rows[1], wstate.step)
            continue
        leaves = [x for _, x in tree_paths(wf[name])]
        scale = max(float(x.abs().max()) for x in leaves)
        if name == "v":
            scale = max(scale, m_scale)
        for (path, block, idx), w in zip(rows, leaves):
            wb = w if idx is None else w[tuple(slice(*i) for i in idx)]
            what = f"{kind} {CASES[case]} {large} {name} {path}"
            if bits or name == "prev":
                assert torch.equal(block, wb), what
            else:
                np.testing.assert_allclose(block, wb, rtol=0,
                                           atol=STATE_TOL * scale,
                                           err_msg=what)


@pytest.mark.parametrize("kind", list(STEP_MESHES))
def test_placed_step_matches_one_process(ranks, kind):
    """Every case on every rank against the one-process step: the counters
    bit for bit; where nothing is split the losses and the trimmed mean's
    states (and on the one-rank mesh every state) bit for bit; on the
    rows and blocks ("data", "pod") the losses within LOSS_TOL; the other
    states within STATE_TOL of their largest entry; Krum's margins first,
    and its distances symmetric on every rank."""
    want, stacks = _one_process(kind)
    K = _K(kind)
    for x in stacks:
        if K > 2:
            assert _krum_margin(x) > 1e-4
    for res in ranks[kind]:
        for d2 in res["d2"]:
            assert torch.equal(d2, d2.T)
        for case, large in want:
            bits = kind == "one" or (CASES[case][0] == "trimmed_mean"
                                     and kind not in BLOCK_KINDS)
            _check_rank(kind, res, case, large, want[case, large], bits)


@pytest.mark.parametrize("kind", list(STEP_MESHES))
def test_placed_step_collectives_and_placements(ranks, kind):
    """Only ``all_gather``s (none on the one-rank mesh) and no operator
    dispatched on a DTensor; every rank's state leaves carry the
    placements of ``fed_state_shardings`` (the K rows over the federation
    dimensions, "model" and the layer stack as the rules say)."""
    _, tcfg = _cfgs(kind)
    _, _, shape, names, _ = STEP_MESHES[kind]
    mesh = tsh.AbstractMesh(shape, names)
    lead = (_K(kind),)
    want = [(p, tsh.placements(tsh.param_spec(
        tcfg, p, torch.empty(lead + tuple(x.shape), device="meta"), mesh,
        stacked=True), mesh))
        for p, x in tree_paths(tmodel.init_params(tcfg, 0, device="meta"))]
    for res in ranks[kind]:
        assert res["dtensor_ops"] == []
        if kind == "one":
            assert res["comm"] == {}
        else:
            assert set(res["comm"]) == {"c10d.allgather_"}, res["comm"]
        assert res["placements"] == want


def test_layout_hints_under_a_mesh(ranks):
    """Under a (2, 2) mesh ``shard_hint`` puts a tensor every rank holds
    whole on the spec's placements, each rank its block; ``maybe_shard``
    does inside ``use_mesh``; a DTensor on other placements is
    redistributed, on the same ones given back."""
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(16.0).reshape(4, 4)
    for res in ranks["data"]:
        i, j = res["coord"]
        rows, cols = slice(2 * i, 2 * i + 2), slice(2 * j, 2 * j + 2)
        (pa, a), (pb, b), (pc, c) = res["hints"]
        assert pa == (Shard(0), Shard(1)) and torch.equal(a, x[rows, cols])
        assert pb == pc == (Replicate(), Shard(1))
        assert torch.equal(b, x[:, cols]) and torch.equal(c, x[:, cols])
        assert res["hints_same"]


def test_placed_step_matches_the_reference(ranks):
    """The trimmed mean under ``large_noise`` on the ``fed_axis="all"``
    mesh (K = 4) against the reference's jitted ``fed_train_step`` from
    the same state and draws, at the trainer tests' tolerances."""
    kind, case = REF_KIND, REF_CASE
    jcfg, _ = _cfgs(kind)
    jfed, _ = _feds(case, _K(kind))
    inp = _inputs(kind)
    step = jax.jit(lambda s, b, m, k, large: jft.fed_train_step(
        jcfg, jfed, s, b, m, k, large=large))
    with shared_loss_trace():
        for large in (True, False):
            wstate, wm = step(jax.tree.map(jnp.asarray, inp["state"]),
                              inp["batch"], jnp.asarray(inp["mask"]),
                              REF_KEY, jnp.asarray(large))
            wf = _fields(wstate)
            m_scale = float(max(np.abs(np.asarray(x)).max()
                                for x in jax.tree.leaves(wf["m"])))
            for res in ranks[kind]:
                got, gm = res["steps"][case, large]
                np.testing.assert_allclose(float(gm["loss"]),
                                           float(wm["loss"]), rtol=LOSS_RTOL)
                for name, rows in got.items():
                    if name == "counters":
                        np.testing.assert_array_equal(
                            rows[0], np.asarray(wstate.opt_state.step))
                        continue
                    leaves = [np.asarray(x) for _, x in _jpaths(wf[name])]
                    scale = max(np.abs(x).max() for x in leaves)
                    if name == "v":
                        scale = max(scale, m_scale)
                    for (path, block, idx), w in zip(rows, leaves):
                        wb = w if idx is None else w[tuple(
                            slice(*i) for i in idx)]
                        np.testing.assert_allclose(
                            block, wb, rtol=0, atol=STATE_RTOL * scale,
                            err_msg=f"{large} {name} {path}")
