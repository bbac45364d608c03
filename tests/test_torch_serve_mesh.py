"""The mesh-sharded serving programs, ``repro_torch.distributed.serving``'s
``ServeFns`` and ``make_serve_fns``, on the CPU.

* ``ServeFns``: its fields, ``specs`` and the legacy unpack's warning.
* The specs against the reference's ``make_serve_fns`` (on a
  ``jax.sharding.AbstractMesh``; the port's ``AbstractMesh``), every
  reduced config on (1, 1), (2, 2) and (2, 2, 2) meshes, with a batch
  that divides the batch dimensions and a batch of 1 (replicated), a
  context over 65536 (the window ring) and a short one.
* Gloo ranks (:mod:`torch_ranks`), spawned once per process group in a
  module fixture: a one-rank (1, 1) mesh, (data, model) = (1, 2) and
  (2, 1) over two ranks and (2, 2) over four. Every rank prefills B = 2
  prompts of 11 positions into a ring of W = 24 and takes 3 decode
  steps (seeded tokens) for reduced Llama-3.2-1B, DeepSeek-V2-Lite (MLA
  on blocks of its heads, MoE with experts that divide: expert-parallel;
  the MLA variants are in ``test_torch_mla_blocks.py``), Hymba-1.5B
  (hybrid), xLSTM-350M (SSM), Pixtral-12B (a frontend, with
  ``prefix_embeds``), Grok-1 (expert-parallel, its layers split over
  "data") and the
  variants of :data:`VARIANTS`: Llama with one KV head (``wk``/``wv``
  gathered per layer, K and V split on the ring W), Grok-1 with 3
  experts (split on ``d_ff``: column- then row-parallel), Llama with 6
  query heads over 3 KV heads (a block of 3 query heads straddles a KV
  group) and with 3 query heads (cut by the split: attention whole),
  from weights made by the reference and carried over by
  ``convert.model_params_from_jax``. Decode steps write ring slots 11,
  12 and 13, on both sides of a W split in two. Between them the cases
  reach every use of ``sharding.serve_use``.

  - The one-rank mesh against the reference's ``make_serve_fns`` on a
    (1, 1) JAX mesh: logits within ``LOGIT_TOL``, the caches within
    ``CACHE_TOL`` (the model tests' tolerances), ``pos`` and
    ``slot_pos`` equal, every routing margin above ``ROUTE_MARGIN``.
  - Every rank against the port's one-process ``model.prefill`` and
    ``decode_step`` (one thread, as the ranks): its logit rows and its
    cache blocks after the prefill and after decode step 3 within
    ``RANK_TOL`` of their largest entry (the matmuls of a rank's rows
    and blocks are other shapes than the whole batch's, and partial
    products are summed over the ranks); on the one-rank mesh bit for
    bit.
  - Every rank of a "model" group holds the same bits: its logits and
    every cache leaf "model" does not split; a repeated run on the
    meshes where "model" splits is bit-identical.
  - Only ``all_gather``s, each the one ``analysis.serve_gathers`` reckons
    for the call, in order, its bytes and group size (none where no
    mesh dimension of more than one rank splits a leaf); none gathers a
    parameter leaf that ``serve_use`` marks as used on blocks; no
    operator dispatched on a DTensor.
  - Each rank's peak of new bytes (``analysis.memcheck.LiveBytes``)
    across each call within what the call returns new, the dry run's
    ``gathered_bytes`` of its plan and an allowance (the activations the
    one-process route holds across the same call, and one more of the
    call's largest gathers), and under the whole parameter tree's
    bytes.
"""
import contextlib
import dataclasses
import functools
import gc
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.distributed import serving as jserving  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.analysis.memcheck import LiveBytes  # noqa: E402
from repro_torch.carriers import placed  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.distributed import serving as tserving  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

from torch_parity import routing_margins  # noqa: E402
from torch_ranks import CollectiveWatch, Meshes  # noqa: E402

torch.set_num_threads(2)

#: the model tests' tolerances (tests/test_torch_models.py)
LOGIT_TOL, CACHE_TOL, ROUTE_MARGIN = 2e-5, 5e-5, 1e-5
#: a rank's logits and cache blocks against the one-process route, as a
#: share of the largest entry: a rank's matmuls run on its rows and its
#: blocks, other shapes than the whole batch's and whole leaves, and
#: partial products are summed over the ranks, so f32 sums run in other
#: orders (the reduced configs' gaps measured 1.1e-06 to 2.4e-06 on
#: (2, 1) and (2, 2) with whole leaves)
RANK_TOL = 1e-5
#: the variants: (the reduced config they change, the fields replaced;
#: "moe" replaces fields of the MoE config)
VARIANTS = {"llama_ring": ("llama3_2_1b", {"n_kv_heads": 1}),
            "grok_odd": ("grok_1_314b", {"moe": {"n_experts": 3}}),
            "heads_straddle": ("llama3_2_1b", {"n_heads": 6,
                                               "n_kv_heads": 3,
                                               "head_dim": 32}),
            "heads_cut": ("llama3_2_1b", {"n_heads": 3, "n_kv_heads": 1,
                                          "head_dim": 64})}
#: the served configs: reduced, and the variants
CASES = ["llama3_2_1b", "deepseek_v2_lite_16b", "hymba_1_5b", "xlstm_350m",
         "pixtral_12b", "grok_1_314b"] + list(VARIANTS)
B, PROMPT, W, STEPS = 2, 11, 24, 3
#: the rank meshes: (data, model) shape; the process group each runs in
MESHES = {"one": (1, 1), "d12": (1, 2), "d21": (2, 1), "d22": (2, 2)}
GROUPS = {"one": ("one",), "two": ("d12", "d21"), "four": ("d22",)}
#: the spec meshes
SPEC_MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]


def _spec(s):
    return tuple(getattr(s, "spec", s))


def _jpaths(tree):
    return [("/".join(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# ServeFns and the specs
# ---------------------------------------------------------------------------

def test_servefns_dataclass_and_shim():
    """The reference's ``test_servefns_dataclass_and_shim`` on the port:
    callable programs, the three shardings, the legacy ``specs`` and the
    deprecated tuple unpacking."""
    cfg = reduced(get_config("llama3_2_1b"))
    fns = tserving.make_serve_fns(cfg, tsh.AbstractMesh((1, 1), (
        "data", "model")), batch=2, seq_len=16)
    assert callable(fns.prefill) and callable(fns.decode)
    assert set(fns.shardings) == {"params", "cache", "batch_spec"}
    assert fns.specs["params_shape"] is fns.params_shape
    assert fns.specs["cache"] is fns.shardings["cache"]
    assert fns.batch_spec == fns.shardings["batch_spec"] == ("data",)
    assert all(x.device.type == "meta" for _, x in
               tree_paths((fns.params_shape, fns.cache_shape)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        fns.prefill = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pf, dc, specs = fns              # legacy tuple unpacking
    assert pf is fns.prefill and dc is fns.decode
    assert specs == fns.specs
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch):
    """Parameter, cache and batch specs and the shapes, for batches that
    divide and a batch of 1, a short context and one over 65536."""
    jc, tc = jreduced(jget_config(arch)), reduced(get_config(arch))
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    for shape, names in SPEC_MESHES:
        jm, tm = JAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
        for batch, seq in ((8, 16), (1, 70000)):
            what = f"{arch} {shape} batch {batch} seq {seq}"
            j = jserving.make_serve_fns(jc, jm, batch, seq, key=key)
            t = tserving.make_serve_fns(tc, tm, batch, seq)
            assert t.batch_spec == _spec(j.batch_spec), what
            for name, jtree, ttree in (
                    ("params", j.params_shape, t.params_shape),
                    ("cache", j.cache_shape, t.cache_shape)):
                jl, tl = _jpaths(jtree), tree_paths(ttree)
                assert [(p, tuple(x.shape)) for p, x in jl] == \
                    [(p, tuple(x.shape)) for p, x in tl], what
                jspecs = [_spec(s) for s in
                          jax.tree.leaves(j.shardings[name])]
                tspecs = [s for _, s in tree_paths(t.shardings[name])]
                assert tspecs == jspecs, f"{what} {name}"
            assert t.cache_shape["slot_pos"].shape[0] == \
                jserving.serve_cache_len(jc, seq)


#: serve_use at the published widths: (arch, mesh shape, {leaf path: use})
USE_CASES = [
    ("grok_1_314b", (16, 16), {
        "blocks/attn/wq": "cols", "blocks/attn/wk": "gather",
        "blocks/attn/wo": "rows", "blocks/mlp/w_gate": "cols",
        "blocks/mlp/w_down": "rows", "blocks/mlp/router": "whole",
        "embed": "vocab", "lm_head": "cols", "final_norm": "whole"}),
    ("grok_1_314b", (1, 2), {
        "blocks/attn/wk": "cols", "blocks/mlp/w_gate": "experts",
        "blocks/mlp/w_down": "experts"}),
    ("qwen2_7b", (16, 16), {
        "blocks/attn/wq": "gather", "blocks/attn/bq": "gather",
        "blocks/attn/wo": "gather", "blocks/mlp/w_up": "cols",
        "blocks/mlp/w_down": "rows"}),
    ("deepseek_v2_lite_16b", (16, 16), {
        "blocks/attn/wq": "cols", "blocks/attn/w_uk": "cols",
        "blocks/attn/w_uv": "cols", "blocks/attn/wo": "rows",
        "blocks/attn/w_dkv": "whole", "blocks/mlp/w_gate": "experts",
        "blocks/mlp/shared/w_gate": "cols",
        "blocks/mlp/shared/w_down": "rows"}),
    ("minicpm3_4b", (16, 16), {"blocks/attn/w_uq": "gather"}),
    ("minicpm3_4b", (1, 2), {
        "blocks/attn/w_uq": "cols", "blocks/attn/wo": "rows",
        "blocks/attn/w_dq": "whole"}),
    ("xlstm_350m", (16, 16), {"embed": "whole", "blocks/m/w_up": "whole"}),
    ("llama3_2_1b", (1, 1), {"embed": "whole", "blocks/attn/wq": "whole"}),
]


@pytest.mark.parametrize("arch,shape,want", USE_CASES)
def test_serve_use_at_published_widths(arch, shape, want):
    """``serve_use``'s rule on the full configs: head-, expert-, d_ff- and
    vocab-parallel leaves, MLA's heads among them, and the ones gathered
    whole (KV heads or query heads that do not divide: MiniCPM3-4B's 40
    over 16)."""
    cfg = get_config(arch)
    mesh = tsh.AbstractMesh(shape, ("data", "model"))
    shapes = tmodel.init_params(cfg, 0, device="meta")
    specs = tsh.param_shardings(cfg, shapes, mesh)
    uses = dict(tree_paths(tsh.serve_uses(cfg, shapes, specs, mesh)))
    assert set(uses.values()) <= set(tsh.SERVE_USES)
    assert {p: uses[p] for p in want} == want


@pytest.mark.parametrize("H,Hkv,lo,hi,want", [
    (48, 8, 0, 3, [0]), (48, 8, 3, 6, [0]), (48, 8, 45, 48, [7]),
    (6, 3, 0, 3, [0, 0, 1]), (6, 3, 3, 6, [1, 2, 2]), (4, 1, 2, 4, [0]),
    (8, 4, 0, 4, [0, 1]), (32, 8, 8, 16, [2, 3])])
def test_kv_heads_for_a_block_of_query_heads(H, Hkv, lo, hi, want):
    """The KV heads a block of query heads reads: whole groups (or a part
    of one) as the heads themselves, a block across groups one per query
    head."""
    from repro_torch.models.attention import kv_heads_for
    cfg = dataclasses.replace(reduced(get_config("llama3_2_1b")),
                              n_heads=H, n_kv_heads=Hkv)
    assert kv_heads_for(cfg, lo, hi).tolist() == want


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def _cfgs(case, variants=VARIANTS):
    """(reference config, port config) of a case: reduced, with a
    variant's fields replaced ("moe" and "mla" replace fields of those
    configs)."""
    arch, fields = variants.get(case, (case, {}))
    out = []
    for c in (jreduced(jget_config(arch)), reduced(get_config(arch))):
        kw = dict(fields)
        for sub in ("moe", "mla"):
            if sub in kw:
                kw[sub] = dataclasses.replace(getattr(c, sub), **kw[sub])
        out.append(dataclasses.replace(c, **kw))
    return tuple(out)


_J_INIT = jax.jit(jmodel.init_params, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _inputs(case):
    return _inputs_of(_cfgs(case)[0], CASES.index(case))


def _inputs_of(jc, seed):
    """The reference's weights (numpy) and the seeded prompt, prefix
    embeddings and decode tokens of one case (reference config ``jc``)."""
    params = jax.tree.map(np.asarray, _J_INIT(jc, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(seed)
    P = jc.n_prefix_embeds if jc.frontend != "none" else 0
    toks = rng.integers(0, jc.vocab_size, (B, PROMPT - P)).astype(np.int32)
    pe = rng.standard_normal((B, P, jc.d_model)).astype(np.float32) \
        if P else None
    steps = rng.integers(0, jc.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return {"params": params, "tokens": toks, "prefix": pe, "steps": steps}


def _blocks(cache):
    """A (placed) cache's leaves: (path, the rank's block, its global
    index, or None for a plain leaf)."""
    out = []
    for path, x in tree_paths(cache):
        lay = placed.layout(x)
        idx = None if lay is None else [(s.start, s.stop)
                                        for s in lay.index()]
        out.append((path, placed.local(x).clone(), idx))
    return out


@contextlib.contextmanager
def _measured(out, key="peak"):
    """``LiveBytes`` on the CPU over the block, ``out[key]`` its peak, with
    Python's cycle collector off inside (a collection at a random moment
    would free cyclic garbage early in one run and not in another)."""
    gc.collect()
    gc.disable()
    try:
        with LiveBytes("cpu") as live:
            yield
    finally:
        gc.enable()
    out[key] = live.peak


def _new_bytes(*trees) -> int:
    """The bytes of the tensors a call returns new (each placed leaf's
    block)."""
    return sum(placed.local(x).nbytes for t in trees
               for _, x in tree_paths(t))


def _serve(tcfg, mesh, inp, out):
    """Prefill then STEPS decode steps through ``make_serve_fns`` on
    ``mesh``, the params placed first: the rank's logit rows, its cache
    blocks after the prefill and after the last step, the smallest
    routing margin and, per call, its ``all_gather``s (under
    ``CollectiveWatch``, whose counts join ``out``), its peak of new
    bytes (``LiveBytes``) and the bytes it returns new."""
    fns = tserving.make_serve_fns(tcfg, mesh, B, W)
    params = tsh.place_tree(model_params_from_jax(inp["params"], tcfg,
                                                  device="cpu"),
                            fns.shardings["params"], mesh)
    args = [torch.from_numpy(inp["tokens"])]
    if inp["prefix"] is not None:
        args.append(torch.from_numpy(inp["prefix"]))
    res = {"logits": [], "calls": []}

    def call(fn, *a):
        rec = {}
        with _measured(rec), CollectiveWatch(rec):
            logits, cache = fn(*a)
        for k in ("comm", "dtensor_ops"):
            if k == "comm":
                for op, n in rec[k].items():
                    out[k][op] = out[k].get(op, 0) + n
            else:
                out[k] += rec[k]
        res["calls"].append(rec)
        res["logits"].append(placed.local(logits).clone())
        return logits, cache

    out.setdefault("comm", {})
    out.setdefault("dtensor_ops", [])
    with routing_margins() as margins:
        logits, cache = call(fns.prefill, params, *args)
        res["calls"][0]["new"] = _new_bytes(logits, cache)
        res["prefill"] = _blocks(cache)
        for tok in inp["steps"]:
            logits, cache = call(fns.decode, params, torch.from_numpy(tok),
                                 cache)
            res["calls"][-1]["new"] = _new_bytes(logits, cache["pos"])
    res["rows"] = placed.layout(logits).block(0)
    res["coord"] = tuple(mesh.get_coordinate())
    res["last"] = _blocks(cache)
    res["margin"] = min(margins, default=1.0)
    return res


def _same_bits(a, b) -> list:
    """Where two runs' results differ: logits, cache blocks."""
    bad = [f"logits {i}" for i, (x, y) in enumerate(zip(a["logits"],
                                                        b["logits"]))
           if not torch.equal(x, y)]
    for step in ("prefill", "last"):
        bad += [f"{step} {p}" for (p, x, _), (_, y, _) in zip(a[step],
                                                             b[step])
                if not torch.equal(x, y)]
    return bad


def _serve_kind(kind, cfgs, inputs):
    """On a spawned rank: every case of ``cfgs`` (case -> config) served
    on mesh ``kind`` from ``inputs`` (case -> its inputs), and served
    again where "model" splits."""
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*MESHES[kind], device_type="cpu")
    res = {"comm": {}, "dtensor_ops": [], "cases": {}, "repeat": {}}
    for case, tcfg in cfgs.items():
        got = res["cases"][case] = _serve(tcfg, mesh, inputs[case], res)
        if MESHES[kind][1] > 1:
            res["repeat"][case] = _same_bits(
                got, _serve(tcfg, mesh, inputs[case], {}))
    return res


def _rank_main(rank, world, port, group, inp, dst):
    """One spawned rank: join the gloo group, build each of the group's
    meshes, serve every case on it, write the results."""
    import pickle
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        with open(inp, "rb") as f:
            inputs = pickle.load(f)
        cfgs = {case: _cfgs(case)[1] for case in CASES}
        torch.save({kind: _serve_kind(kind, cfgs, inputs)
                    for kind in GROUPS[group]}, dst)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The ranks of every group, started when the module starts (they run
    beside the spec tests) and stopped when it ends."""
    inputs = {case: _inputs(case) for case in CASES}
    meshes = Meshes("test_torch_serve_mesh",
                    {g: int(np.prod(MESHES[kinds[0]]))
                     for g, kinds in GROUPS.items()},
                    {g: inputs for g in GROUPS},
                    str(tmp_path_factory.mktemp("serve_mesh")))
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
def _one_process(case):
    return _one_process_of(_cfgs(case)[1], _inputs(case))


def _one_process_of(tcfg, inp):
    """The port's one-process route from the same inputs, on one thread
    as the ranks: the logits of the prefill and each step, the cache
    after the prefill and after the last step, and each call's
    activations (its peak of new bytes less what it returns new)."""
    params = model_params_from_jax(inp["params"], tcfg, device="cpu")
    pe = None if inp["prefix"] is None else torch.from_numpy(inp["prefix"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        peak = {}
        with _measured(peak):
            logits, cache = tmodel.prefill(
                tcfg, params, torch.from_numpy(inp["tokens"]), pe,
                cache_len=tserving.serve_cache_len(tcfg, W))
        out = {"logits": [logits.clone()],
               "prefill": dict((p, x.clone()) for p, x in tree_paths(cache)),
               "act": [peak["peak"] - _new_bytes(logits, cache)]}
        for tok in inp["steps"]:
            with _measured(peak):
                logits, cache = tmodel.decode_step(
                    tcfg, params, torch.from_numpy(tok), cache)
            out["act"].append(peak["peak"] - _new_bytes(logits,
                                                        cache["pos"]))
            out["logits"].append(logits.clone())
        out["last"] = dict(tree_paths(cache))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c not in VARIANTS])
def test_one_rank_mesh_matches_the_reference(ranks, case):
    """The one-rank mesh's prefill and 3 decode steps against the
    reference's ``make_serve_fns`` on a (1, 1) JAX mesh, the same weights
    and tokens."""
    jcfg, _ = _cfgs(case)
    inp = _inputs(case)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fns = jserving.make_serve_fns(jcfg, mesh, B, W)
    params = jax.tree.map(jnp.asarray, inp["params"])
    args = [jnp.asarray(inp["tokens"])]
    if inp["prefix"] is not None:
        args.append(jnp.asarray(inp["prefix"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # donation is a no-op here
        want = [fns.prefill(params, *args)]
        for tok in inp["steps"]:
            want.append(fns.decode(params, jnp.asarray(tok), want[-1][1]))
    (res,) = ranks["one"]
    got = res["cases"][case]
    assert got["margin"] > ROUTE_MARGIN
    for g, (w, _) in zip(got["logits"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_TOL, err_msg=case)
    wcache = want[-1][1]
    wleaves = dict(_jpaths(wcache))
    assert [p for p, _, _ in got["last"]] == list(wleaves)
    for path, block, _ in got["last"]:
        tol = 0 if path in ("pos", "slot_pos") else CACHE_TOL
        np.testing.assert_allclose(block.numpy(), np.asarray(wleaves[path]),
                                   rtol=0, atol=tol, err_msg=f"{case} {path}")


def _check_blocks(kind, case, blocks, want, exact):
    scale = max(float(x.abs().max()) for p, x in want.items()
                if x.is_floating_point())
    for path, block, idx in blocks:
        w = want[path]
        wb = w if idx is None else w[tuple(slice(*i) for i in idx)]
        what = f"{kind} {case} {path}"
        if exact or not w.is_floating_point():
            assert torch.equal(block, wb), what
        else:
            np.testing.assert_allclose(block, wb, rtol=0,
                                       atol=RANK_TOL * scale, err_msg=what)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_ranks_match_one_process(ranks, kind, case):
    """Each rank's logit rows after the prefill and every step, and its
    cache blocks after the prefill and after decode step 3, against the
    one-process route (bit for bit on the one-rank mesh)."""
    _check_ranks(ranks[kind], kind, case, _one_process(case))


def _check_ranks(results, kind, case, want):
    """:func:`test_ranks_match_one_process`'s check of one case's ranks
    against ``want``, its :func:`_one_process_of` route."""
    exact = kind == "one"
    for res in results:
        got = res["cases"][case]
        lo, hi = got["rows"]
        for g, w in zip(got["logits"], want["logits"]):
            w = w[lo:hi]
            if exact:
                assert torch.equal(g, w), (kind, case)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=RANK_TOL * float(w.abs().max()),
                    err_msg=f"{kind} {case}")
        _check_blocks(kind, case, got["prefill"], want["prefill"], exact)
        _check_blocks(kind, case, got["last"], want["last"], exact)


def _plans(tcfg, mesh):
    """The reckoned collectives of the prefill and of one decode step of
    a case on ``mesh``: ``analysis.serve_gathers``'s entries."""
    fns = tserving.make_serve_fns(tcfg, mesh, B, W)
    P = tcfg.n_prefix_embeds if tcfg.frontend != "none" else 0
    rows = B // mesh.shape[0]
    args = (tcfg, fns.params_shape, fns.shardings["params"], mesh, rows)
    return (analysis.serve_gathers(*args, PROMPT - P, P),
            analysis.serve_gathers(*args, 1, 0, fns.cache_shape,
                                fns.shardings["cache"]))


@pytest.mark.parametrize("kind", list(MESHES))
def test_collectives_and_placements(ranks, kind):
    """Only ``all_gather``s, each call's the ones ``serve_gathers`` reckons
    in order, bytes and group size (none where no mesh dimension of more
    than one rank splits a leaf), none of a parameter leaf that
    ``serve_use`` marks as used on blocks, and no DTensor operator;
    every cache block the shape of ``cache_shardings``' placements (K
    and V of one KV head, and MLA's latent, split on the ring W)."""
    cfgs = {case: _cfgs(case)[1] for case in CASES}
    _check_gathers(ranks[kind], kind, cfgs)
    mesh = tsh.AbstractMesh(MESHES[kind], ("data", "model"))
    for case in ("llama_ring", "deepseek_v2_lite_16b"):
        if MESHES[kind][1] > 1:
            specs = tsh.cache_shardings(cfgs[case], tmodel.init_cache(
                cfgs[case], B, W, device="meta"), mesh)
            assert all(s[2] == "model" for _, s in
                       tree_paths(specs["blocks"]))


def _check_gathers(results, kind, cfgs):
    """:func:`test_collectives_and_placements`' check of the ranks of
    mesh ``kind`` for the cases of ``cfgs`` (case -> config): only the
    reckoned ``all_gather``s, a leaf gathered whole only where
    ``serve_use`` marks it "gather" (never an MLA leaf whose heads the
    split keeps whole), and every cache block the shape of its
    placements."""
    mesh = tsh.AbstractMesh(MESHES[kind], ("data", "model"))
    for res in results:
        assert res["dtensor_ops"] == []
        assert set(res["comm"]) <= {"c10d.allgather_"}, res["comm"]
        for case, tcfg in cfgs.items():
            prefill, decode = _plans(tcfg, mesh)
            calls = res["cases"][case]["calls"]
            assert [tuple(g) for g in calls[0]["gathers"]] == \
                [(b, g) for _, b, g in prefill], (kind, case, "prefill")
            for i, c in enumerate(calls[1:]):
                assert [tuple(g) for g in c["gathers"]] == \
                    [(b, g) for _, b, g in decode], (kind, case, i)
            fns = tserving.make_serve_fns(tcfg, mesh, B, W)
            uses = dict(zip([p for p, _ in tree_paths(fns.params_shape)],
                            [u for _, u in tree_paths(tsh.serve_uses(
                                tcfg, fns.params_shape,
                                fns.shardings["params"], mesh))]))
            for (what, path), _, g in prefill + decode:
                if what == "whole":
                    assert uses[path] == "gather", (kind, case, path)
                    assert tcfg.mla is None or tcfg.n_heads % g, \
                        (kind, case, path)
                elif what == "layer":    # FSDP: the layers over "data"
                    assert tcfg.fsdp_layers and g == MESHES[kind][0]
            if MESHES[kind] == (1, 1):
                assert prefill == decode == []
        for case, tcfg in cfgs.items():
            cshape = tmodel.init_cache(tcfg, B, W, device="meta")
            specs = tsh.cache_shardings(tcfg, cshape, mesh)
            for (path, block, idx), (_, t), (_, s) in zip(
                    res["cases"][case]["last"], tree_paths(cshape),
                    tree_paths(specs)):
                if not len(s):
                    assert idx is None, (kind, case, path)
                    continue
                lay = placed.Layout.of(t.shape, mesh,
                                       tsh.placements(s, mesh))
                assert tuple(block.shape) == tuple(
                    n // lay.parts(d) for d, n in enumerate(t.shape)), \
                    (kind, case, path)


@pytest.mark.parametrize("kind", list(MESHES))
def test_model_group_holds_the_same_bits(ranks, kind):
    """The ranks of each "model" group (one data coordinate) hold
    bit-identical logits after every call and bit-identical cache leaves
    wherever "model" does not split them; on the meshes where "model"
    splits, each case's repeated run is bit-identical."""
    _check_same_bits(ranks[kind], kind, {case: _cfgs(case)[1]
                                         for case in CASES})


def _check_same_bits(results, kind, cfgs):
    """:func:`test_model_group_holds_the_same_bits`' check of the ranks of
    mesh ``kind`` for the cases of ``cfgs`` (case -> config)."""
    mesh = tsh.AbstractMesh(MESHES[kind], ("data", "model"))
    for case, tcfg in cfgs.items():
        specs = tsh.cache_shardings(tcfg, tmodel.init_cache(
            tcfg, B, W, device="meta"), mesh)
        split = {p for p, s in tree_paths(specs)
                 if any("model" in (e if isinstance(e, tuple) else (e,))
                        for e in s)}
        groups = {}
        for res in results:
            groups.setdefault(res["cases"][case]["coord"][0], []).append(
                res["cases"][case])
        for members in groups.values():
            first = members[0]
            for other in members[1:]:
                bad = [b for b in _same_bits(first, other)
                       if b.split(" ")[-1] not in split
                       or b.startswith("logits")]
                assert bad == [], (kind, case, bad)
        for res in results:
            assert res["repeat"].get(case, []) == [], (kind, case)


@pytest.mark.parametrize("kind", list(MESHES))
def test_peak_bytes_within_the_reckoning(ranks, kind):
    """Each rank's peak of new bytes across each call within what the
    call returns new, the dry run's ``gathered_bytes`` of its plan and
    the activation allowance: the one-process route's own peak across
    the same call on the whole batch, less what that call returns new,
    and the call's largest ``all_gather`` once more (gloo's worker thread
    may drop a finished gather's buffers only after the next begins, a
    race seen under load); and under the whole parameter tree's
    bytes."""
    _check_peaks(ranks[kind], kind,
                 {case: _cfgs(case)[1] for case in CASES},
                 {case: _one_process(case)["act"] for case in CASES})


def _check_peaks(results, kind, cfgs, acts):
    """:func:`test_peak_bytes_within_the_reckoning`'s check of the ranks
    of mesh ``kind`` for the cases of ``cfgs`` (case -> config), ``acts``
    each case's one-process activations per call."""
    mesh = tsh.AbstractMesh(MESHES[kind], ("data", "model"))
    for case, tcfg in cfgs.items():
        tree = sum(x.nbytes for _, x in tree_paths(tmodel.init_params(
            tcfg, 0, device="meta")))
        plans = _plans(tcfg, mesh)
        act = acts[case]
        for res in results:
            for i, c in enumerate(res["cases"][case]["calls"]):
                plan = plans[min(i, 1)]
                bound = c["new"] + dryrun.gathered_bytes(plan) + act[i] \
                    + max((b for _, b, _ in plan), default=0)
                assert c["peak"] <= bound, (kind, case, i, c["peak"], bound)
                assert c["peak"] < tree, (kind, case, i, c["peak"], tree)
