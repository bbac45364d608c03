"""MLA on blocks of its heads over gloo ranks on the CPU, in serving
(``make_serve_fns``) and in the tree trainer's step on a placed state
(``fed_train_step`` -> ``_estimate_blocks``): the cases that
``test_torch_serve_mesh.py`` and ``test_torch_fed_blocks.py`` do not
hold, checked by those modules' own rules and tolerances.

Where "model" of size m divides the heads, a rank runs H/m of them: the
query projection (``wq``, or ``w_uq`` after the whole ``w_dq``),
``w_uk`` and ``w_uv`` on their head-major columns, ``wo`` on its rows
summed in rank order; ``w_dkv`` and ``w_dq`` whole. Elsewhere the split
leaves are gathered whole for their layer.

* Serving, on (data, model) = (1, 2) and (2, 1) over two ranks and
  (2, 2) over four, B = 2 prompts of 11 positions, a ring of 24, 3
  decode steps, weights made by the reference:

  - ``mla_wq``: reduced DeepSeek-V2-Lite with ``q_lora_rank`` 0, the
    full model's ``wq`` route, absorbed decode (the config's own);
  - ``mla_naive``: the same with the decode that expands K and V from
    the latent (``mla_absorb=False``);
  - ``mla_heads_cut``: 3 heads, which m = 2 cuts: every split MLA leaf
    gathered whole for its layer, as today.

  Every rank's logit rows and cache blocks within ``RANK_TOL`` of the
  port's one-process route, the ranks of a "model" group and a repeated
  run bit-identical, only the ``all_gather``s ``serve_gathers`` reckons
  (no attention leaf gathered whole where the heads divide, one
  ``("sum", "attn")`` a layer), each rank's peak within the reckoning.
* The trainer on (2, 2), from a mid-run state, both PAGE coins:

  - ``minicpm``: reduced MiniCPM3-4B (dense MLA through ``w_dq`` ->
    ``w_uq``, ``d_ff`` columns beside the head blocks; its ``fed_axis``
    "pod": K = 1);
  - ``deepseek_wq``: reduced DeepSeek-V2-Lite with ``q_lora_rank`` 0.

  v, θ and the loss within ``V_TOL``, ``THETA_TOL`` and ``LOSS_TOL`` of
  the one-process step, the ranks of a "model" group bit-identical,
  only the ``all_gather``s ``fed_step_gathers`` reckons (the latent's
  and the query input's conjugate sums, no leaf gathered whole), each
  rank's peak within the reckoning.

Both groups of ranks start when the module starts, on one thread each.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import test_torch_fed_blocks as fb  # noqa: E402
import test_torch_serve_mesh as sm  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402

from torch_ranks import Meshes  # noqa: E402

#: the served variants of reduced DeepSeek-V2-Lite
SERVE = {"mla_wq": ("deepseek_v2_lite_16b", {"mla": {"q_lora_rank": 0}}),
         "mla_naive": ("deepseek_v2_lite_16b", {"mla": {"q_lora_rank": 0},
                                                "mla_absorb": False}),
         "mla_heads_cut": ("deepseek_v2_lite_16b", {"n_heads": 3,
                                                    "n_kv_heads": 3})}
#: the trainer's cases: (arch, config overrides)
TRAIN = {"minicpm": ("minicpm3-4b", {}),
         "deepseek_wq": ("deepseek-v2-lite-16b", {"mla": {"q_lora_rank": 0}})}
KINDS = ("d12", "d21", "d22")
#: the process groups: their serving meshes (the four ranks then train)
GROUPS = {"two": ("d12", "d21"), "four": ("d22",)}
#: the attention leaves that "model" splits
SPLIT_ATTN = {"blocks/attn/" + n for n in ("wq", "w_uq", "w_uk", "w_uv",
                                           "wo")}


def _serve_cfg(case):
    return sm._cfgs(case, SERVE)[1]


def _serve_inputs(case):
    return sm._inputs_of(sm._cfgs(case, SERVE)[0], 100 + list(SERVE).index(
        case))


def _train_cfg(name):
    return fb._cfg(name, TRAIN)


def _rank_main(rank, world, port, group, inp, dst):
    """One spawned rank: join the gloo group, serve every variant on each
    of the group's meshes, and on the four ranks take each trainer case's
    steps; write the results."""
    import pickle
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        with open(inp, "rb") as f:
            inputs = pickle.load(f)
        cfgs = {case: _serve_cfg(case) for case in SERVE}
        out = {kind: sm._serve_kind(kind, cfgs, inputs["serve"])
               for kind in GROUPS[group]}
        if group == "four":
            mesh = make_debug_mesh(*fb.SHAPE, device_type="cpu")
            out["train"] = {name: fb._rank_case(_train_cfg(name), mesh,
                                                inputs["train"][name])
                            for name in TRAIN}
        torch.save(out, dst)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _inputs():
    return {"serve": {c: _serve_inputs(c) for c in SERVE},
            "train": {n: fb._inputs_of(_train_cfg(n)) for n in TRAIN}}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Both groups' ranks, started when the module starts and stopped when
    it ends."""
    meshes = Meshes("test_torch_mla_blocks", {"two": 2, "four": 4},
                    {g: _inputs() for g in GROUPS},
                    str(tmp_path_factory.mktemp("mla_blocks")))
    try:
        yield meshes
    finally:
        meshes.stop()


@pytest.fixture(scope="module")
def ranks(_started):
    """Serving mesh kind -> the ranks' results, and "train" -> the four
    ranks' trainer results, in rank order."""
    out = _started.results()
    res = {kind: [r[kind] for r in out[g]]
           for g, kinds in GROUPS.items() for kind in kinds}
    res["train"] = [r["train"] for r in out["four"]]
    return res


@functools.lru_cache(maxsize=None)
def _one_process(case):
    return sm._one_process_of(_serve_cfg(case), _inputs()["serve"][case])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(SERVE))
def test_served_ranks_match_one_process(ranks, kind, case):
    """Each rank's logit rows and cache blocks after the prefill and after
    decode step 3 within ``RANK_TOL`` of the one-process route."""
    sm._check_ranks(ranks[kind], kind, case, _one_process(case))


@pytest.mark.parametrize("kind", KINDS)
def test_served_collectives(ranks, kind):
    """Only the reckoned ``all_gather``s, in order; by the plans, where
    "model" splits the heads, a layer gathers no attention leaf whole and
    sums ``wo``'s partials once (``("sum", "attn")``), and where the
    split cuts a head, it gathers each split attention leaf whole and
    sums nothing of the attention."""
    cfgs = {case: _serve_cfg(case) for case in SERVE}
    sm._check_gathers(ranks[kind], kind, cfgs)
    mesh = tsh.AbstractMesh(sm.MESHES[kind], ("data", "model"))
    m = sm.MESHES[kind][1]
    for case, tcfg in cfgs.items():
        names = {p for p, _ in tree_paths(sm.tserving.make_serve_fns(
            tcfg, mesh, sm.B, sm.W).params_shape)}
        for plan in sm._plans(tcfg, mesh):
            whole = [path for (what, path), _, _ in plan if what == "whole"]
            sums = [e for e in plan if e[0] == ("sum", "attn")]
            cut = m > 1 and tcfg.n_heads % m
            assert set(whole) == (SPLIT_ATTN & names if cut else set()), \
                (kind, case, whole)
            assert len(whole) == (4 * tcfg.n_layers if cut else 0)
            assert len(sums) == (tcfg.n_layers if m > 1 and not cut
                                 else 0), (kind, case)


@pytest.mark.parametrize("kind", KINDS)
def test_served_model_group_holds_the_same_bits(ranks, kind):
    """The ranks of a "model" group hold bit-identical logits and unsplit
    cache leaves; a repeated run is bit-identical."""
    sm._check_same_bits(ranks[kind], kind,
                        {case: _serve_cfg(case) for case in SERVE})


@pytest.mark.parametrize("kind", KINDS)
def test_served_peak_within_the_reckoning(ranks, kind):
    """Each rank's peak of new bytes across each call within what it
    returns new, its plan's gathered bytes and the one-process
    activations (``test_torch_serve_mesh``'s bound)."""
    sm._check_peaks(ranks[kind], kind,
                    {case: _serve_cfg(case) for case in SERVE},
                    {case: _one_process(case)["act"] for case in SERVE})


# ---------------------------------------------------------------------------
# The tree trainer's step
# ---------------------------------------------------------------------------

def _train(ranks, name):
    return [r[name] for r in ranks["train"]]


@pytest.mark.parametrize("name", list(TRAIN))
def test_step_matches_one_process(ranks, name):
    """v, θ and the loss of both coins against the one-process step."""
    cfg = _train_cfg(name)
    fb._check_steps(_train(ranks, name), name, cfg, fb._one_process_of(
        cfg, _inputs()["train"][name]), False)


@pytest.mark.parametrize("name", list(TRAIN))
def test_step_model_group_holds_the_same_bits(ranks, name):
    fb._check_same_bits(_train(ranks, name), name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_step_only_the_reckoned_gathers(ranks, name):
    """Only the ``all_gather``s ``fed_step_gathers`` reckons, in order; by
    the plan no leaf gathered whole, and a layer's backward sums the
    latent's partial gradients, then the query input's (``x @ w_dq``, or
    ``x`` for ``wq``)."""
    cfg = _train_cfg(name)
    fb._check_gathers(_train(ranks, name), name, cfg, False)
    mesh, state_shape, state_sh, batch, batch_sh = fb._plan(cfg)
    plan = analysis.estimate_plan(cfg, mesh, state_shape, state_sh, batch,
                                  batch_sh)
    assert not [p for (what, p), _, _ in plan if what == "whole"]
    enters = [what for (kind, what), _, _ in plan if kind == "enter"]
    query = "query" if cfg.mla.q_lora_rank else "attn"
    per_layer = (["mlp"] if cfg.moe is None
                 else ["shared", "router", "mlp"]) + ["latent", query]
    assert enters == ["head"] + per_layer * cfg.n_layers, enters


@pytest.mark.parametrize("name", list(TRAIN))
def test_step_peak_within_the_reckoning(ranks, name):
    """Each rank's peak across the estimate within the reckoning
    (``test_torch_fed_blocks``' bound)."""
    cfg = _train_cfg(name)
    fb._check_peak(_train(ranks, name), name, cfg, fb._activations_of(
        cfg, _inputs()["train"][name]))
