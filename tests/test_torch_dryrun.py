"""The port's dry run and roofline analysis, ``repro_torch.launch.dryrun``
and ``repro_torch.launch.analysis``, on the CPU (the ``meta`` device).

* ``--all`` on the (16, 16) and (2, 16, 16) production meshes: an ``ok``
  record for every architecture × input shape, 80 in all, with the
  reference's field names; ``n_agents`` and ``model_flops_global`` equal
  the reference's functions on the same configs (its ``n_agents`` on a
  ``jax.sharding.AbstractMesh``).
* ``roofline_terms`` and ``route_wire_bytes`` on stated inputs.
* Gloo ranks (:mod:`torch_ranks`): reduced Llama-3.2-1B on (data, model)
  = (1, 2) over two ranks and (2, 2) over four. Each rank runs a prefill
  and a decode through ``make_serve_fns`` and two steps (coin 1, then 0)
  through ``make_fed_step`` (on (1, 2) ``fed_axis="all"``: K = 2, leaves
  whole, Krum under ``sign_flip``; on (2, 2) ``fed_axis="data"``: K = 2
  over "data", leaves over "model", RFA under ``avg_zero`` with
  telemetry), under ``CollectiveWatch``. The bytes each rank holds of
  every argument and returns of every output equal the dry run's
  ``argument_bytes`` and ``output_bytes`` (and a decode's cache its
  ``alias_bytes``), and each collective the route issues, in order,
  equals the one ``serve_gathers`` or ``fed_step_gathers`` reckons for
  the rank's coordinate: its gathered bytes and its group's size, so
  ``route_wire_bytes`` is the route's wire bytes to the byte.

The module imports no JAX at its top, so the ranks start without it.
"""
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.carriers import placed  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                      InputShape, get_config, reduced)
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.distributed import fed_trainer as ft  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_LINK,  # noqa: E402
                                     PEAK_FLOPS_BF16)

from torch_ranks import CollectiveWatch, Meshes  # noqa: E402

#: the rank meshes: (data, model) shape, the federation axis, the
#: aggregator and the attack of the step
MESHES = {"two": ((1, 2), "all", "krum", "sign_flip"),
          "four": ((2, 2), "data", "rfa", "avg_zero")}
B, S = 2, 16
TRAIN = InputShape("train_test", S, 4, "train")


def _records(capsys, tmp_path, multi_pod):
    out = tmp_path / f"dry-{multi_pod}.json"
    argv = ["--all", "--out", str(out)] + (["--multi-pod"] if multi_pod
                                           else [])
    dryrun.main(argv)
    text = capsys.readouterr().out
    recs = json.loads(out.read_text())
    n = len(ARCH_IDS) * len(INPUT_SHAPES)
    assert text.count("[OK ]") == n and "[FAIL]" not in text, text
    assert text.rstrip().endswith(f"{n}/{n} built")
    return recs


def test_all_pairs_on_both_production_meshes(capsys, tmp_path):
    """80 ``ok`` records over the two meshes, each with the reference's
    keys; n_agents and MODEL_FLOPS the reference's."""
    import jax
    from jax.sharding import AbstractMesh as JAbstractMesh
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config
    from repro.distributed.sharding import n_agents as j_n_agents
    from repro.launch.analysis import model_flops as j_model_flops
    del jax
    recs = []
    for multi_pod in (False, True):
        recs += _records(capsys, tmp_path, multi_pod)
    assert len(recs) == 80 and all(r["ok"] for r in recs)
    meshes = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
    for r in recs:
        assert {"arch", "shape", "mesh", "ok", "n_agents", "roofline",
                "collectives", "memory", "total_s"} <= set(r)
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "alias_bytes", "gathered_bytes",
                                    "peak_per_device_gb"}
        jc = jget_config(r["arch"])
        assert r["n_agents"] == j_n_agents(jc, JAbstractMesh(
            *meshes[r["mesh"]]))
        mf = j_model_flops(jc, JSHAPES[r["shape"]])
        assert r["roofline"]["model_flops_global"] == mf
        assert r["roofline"]["flops_per_device"] == pytest.approx(
            mf / math.prod(meshes[r["mesh"]][0]), rel=1e-12)
        assert r["collectives"]["total"] == r["collectives"]["all-gather"]
        m = r["memory"]
        assert m["alias_bytes"] == 0 or r["shape"] in ("decode_32k",
                                                       "long_500k")
        assert m["peak_per_device_gb"] == round(
            (m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
             + m["gathered_bytes"]) / 2**30, 3)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serving_fits_a_card_on_the_production_meshes(multi_pod):
    """Every serving program on (16, 16) and (2, 16, 16) reckons under
    the H100's 80 GB a device: the route holds a rank's blocks and one
    layer's gathered leaves, never the model whole (Grok-1's decode_32k
    659.995 GB a device when every split leaf was gathered whole)."""
    fed = ft.FedConfig()
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            if shape.mode == "train":
                continue
            rec = dryrun.run_one(arch, name, multi_pod, fed)
            assert rec["ok"], rec.get("error")
            assert rec["memory"]["peak_per_device_gb"] * 2**30 < 80e9, \
                (arch, name, rec["memory"])


def test_model_flops_matches_the_reference():
    """``model_flops`` on every config and shape, and an explicit token
    count."""
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config
    from repro.launch.analysis import model_flops as j_model_flops
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert analysis.model_flops(get_config(arch), shape) == \
                j_model_flops(jget_config(arch), JSHAPES[name])
        assert analysis.model_flops(get_config(arch), INPUT_SHAPES[
            "train_4k"], n_tokens=7) == 6.0 * 7 * get_config(
                arch).n_active_params()


def test_roofline_terms_and_wire_bytes():
    """The three terms against the H100 constants by hand, the analytic
    compute term over the scaled cost one, and the ring formula."""
    wire = analysis.route_wire_bytes([(100, 4), (30, 1), (64, 2)])
    assert wire["all-gather"] == 75 + 32 and wire["total"] == 107
    assert wire["counts"]["all-gather"] == 2
    assert wire["gathers"] == [(100, 4), (64, 2)]
    assert all(wire[k] == 0 for k in ("all-reduce", "reduce-scatter",
                                      "all-to-all", "collective-permute"))
    cost = {"flops": 1e12, "bytes accessed": 3.35e9}
    t = analysis.roofline_terms(cost, {"total": 5e9}, 4,
                                model_flops_global=8e12, loop_scale=3)
    assert t["compute_s"] == pytest.approx(2e12 / PEAK_FLOPS_BF16)
    assert t["compute_hlo_s"] == pytest.approx(3e12 / PEAK_FLOPS_BF16)
    assert t["memory_s"] == pytest.approx(3.35e9 / HBM_BW)
    assert t["collective_s"] == pytest.approx(5e9 / NVLINK_BW_PER_LINK)
    assert t["bottleneck"] == "collective"
    assert (t["flops_per_device"], t["bytes_per_device"],
            t["wire_bytes_per_device"]) == (1e12, 3.35e9, 5e9)
    t = analysis.roofline_terms({"flops": 1e16}, {}, 1)
    assert t["compute_s"] == t["compute_hlo_s"] == 1e16 / PEAK_FLOPS_BF16
    assert t["bottleneck"] == "compute"
    t = analysis.roofline_terms({"flops": 1.0, "bytes accessed": 1e12},
                                {"total": 0.0}, 1)
    assert t["bottleneck"] == "memory"


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def _cfg(kind):
    _, axis, _, _ = MESHES[kind]
    return dataclasses.replace(reduced(get_config("llama3_2_1b")),
                               fed_axis=axis)


def _fed(kind):
    _, _, agg, attack = MESHES[kind]
    return ft.FedConfig(aggregator=agg, attack=attack, kappa=2, n_byz=1,
                        telemetry=kind == "four")


def _held(*trees) -> int:
    """The bytes this rank holds of the trees' leaves (each placed
    leaf's block)."""
    return sum(placed.local(x).nbytes for tree in trees
               for _, x in tree_paths(tree))


def _rank_cases(kind, mesh):
    """The serving programs and two federated steps on this rank: bytes
    held and returned, and each program's collectives."""
    cfg, fed = _cfg(kind), _fed(kind)
    from repro_torch.distributed.serving import make_serve_fns
    from repro_torch.models.model import init_params
    gen = torch.Generator().manual_seed(0)
    fns = make_serve_fns(cfg, mesh, B, S)
    params = tsh.place_tree(init_params(cfg, 0, device="cpu"),
                            fns.shardings["params"], mesh)
    places = tsh.placements(fns.batch_spec, mesh)
    toks = placed.place(torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=gen, dtype=torch.int32),
                        mesh, places)
    tok = placed.place(torch.randint(0, cfg.vocab_size, (B, 1),
                                     generator=gen, dtype=torch.int32),
                       mesh, places)
    out = {"coord": tuple(mesh.get_coordinate())}
    res = out["prefill"] = {"args": _held(params, toks)}
    with CollectiveWatch(res):
        logits, cache = fns.prefill(params, toks)
    res["outs"] = _held(logits, cache)
    res = out["decode"] = {"args": _held(params, tok, cache),
                           "alias": _held(cache["blocks"],
                                          cache["slot_pos"])}
    with CollectiveWatch(res):
        logits, cache = fns.decode(params, tok, cache)
    res["outs"] = _held(logits, cache)

    K = tsh.n_agents(cfg, mesh)
    steps = {c: ft.make_fed_step(cfg, fed, mesh, large=c,
                                 per_agent_batch=TRAIN.global_batch // K,
                                 seq_len=S) for c in (True, False)}
    _, _, batch_shape, (_, batch_sh, _) = steps[True]
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                              generator=gen, dtype=torch.int32)
             for k, v in batch_shape.items()}
    batch = ft.place_batch(batch, cfg, mesh)
    state = ft.place_fed_state(ft.init_fed_state(cfg, fed, K, 0,
                                                 device="cpu"), mesh, cfg)
    mask = torch.arange(K) < 1
    for coin in (True, False):
        res = out["train", coin] = {"args": _held(state, batch, mask)}
        with CollectiveWatch(res):
            state, _ = steps[coin][0](state, batch, mask)
    return out


def _rank_main(rank, world, port, kind, inp, dst):
    """One spawned rank: join the gloo group, build the kind's mesh, run
    its cases, write the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        torch.save(_rank_cases(kind, make_debug_mesh(
            *MESHES[kind][0], device_type="cpu")), dst)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The ranks of both meshes, started when the module starts (they run
    beside its other tests) and stopped when it ends."""
    meshes = Meshes("test_torch_dryrun",
                    {k: math.prod(v[0]) for k, v in MESHES.items()},
                    {k: None for k in MESHES},
                    str(tmp_path_factory.mktemp("dryrun")))
    try:
        yield meshes
    finally:
        meshes.stop()


@pytest.fixture(scope="module")
def ranks(_started):
    return _started.results()


def _programs(kind):
    """The dry run's programs of the ranks' cases on the abstract mesh."""
    cfg, fed = _cfg(kind), _fed(kind)
    mesh = tsh.AbstractMesh(MESHES[kind][0], ("data", "model"))
    out = {"prefill": dryrun.serve_program(cfg, "prefill", B, S, mesh,
                                           torch.float32),
           "decode": dryrun.serve_program(cfg, "decode", B, S, mesh,
                                          torch.float32),
           "train": dryrun.train_program(cfg, TRAIN, mesh, fed,
                                         torch.float32)}
    return mesh, out


@pytest.mark.parametrize("kind", list(MESHES))
def test_memory_matches_what_ranks_hold(ranks, kind):
    """``argument_bytes`` (and for serving ``output_bytes``, and a
    decode's ``alias_bytes``) equal the bytes each rank holds."""
    mesh, progs = _programs(kind)
    for res in ranks[kind]:
        for name in ("prefill", "decode"):
            mem = dryrun.memory(progs[name], mesh)
            assert res[name]["args"] == mem["argument_bytes"], name
            assert res[name]["outs"] == mem["output_bytes"], name
        assert res["decode"]["alias"] == dryrun.memory(
            progs["decode"], mesh)["alias_bytes"]
        train = dryrun.memory(progs["train"], mesh)
        assert res["train", True]["args"] == train["argument_bytes"]
        assert res["train", False]["args"] == train["argument_bytes"]


@pytest.mark.parametrize("kind", list(MESHES))
def test_route_wire_bytes_match_the_route(ranks, kind):
    """Every collective of a prefill, a decode and both coins' steps, in
    order, is the one reckoned for the rank's coordinate, its bytes and
    group size; no DTensor operator is dispatched."""
    mesh, progs = _programs(kind)
    fed = _fed(kind)
    tr = progs["train"]
    state_shape, batch = tr.args[0], tr.args[1]
    state_sh, batch_sh = tr.arg_specs[0], tr.arg_specs[1]
    for res in ranks[kind]:
        want = {"prefill": progs["prefill"].gathers,
                "decode": progs["decode"].gathers}
        for coin in (True, False):
            want["train", coin] = analysis.fed_step_gathers(
                fed, mesh, state_shape, state_sh, batch, batch_sh,
                large=coin, coord=res["coord"], cfg=_cfg(kind))
        assert progs["train"].gathers == analysis.fed_step_gathers(
            fed, mesh, state_shape, state_sh, batch, batch_sh, large=True,
            cfg=_cfg(kind))
        for key, gathers in want.items():
            got = res[key]
            assert got["dtensor_ops"] == [], key
            assert [tuple(g) for g in got["gathers"]] == gathers, \
                (key, res["coord"])
            wire = analysis.route_wire_bytes(gathers)
            assert wire["counts"]["all-gather"] == \
                got["comm"].get("c10d.allgather_", 0), key
            assert wire["total"] == sum(b * (g - 1) / g
                                        for b, g in got["gathers"])
        if kind == "four":
            # split leaves: coin 0 runs the prev pass on the blocks too
            assert want["train", False] != want["train", True]
