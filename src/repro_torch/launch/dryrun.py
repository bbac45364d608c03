"""Multi-pod dry run: every (architecture × input shape) program of the
port built on the reference's production meshes, with the roofline
inputs reckoned from shapes and specs: the port of the JAX package's
``launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The mesh is an :class:`~repro_torch.distributed.sharding.AbstractMesh` of
the reference's production shapes, (16, 16) over ("data", "model") or
(2, 16, 16) over ("pod", "data", "model") with ``--multi-pod``: the
shapes its per-device numbers are for. Everything stays on the ``meta``
device; no rank, process group or allocation is needed. Train shapes go
through ``make_fed_step`` (K = ``n_agents``), prefill and decode through
``make_serve_fns``.

Where the reference lowers and compiles each program on 256 or 512 fake
XLA devices and reads the compiled module, no torch program can be
lowered that way, so each record departs from the reference's:

* ``memory``: ``argument_bytes`` and ``output_bytes`` are the bytes of
  each argument (output) leaf's block under its spec on one device;
  ``alias_bytes`` the decode cache's ring, states and ``slot_pos``,
  written in place (0 for the train step, which writes no input);
  ``gathered_bytes`` stands in for the compiler's ``temp_bytes``: the
  largest set of tensors the route holds whole on one rank at once. For
  serving that is one layer's: the leaves it gathers for the layer (a
  layer split over "data" copied from its rank, a leaf used whole
  gathered over "model") and, for a decode, the layer's ring rows
  gathered whole over W, plus the largest ``all_gather`` output of the
  call (a rank-order sum's parts, or a layer gather's). For training
  (each agent's loss and gradient on the rank's rows and blocks):
  the agent's gradient blocks, one layer's gathered leaves and their
  whole gradients, and the call's largest ``all_gather`` output
  (:func:`train_gathered_bytes`). ``peak_per_device_gb`` = (argument
  + output − alias + gathered) / 2³⁰. Activations and workspaces are
  not counted.
* ``roofline``: ``flops_per_device`` is ``model_flops_global / n_chips``
  (no HLO FLOPs; ``compute_hlo_s`` is then the same term), the bytes
  accessed are the device's argument and output bytes (each read or
  written once), and the collective term divides the route's wire bytes
  (:func:`repro_torch.launch.analysis.route_wire_bytes`) by one NVLink
  link's rate (the H100 data sheet's, :mod:`repro_torch.launch.mesh`).
  The reference's ``useful_ratio`` (MODEL_FLOPS over HLO FLOPs) has no
  counterpart.
* ``collectives``: the reference's types, every one of the port's an
  ``all_gather``.
* ``compile_s``, ``lower_s`` and ``temp_bytes`` are absent: there is no
  compiler.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any

import torch

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.tree import tree_paths
from repro_torch.distributed.fed_trainer import FedConfig, make_fed_step
from repro_torch.distributed.serving import make_serve_fns
from repro_torch.distributed.sharding import AbstractMesh, n_agents
from repro_torch.launch.analysis import (Leaf, estimate_plan,
                                         fed_step_gathers, model_flops,
                                         roofline_terms, route_wire_bytes,
                                         serve_gathers)


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh shape: (16, 16) ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@dataclasses.dataclass
class Program:
    """One built program: its arguments and outputs as ``meta`` tensors
    with their spec trees, the bytes it writes in place, the bytes it
    holds whole on a rank and its collectives
    (:mod:`repro_torch.launch.analysis`)."""
    args: tuple
    arg_specs: tuple
    outs: tuple
    out_specs: tuple
    alias_bytes: int
    gathered_bytes: int
    gathers: list


def _bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree`` laid out by ``specs``."""
    return sum(Leaf.of(t, s, mesh).block_bytes for (_, t), (_, s)
               in zip(tree_paths(tree), tree_paths(specs)))


def gathered_bytes(plan) -> int:
    """The most a serving call (its :func:`~repro_torch.launch.analysis.
    serve_gathers`) holds whole at once: one layer's slices copied from the
    "data" rank that holds them, its leaves gathered whole (each one's
    last gather) and a decode's cache rows gathered whole, plus the
    call's largest ``all_gather`` output."""
    held = {}
    for (kind, path), b, g in plan:
        if kind == "layer":
            held.setdefault(path, b // g)
        elif kind in ("whole", "cache"):
            held[path] = b
    return sum(held.values()) + max((b for _, b, _ in plan), default=0)


def serve_program(cfg, mode: str, batch: int, seq_len: int, mesh,
                  dtype=torch.bfloat16) -> Program:
    """The prefill (``mode="prefill"``: B × (seq_len − n_prefix_embeds)
    int32 tokens, plus the prefix embeddings with a frontend) or decode
    (one token against a cache of ``serve_cache_len``) of
    ``make_serve_fns(cfg, mesh, batch, seq_len, dtype)``."""
    fns = make_serve_fns(cfg, mesh, batch, seq_len, dtype=dtype)
    psh, c_sh, b_spec = (fns.shardings["params"], fns.shardings["cache"],
                         fns.batch_spec)
    logits = torch.empty((batch, 1, cfg.vocab_size), dtype=dtype,
                         device="meta")
    decode = mode != "prefill"
    P = cfg.n_prefix_embeds if cfg.frontend != "none" else 0
    plan = serve_gathers(
        cfg, fns.params_shape, psh, mesh, Leaf.of(logits, b_spec,
                                                  mesh).block[0],
        1 if decode else seq_len - cfg.n_prefix_embeds, 0 if decode else P,
        fns.cache_shape if decode else None, c_sh)
    gathers = [(b, g) for _, b, g in plan]
    gathered = gathered_bytes(plan)
    outs, out_specs = (logits, fns.cache_shape), (b_spec, c_sh)
    if mode == "prefill":
        S_text = seq_len - cfg.n_prefix_embeds
        toks = torch.empty((batch, S_text), dtype=torch.int32,
                           device="meta")
        args, specs = (fns.params_shape, toks), (psh, b_spec)
        if cfg.frontend != "none":
            pe = torch.empty((batch, cfg.n_prefix_embeds, cfg.d_model),
                             dtype=dtype, device="meta")
            args, specs = args + (pe,), specs + (b_spec,)
        return Program(args, specs, outs, out_specs, 0, gathered, gathers)
    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    in_place = ("blocks", "slot_pos")       # the new pos is a new tensor
    return Program(
        (fns.params_shape, tok, fns.cache_shape),
        (psh, b_spec, c_sh), outs, out_specs,
        _bytes([fns.cache_shape[k] for k in in_place],
               [c_sh[k] for k in in_place], mesh), gathered, gathers)


def train_gathered_bytes(plan, grad_bytes: int) -> int:
    """The most a training step's estimate (its one pass's
    :func:`~repro_torch.launch.analysis.train_gathers` ``plan``) holds
    whole at once beside its blocks: one layer's gathered leaves (its
    slices copied from the "data" rank that holds them and its leaves
    gathered whole) and their whole gradients, the call's largest
    ``all_gather`` output, and ``grad_bytes``, the agent's gradient
    blocks. A step that runs the plain loss (an empty plan, no leaf or
    row split) holds the agent's whole gradients, ``grad_bytes``."""
    held = {}
    for (kind, path), b, g in plan:
        if kind == "layer":
            held.setdefault(path, b // g)
        elif kind == "whole":
            held[path] = b
    return grad_bytes + 2 * sum(held.values()) + max(
        (b for _, b, _ in plan), default=0)


def train_program(cfg, shape, mesh, fed: FedConfig,
                  dtype=torch.bfloat16) -> Program:
    """The tree trainer's step of ``make_fed_step`` (coin 1) with K =
    ``n_agents(cfg, mesh)`` and ``max(global_batch // K, 1)`` sequences
    an agent."""
    K = n_agents(cfg, mesh)
    per_agent = max(shape.global_batch // K, 1)
    _, state_shape, batch, (state_sh, batch_sh, rep) = make_fed_step(
        cfg, fed, mesh, large=True, dtype=dtype,
        per_agent_batch=per_agent, seq_len=shape.seq_len)
    mask = torch.empty((K,), dtype=torch.bool, device="meta")
    scalar = torch.empty((), dtype=torch.float32, device="meta")
    metrics = {"loss": scalar, "diameter": scalar}
    if fed.telemetry:
        metrics["grad_norm"] = scalar
    leaves = [Leaf.of(t, s, mesh) for (_, t), (_, s) in
              zip(tree_paths(state_shape.params),
                  tree_paths(state_sh.params))]
    grads = sum(math.prod(leaf.block[1:]) * leaf.itemsize
                for leaf in leaves)
    gathered = train_gathered_bytes(
        estimate_plan(cfg, mesh, state_shape, state_sh, batch, batch_sh),
        grads)
    return Program(
        (state_shape, batch, mask), (state_sh, batch_sh, rep),
        (state_shape, metrics), (state_sh, {k: rep for k in metrics}), 0,
        gathered, fed_step_gathers(fed, mesh, state_shape, state_sh, batch,
                                   batch_sh, large=True, cfg=cfg))


def build_program(arch: str, shape_name: str, mesh, fed: FedConfig,
                  dtype=torch.bfloat16, overrides=None):
    """Build the program for one (arch, shape) on ``mesh``. overrides: a
    dict of ModelConfig field replacements (perf A/B toggles). Returns
    ``(program, cfg, shape)``."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        return train_program(cfg, shape, mesh, fed, dtype), cfg, shape
    return serve_program(cfg, shape.mode, shape.global_batch, shape.seq_len,
                         mesh, dtype), cfg, shape


def memory(program: Program, mesh) -> dict:
    """One device's bytes of a program (the module docstring's
    ``memory`` record)."""
    arg = _bytes(program.args, program.arg_specs, mesh)
    out = _bytes(program.outs, program.out_specs, mesh)
    return {"argument_bytes": arg, "output_bytes": out,
            "alias_bytes": program.alias_bytes,
            "gathered_bytes": program.gathered_bytes,
            "peak_per_device_gb": round(
                (arg + out - program.alias_bytes + program.gathered_bytes)
                / 2**30, 3)}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            fed: FedConfig, overrides=None) -> dict:
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "overrides": overrides or {},
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "ok": False}
    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        n_chips = math.prod(mesh.shape)
        program, cfg, shape = build_program(arch, shape_name, mesh, fed,
                                            overrides=overrides)
        rec["memory"] = memory(program, mesh)
        wire = route_wire_bytes(program.gathers)
        mf = model_flops(cfg, shape)
        cost = {"flops": mf / n_chips,
                "bytes accessed": rec["memory"]["argument_bytes"]
                + rec["memory"]["output_bytes"]}
        terms = roofline_terms(cost, wire, n_chips, model_flops_global=mf)
        terms["model_flops_global"] = mf
        rec["roofline"] = {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in terms.items()}
        rec["collectives"] = {k: (int(v) if not isinstance(v, dict) else v)
                              for k, v in wire.items() if k != "gathers"}
        rec["n_agents"] = n_agents(get_config(arch), mesh)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--aggregator", default="rfa")
    ap.add_argument("--kappa", type=int, default=4)
    ap.add_argument("--mix-dtype", default=None)
    ap.add_argument("--mix-block", type=int, default=0)
    ap.add_argument("--override", default=None,
                    help="cfg overrides, e.g. fused_rmsnorm=1,mla_absorb=1,"
                         "recurrent_chunk=128")
    args = ap.parse_args(argv)
    overrides = {}
    if args.override:
        for kv in args.override.split(","):
            k, v = kv.split("=")
            overrides[k] = int(v) if v.lstrip("-").isdigit() else v
        overrides = {k: (bool(v) if k in ("fused_rmsnorm", "mla_absorb",
                                          "fsdp_layers") else v)
                     for k, v in overrides.items()}

    fed = FedConfig(aggregator=args.aggregator, kappa=args.kappa,
                    mix_dtype=args.mix_dtype, mix_block=args.mix_block)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]

    results = []
    for a in archs:
        for s in shapes:
            rec = run_one(a, s, args.multi_pod, fed, overrides=overrides)
            status = "OK " if rec["ok"] else "FAIL"
            if rec["ok"]:
                r = rec["roofline"]
                extra = (f"bottleneck={r['bottleneck']} "
                         f"mem/dev={rec['memory']['peak_per_device_gb']}GB "
                         f"wire/dev={rec['collectives']['total']}B")
            else:
                extra = rec["error"][:160]
            print(f"[{status}] {a:22s} {s:12s} {rec['mesh']:8s} {extra}",
                  flush=True)
            results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(r["ok"] for r in results)
    print(f"{n_ok}/{len(results)} built")


if __name__ == "__main__":
    main()
