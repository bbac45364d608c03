"""SweepRunner: windowed, resumable, multi-process grid runner, the port
of the JAX package's ``repro/sweep/runner.py``.

Where :class:`repro_torch.Experiment` runs a scenario grid as one
one-shot ``run_grid`` call, the sweep service drives the *same* grid as a
long-running job built from the algorithms' windows:

* T is cut into W windows (:func:`repro_torch.core.engine.window_slices`)
  and each group advances one window at a time through the algorithm's
  ``window``, whose explicit carry and generator make the chain
  bit-identical to the one-shot run;
* after every window the rows' carries with their generator states, the
  history chunk, and the group's progress record land in the sweep
  directory (atomic writes, progress committed last), so a preempted
  sweep resumes from its manifest: completed groups are reloaded without
  drawing or launching anything, partial ones restart mid-T from their
  carries and generator states;
* with several processes (a gloo process group from
  :func:`repro_torch.distributed.init_distributed`) a group's rows are
  split over the processes in ``mode="span"``, or whole groups are
  assigned to processes by greedy longest-processing-time in
  ``mode="shard"`` and merged through the shared sweep directory;
* partial summaries stream through ``repro_torch.obs`` sinks as windows
  and groups finish (``sweep.window`` / ``sweep.partial`` records); each
  window's commit is a ``sweep.commit`` host span.

A group is one scenario's seed batch: the reference groups scenarios by
their lane-static signature because a group is what it compiles and
``vmap``s, and the port batches nothing. So every group has one lane, its
rows are the seeds (no pad rows), the groups follow the grid's scenario
order, and a window runs each row's window in turn. A row's random
stream is its ``torch.Generator``'s state, not a key: the carry archive
holds each row's state, and a seed's numbers differ between device types,
so the manifest records the device type and a resume on another raises
:class:`SweepMismatch` naming ``meta.device``.

CLI: ``python -m repro_torch.launch.sweep`` (``--windows``, ``--resume
DIR``, ``--processes``, ``--device``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.checkpoint import restore, save
from repro_torch.core import engine
from repro_torch.core.registry import Spec, resolve
from repro_torch.core.tree import tree_map
from repro_torch.distributed.sharding import (host_assignment,
                                              process_count, process_index,
                                              row_block)
from repro_torch.rl.envs import make_env
from repro_torch.sweep import manifest as mf

SweepMismatch = mf.SweepMismatch


class SweepError(RuntimeError):
    """Unrecoverable sweep-service condition (bad mode, merge timeout,
    non-persistable configuration)."""


def _jsonable(v):
    if isinstance(v, Spec):
        return v.canonical()
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    raise SweepError(
        f"cannot persist {v!r} in a sweep manifest; use spec strings "
        f"and plain scalars for axes/base fields of a resumable sweep")


def _from_json(v):
    """Undo the JSON round-trip of :func:`_jsonable`: sequences come back
    as lists but configs need the hashable tuple form (hidden=(8,))."""
    if isinstance(v, list):
        return tuple(_from_json(x) for x in v)
    return v


def _generator(state: torch.Tensor, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    # a copy that owns its storage: a row view of the stacked states
    # crashes the CPU generator's set_state
    gen.set_state(state.clone())
    return gen


class SweepRunner:
    """Drive an Experiment-shaped grid as a windowed, resumable job.

    Constructor arguments mirror :class:`repro_torch.Experiment`
    (``algo``, ``env``, ``T``, ``seeds``, ``axes``, ``override``,
    ``device``, plus base config fields), with the service knobs on top:

    ``windows``
        number of window chunks T is split into (1 = one window of T).
    ``out_dir``
        sweep directory for the manifest + per-group checkpoints; None
        runs fully in memory (not resumable).
    ``mode``
        ``"auto"`` (``"span"`` when several processes are present,
        ``"local"`` otherwise), ``"span"`` (each group's rows split over
        the processes, gathered after every window; rank 0 writes),
        ``"shard"`` (whole groups per process, greedy LPT-balanced,
        merged through ``out_dir``), or ``"local"``.
    ``device``
        where the runs go; None means CUDA (:func:`resolve_device`).

    ``run(max_windows=N)`` executes at most N windows and returns None
    if the sweep is unfinished (the crash-simulation hook); a later
    ``run()``, or ``SweepRunner.resume(out_dir)`` in a fresh process,
    picks up from the manifest. The completed sweep returns an
    :class:`repro_torch.ExperimentResult` bit-identical to the one-shot
    ``run_grid`` over the same grid on the same device.
    """

    def __init__(self, algo="decbyzpg", env="cartpole", T: int = 50,
                 seeds=(0, 1, 2), axes: Optional[Mapping] = None,
                 override: Optional[Callable] = None, windows: int = 1,
                 out_dir: Optional[str] = None, mode: str = "auto",
                 poll_s: float = 0.2, timeout_s: float = 600.0,
                 device=None, **base):
        if mode not in ("auto", "local", "span", "shard"):
            raise SweepError(f"unknown sweep mode {mode!r}")
        self.algo = Spec.of(algo)
        self.env_spec = env
        self.T = int(T)
        self.seeds = tuple(range(seeds)) if isinstance(seeds, int) \
            else tuple(seeds)
        self.axes = {k: engine._as_axis(tuple(v) if isinstance(v, list)
                                        else v)
                     for k, v in dict(axes or {}).items()}
        self.override = override
        self.windows = int(windows)
        self.out_dir = out_dir
        self.mode = mode
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.device = resolve_device(device)
        self.base = base

    @classmethod
    def resume(cls, out_dir: str, override: Optional[Callable] = None,
               mode: str = "auto", device=None, **kw) -> "SweepRunner":
        """Reconstruct a runner from ``out_dir``'s manifest, on ``device``
        (default CUDA, whatever the manifest recorded: a resume on another
        device type raises :class:`SweepMismatch` when it runs). A sweep
        recorded with an ``override`` hook cannot round-trip the hook
        itself: pass the same function again or this raises."""
        doc = mf.read_json(os.path.join(out_dir, mf.MANIFEST))
        m = doc["meta"]
        if m.get("override") and override is None:
            raise SweepError(
                f"sweep was recorded with override hook "
                f"{m['override']!r}; pass override= to resume()")
        base = {k: _from_json(v) for k, v in m["base"].items()}
        return cls(algo=m["algo"], env=m["env"], T=m["T"],
                   seeds=tuple(m["seeds"]),
                   axes={k: tuple(_from_json(x) for x in v)
                         for k, v in m["axes"]},
                   override=override, windows=m["windows"],
                   out_dir=out_dir, mode=mode, device=device,
                   **{**base, **kw})

    # -- sweep description ---------------------------------------------------

    def _meta(self) -> dict:
        env = self.env_spec
        return {"algo": self.algo.canonical(),
                "env": (Spec.of(env).canonical()
                        if isinstance(env, (str, Spec)) else env.name),
                "T": self.T, "seeds": list(self.seeds),
                "windows": self.windows,
                # list of [name, values] pairs, NOT a mapping: axis order
                # defines the scenario-key tuples and must survive the
                # sort_keys JSON round-trip
                "axes": [[k, [_jsonable(v) for v in vals]]
                         for k, vals in self.axes.items()],
                "base": {k: _jsonable(v) for k, v in self.base.items()},
                "override": (getattr(self.override, "__qualname__",
                                     repr(self.override))
                             if self.override is not None else None),
                # a seed's generator gives other numbers on another
                # device type, so a resume must stay on this one
                "device": self.device.type}

    # -- execution -----------------------------------------------------------

    def run(self, max_windows: Optional[int] = None) \
            -> Optional[engine.ExperimentResult]:
        """Advance the sweep; returns the completed
        :class:`repro_torch.ExperimentResult`, or None when
        ``max_windows`` ran out first (progress is committed: call again
        to continue)."""
        env = make_env(self.env_spec)
        grid = engine.ScenarioGrid(seeds=self.seeds, axes=self.axes)
        _, scenarios = engine.grid_scenarios(
            grid, algo=self.algo, override=self.override,
            base=dict(self.base))
        slices = engine.window_slices(self.T, self.windows)
        n_proc, pid = process_count(), process_index()
        mode = self.mode
        if mode == "auto":
            mode = "span" if n_proc > 1 else "local"
        if mode == "shard" and n_proc > 1 and self.out_dir is None:
            raise SweepError(
                "mode='shard' needs a shared out_dir to merge groups")
        return self._run(env, scenarios, slices, mode, n_proc, pid,
                         max_windows)

    def _run(self, env, scenarios, slices, mode, n_proc, pid, max_windows):
        a = resolve("algo", self.algo)
        S = len(self.seeds)
        entries = [{"gid": gi,
                    "signature": repr(dataclasses.replace(cfg, seed=0)),
                    "lanes": 1, "rows": S, "n_pad": S,
                    "scenarios": [
                        engine.ExperimentResult.scenario_name(scn)]}
                   for gi, (scn, cfg) in enumerate(scenarios)]
        persist = self.out_dir is not None
        # manifest writer: rank 0 creates it, everyone validates theirs
        # against it (a mismatched resume dir fails before any compute)
        if persist:
            wanted = mf.build_manifest(self._meta(), slices, entries)
            doc = mf.load_or_init(self.out_dir, wanted, write=(pid == 0))
            deadline = time.time() + self.timeout_s
            while doc is None:      # non-zero ranks wait for the writer
                if time.time() > deadline:
                    raise SweepError("timed out waiting for manifest")
                time.sleep(self.poll_s)
                doc = mf.load_or_init(self.out_dir, wanted,
                                      write=(pid == 0))
        owners = host_assignment(
            [e["rows"] * self.T for e in entries], n_proc) \
            if mode == "shard" else None
        span = mode == "span" and n_proc > 1
        budget = [max_windows] if max_windows is not None else None
        results: dict = {}
        pending = []
        for gi, (scn, cfg) in enumerate(scenarios):
            if owners is not None and owners[gi] != pid:
                pending.append((gi, scn, cfg))
                continue
            writer = persist and (pid == 0 if mode == "span" else True)
            gp = mf.GroupPaths(self.out_dir, gi) if persist else None
            hist = self._run_group(env, a, cfg, gi, gp, slices, budget,
                                   writer, span, n_proc, pid)
            if hist is None:        # max_windows exhausted mid-sweep
                return None
            self._summarize_group(hist, scn, cfg, results, gi,
                                  len(scenarios))
        # shard mode: groups owned by other processes arrive through the
        # shared sweep dir once their state says every window committed
        deadline = time.time() + self.timeout_s
        for gi, scn, cfg in pending:
            gp = mf.GroupPaths(self.out_dir, gi)
            while mf.windows_done(gp) < len(slices):
                if time.time() > deadline:
                    raise SweepError(
                        f"timed out waiting for group {gi} (owner "
                        f"process {owners[gi]}) to finish")
                time.sleep(self.poll_s)
            hist = self._load_group(env, cfg, gp, len(slices))
            self._summarize_group(hist, scn, cfg, results, gi,
                                  len(scenarios))
        ordered = {scn: results[scn] for scn, _ in scenarios}
        result = engine.ExperimentResult(self._meta(), self.axes, ordered)
        if persist and pid == 0:
            result.to_json(os.path.join(self.out_dir, mf.SUMMARY))
        return result

    def _run_group(self, env, a, cfg, gi, gp, slices, budget, writer, span,
                   n_proc, pid):
        W = len(slices)
        wdone = mf.windows_done(gp) if gp is not None else 0
        if span:
            # rank 0's reading decides, so every rank takes the same path
            box = [wdone]
            dist.broadcast_object_list(box, src=0)
            wdone = box[0]
        if wdone >= W:
            # fully committed: reload artifacts, no draw, no launch
            return self._load_group(env, cfg, gp, W)
        dev = self.device
        mine = row_block(len(self.seeds), n_proc, pid) if span \
            else range(len(self.seeds))
        if wdone == 0:
            gens = [engine.seed_generator(self.seeds[r], dev) for r in mine]
            carries = [a.init(env, cfg, g, device=dev) for g in gens]
        else:
            stacked, states = self._load_carry(env, cfg, gp)
            carries = [tree_map(lambda x: x[r].to(dev, copy=True), stacked)
                       for r in mine]
            gens = [_generator(states[r], dev) for r in mine]
        chunks = [self._load_chunk(gp.window(w)) for w in range(wdone)]
        for w in range(wdone, W):
            if budget is not None and budget[0] <= 0:
                return None
            start, stop = slices[w]
            outs = [a.window(env, cfg, c, g, start, stop)
                    for c, g in zip(carries, gens)]
            carries = [c for c, _ in outs]
            rows = (carries, [g.get_state() for g in gens],
                    [ch for _, ch in outs])
            if span:
                rows = self._gather_rows(mine, *rows, n_proc)
            all_carries, states, row_chunks = rows
            chunk = engine.stack_rows(row_chunks)
            chunks.append(chunk)
            if budget is not None:
                budget[0] -= 1
            if writer and gp is not None:
                # carry + chunk first, progress record last: a crash
                # between the writes re-runs window w, never skips it
                with obs.host_span("sweep.commit", group=gi, window=w):
                    save({"carry": engine.stack_rows(all_carries),
                          "generator": torch.stack(states)}, gp.carry)
                    save(chunk, gp.window(w))
                    mf.commit_window(gp, w + 1, stop)
            if obs.enabled():
                obs.record("sweep.window", group=gi, window=w,
                           t_done=stop, T=self.T)
                obs.progress(f"sweep group {gi}: window {w + 1}/{W} "
                             f"(t={stop}/{self.T})", group=gi, window=w)
        return engine.assemble_hist(engine.stack_rows(all_carries), chunks,
                                    self.algo)

    @staticmethod
    def _gather_rows(mine, carries, states, chunks, n_proc):
        """Every process's rows (carries on the host, generator states,
        chunks), gathered to every process in row order."""
        part = {"rows": list(mine),
                "carries": [tree_map(lambda x: x.cpu(), c) for c in carries],
                "states": states, "chunks": chunks}
        parts = [None] * n_proc
        dist.all_gather_object(parts, part)
        by_row = {r: (p["carries"][i], p["states"][i], p["chunks"][i])
                  for p in parts for i, r in enumerate(p["rows"])}
        return tuple(list(col) for col in zip(*(by_row[r]
                                                for r in sorted(by_row))))

    def _load_carry(self, env, cfg, gp):
        """The group's stacked carries and generator states, on the host,
        validated against the carries' shapes and dtypes."""
        S = len(self.seeds)
        n_state = torch.Generator(device=self.device).get_state().numel()
        template = {"carry": engine.carry_struct(env, cfg, S, self.algo),
                    "generator": torch.empty((S, n_state),
                                             dtype=torch.uint8,
                                             device="meta")}
        tree = restore(template, gp.carry, device="cpu")
        return tree["carry"], tree["generator"]

    def _load_group(self, env, cfg, gp, W):
        carry, _ = self._load_carry(env, cfg, gp)
        chunks = [self._load_chunk(gp.window(w)) for w in range(W)]
        return engine.assemble_hist(carry, chunks, self.algo)

    @staticmethod
    def _load_chunk(path: str) -> dict:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

    def _summarize_group(self, hist, scn, cfg, results, gi, n_groups):
        results[scn] = r = engine.summarize(hist, cfg)
        if obs.enabled():
            obs.record(
                "sweep.partial",
                scenario=engine.ExperimentResult.scenario_name(scn),
                final_return_mean=r["final_return_mean"],
                final_return_ci95=r["final_return_ci95"])
            obs.progress(f"sweep group {gi + 1}/{n_groups} complete",
                         group=gi, scenarios=1)
