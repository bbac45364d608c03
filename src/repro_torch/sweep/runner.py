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
* with several processes (a process group from
  :func:`repro_torch.distributed.init_distributed`, its host objects
  over gloo) a group's rows are
  split over the processes' lane mesh in ``mode="span"``, or whole groups are
  assigned to processes by greedy longest-processing-time in
  ``mode="shard"`` and merged through the shared sweep directory;
* partial summaries stream through ``repro_torch.obs`` sinks as windows
  and groups finish (``sweep.window`` / ``sweep.partial`` records); each
  window's commit is a ``sweep.commit`` host span.

A group is a lane group (:func:`repro_torch.core.engine.lane_groups`):
the scenarios that differ only in traced scalars, whose lanes × seeds
rows a window advances as one batched step per iteration
(:func:`~repro_torch.core.engine.lane_window_loop`), and whose manifest
entry carries ``lanes``, ``rows``, ``n_pad`` and the signature
``f"{static_cfg!r}|{names!r}"``, as the reference writes them. A
manifest written with other groups (one group per scenario, say) is
refused with :class:`SweepMismatch`. In ``span``
mode the rows are padded to a multiple of the process count and each
process advances its block, gathered after every window. A row's random
stream is its ``torch.Generator``'s state, not a key: the carry archive
holds each row's state, and a seed's numbers differ between device types,
so the manifest records the device type and a resume on another raises
:class:`SweepMismatch` naming ``meta.device``.

CLI: ``python -m repro_torch.launch.sweep`` (``--windows``, ``--resume
DIR``, ``--processes``, ``--device``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint import restore, save
from repro_torch.core import engine
from repro_torch.core.registry import Spec, resolve
from repro_torch.core.tree import tree_map
from repro_torch.distributed.sharding import (broadcast_object, gather_rows,
                                              host_assignment, lane_mesh,
                                              lane_sharding,
                                              padded_rows, process_count,
                                              process_index, spans_processes,
                                              use_lane_mesh)
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
        ctx = use_lane_mesh(lane_mesh(spanning=True)) \
            if mode == "span" and n_proc > 1 else contextlib.nullcontext()
        with ctx:
            return self._run(env, scenarios, slices, mode, n_proc, pid,
                             max_windows)

    def _run(self, env, scenarios, slices, mode, n_proc, pid, max_windows):
        groups = list(engine.lane_groups(scenarios, algo=self.algo).items())
        mesh = lane_mesh()
        S = len(self.seeds)
        entries = []
        for gi, ((static_cfg, names), members) in enumerate(groups):
            rows = len(members) * S
            entries.append({
                "gid": gi, "signature": f"{static_cfg!r}|{names!r}",
                "lanes": len(members), "rows": rows,
                "n_pad": padded_rows(mesh, rows),
                "scenarios": [engine.ExperimentResult.scenario_name(scn)
                              for scn, _, _ in members]})
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
        budget = [max_windows] if max_windows is not None else None
        results: dict = {}
        pending = []
        for gi, ((static_cfg, names), members) in enumerate(groups):
            if owners is not None and owners[gi] != pid:
                pending.append((gi, static_cfg, members))
                continue
            writer = persist and (pid == 0 if mode == "span" else True)
            gp = mf.GroupPaths(self.out_dir, gi) if persist else None
            hist = self._run_group(env, static_cfg, names, members, gi, gp,
                                   slices, entries[gi]["n_pad"], budget,
                                   writer, mesh)
            if hist is None:        # max_windows exhausted mid-sweep
                return None
            self._summarize_group(hist, members, results, gi, len(groups))
        # shard mode: groups owned by other processes arrive through the
        # shared sweep dir once their state says every window committed
        deadline = time.time() + self.timeout_s
        for gi, static_cfg, members in pending:
            gp = mf.GroupPaths(self.out_dir, gi)
            while mf.windows_done(gp) < len(slices):
                if time.time() > deadline:
                    raise SweepError(
                        f"timed out waiting for group {gi} (owner "
                        f"process {owners[gi]}) to finish")
                time.sleep(self.poll_s)
            hist = self._load_group(env, static_cfg, gp, len(slices),
                                    entries[gi]["n_pad"])
            self._summarize_group(hist, members, results, gi, len(groups))
        ordered = {scn: results[scn] for scn, _ in scenarios}
        result = engine.ExperimentResult(self._meta(), self.axes, ordered)
        if persist and pid == 0:
            result.to_json(os.path.join(self.out_dir, mf.SUMMARY))
        return result

    def _run_group(self, env, static_cfg, names, members, gi, gp, slices,
                   n_pad, budget, writer, mesh):
        W = len(slices)
        wdone = mf.windows_done(gp) if gp is not None else 0
        span = spans_processes(mesh)
        if span:
            # rank 0's reading decides, so every rank takes the same path
            wdone = broadcast_object(wdone)
        if wdone >= W:
            # fully committed: reload artifacts, no draw, no launch
            return self._load_group(env, static_cfg, gp, W, n_pad)
        dev = self.device
        vals, seeds = engine.lane_operands(members, self.seeds, n_pad)
        block = lane_sharding(mesh, n_pad)
        mine = range(n_pad) if block is None else block
        rows = slice(mine.start, mine.stop)
        if wdone == 0:
            carry, gens = engine.lane_init_loop(
                env, static_cfg, len(mine), self.algo, dev)(seeds[rows])
        else:
            stacked, states = self._load_carry(env, static_cfg, gp, n_pad)
            carry = tree_map(lambda x: x[rows].to(dev, copy=True), stacked)
            gens = [_generator(states[r], dev) for r in mine]
        chunks = [self._load_chunk(gp.window(w)) for w in range(wdone)]
        for w in range(wdone, W):
            if budget is not None and budget[0] <= 0:
                return None
            start, stop = slices[w]
            window = engine.lane_window_loop(env, static_cfg, self.T, names,
                                             stop - start, len(mine),
                                             self.algo, dev)
            carry, chunk = window(carry, gens, vals[rows],
                                  range(start, stop))
            done = {"carry": carry, "chunk": chunk, "generator":
                    torch.stack([g.get_state() for g in gens])}
            if span:                # every rank ends with every row
                done = gather_rows(mesh, done)
            chunks.append(done["chunk"])
            if budget is not None:
                budget[0] -= 1
            if writer and gp is not None:
                # carry + chunk first, progress record last: a crash
                # between the writes re-runs window w, never skips it
                with obs.host_span("sweep.commit", group=gi, window=w):
                    save({"carry": done["carry"],
                          "generator": done["generator"]}, gp.carry)
                    save(done["chunk"], gp.window(w))
                    mf.commit_window(gp, w + 1, stop)
            if obs.enabled():
                obs.record("sweep.window", group=gi, window=w,
                           t_done=stop, T=self.T)
                obs.progress(f"sweep group {gi}: window {w + 1}/{W} "
                             f"(t={stop}/{self.T})", group=gi, window=w)
        return engine.assemble_hist(done["carry"], chunks, self.algo)

    def _load_carry(self, env, static_cfg, gp, n_pad):
        """The group's stacked carries and generator states, on the host,
        validated against the carries' shapes and dtypes."""
        n_state = torch.Generator(device=self.device).get_state().numel()
        template = {"carry": engine.lane_carry_struct(env, static_cfg,
                                                      n_pad, self.algo),
                    "generator": torch.empty((n_pad, n_state),
                                             dtype=torch.uint8,
                                             device="meta")}
        tree = restore(template, gp.carry, device="cpu")
        return tree["carry"], tree["generator"]

    def _load_group(self, env, static_cfg, gp, W, n_pad):
        carry, _ = self._load_carry(env, static_cfg, gp, n_pad)
        chunks = [self._load_chunk(gp.window(w)) for w in range(W)]
        return engine.assemble_hist(carry, chunks, self.algo)

    @staticmethod
    def _load_chunk(path: str) -> dict:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

    def _summarize_group(self, hist, members, results, gi, n_groups):
        S = len(self.seeds)
        for i, (scn, cfg, _) in enumerate(members):
            # pad rows (if any) sit past the last member's: never read
            lane = {k: v[i * S:(i + 1) * S] for k, v in hist.items()}
            results[scn] = r = engine.summarize(lane, cfg)
            if obs.enabled():
                obs.record(
                    "sweep.partial",
                    scenario=engine.ExperimentResult.scenario_name(scn),
                    final_return_mean=r["final_return_mean"],
                    final_return_ci95=r["final_return_ci95"])
        if obs.enabled():
            obs.progress(f"sweep group {gi + 1}/{n_groups} complete",
                         group=gi, scenarios=len(members))
