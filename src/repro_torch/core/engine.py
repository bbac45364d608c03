"""Experiment engine: scenario grids over any config fields, seed batches
with mean ± CI summaries, and the declarative :class:`Experiment` front
door. The port of the JAX package's ``core/engine.py``.

* ``ScenarioGrid`` / ``run_grid``: declare a scenario product over any
  config fields (``axes={"K": (1, 5), "eta": (1e-3, 5e-3), "attack":
  ("none", "large_noise(sigma=10)")}``) and a seed batch; results come
  back keyed by a per-grid ``Scenario`` tuple with mean ± CI summaries.
* ``Experiment``: ``Experiment(algo=..., env=..., T=..., seeds=...,
  axes=..., **base)`` with ``.run()``, ``.summary()``, ``.to_json()``,
  built on the component registry, so every string is a component spec.

* Windows: ``window_slices`` cuts ``[0, T)`` as the reference does, and
  each algorithm's ``init``/``window``/``finish`` (its ``run`` is one
  window over ``[0, T)``) let the sweep service (``repro_torch.sweep``)
  run T a slice at a time; ``lane_carry_struct`` and ``assemble_hist``
  are the reference's, over a lane group's rows.

Lane batching (``run_grid(lanes=True)``, the default, as in the
reference): :func:`lane_split` splits a config into its static
representative and its traced scalars (the algorithm's
``traced_fields``, and the ``traced_kwargs`` of its attack and
aggregator specs); :func:`lane_groups` groups the scenarios that share a
static representative; each group runs as one program over its flattened
lanes × seeds rows (:func:`lane_batch_loop`, :func:`lane_init_loop`,
:func:`lane_window_loop`): the algorithm's step on tensors with a leading
row axis, every kernel launched once a step for all rows. A row keeps its
own generator (``seed_generator(seed, device)``), and each step's draws
are made per row, in the single run's order, then stacked, so a row
draws the bits of ``run_*(cfg(seed=s))`` on the same device; only the
arithmetic is batched. Where the reference counts compiles
(``compile_count``), the port counts launches: a lane group launches per
iteration what one run of its static config launches. ``lanes=False``
runs each scenario's seeds one at a time through the algorithm's own
``run``.

What the reference has for managing XLA compiles (the compiled-loop
cache, ``static_key``, carry donation) has no counterpart: the port
compiles nothing. A seed ``s`` means
``torch.Generator(device).manual_seed(s)`` (:func:`seed_generator`): a
run draws θ₀ and then every step's noise from it in order, so results
repeat per seed on one device, and match neither JAX's numbers nor
another device's.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.registry import Spec, resolve
from repro_torch.core.tree import tree_map


class AlgoDef(NamedTuple):
    """What the engine needs from an algorithm: its config dataclass and
    its single-run entry point ``run(env, cfg, T, *, device=None)``.
    ``carry_hist`` names the run output that holds the final iterate
    (``"theta"`` for DecByzPG's agent stack, ``"vec"`` for ByzPG's server
    iterate, in both ``carry[0]``), which the grid's histories stack per
    seed. ``run`` is ``init(env, cfg, generator, theta0=None,
    device=None) -> carry``, then ``window(env, cfg, carry, generator, 0,
    T) -> (carry, chunk)``, then ``finish(env, cfg, carry, [chunk]) ->
    output``; windows over consecutive slices with one generator chain to
    the same bits. Algorithm modules register one under
    ``register("algo", name)``.

    ``traced_fields`` names the config scalars the algorithm's step takes
    per row (its ``traced=`` mapping) instead of from the config: the
    static/traced split behind lane batching. Entries may be derived
    properties (``switch_p``); only real dataclass fields are blanked in
    the static representative. ``window(..., traced=)`` is the lane form:
    the carry has a leading row axis, ``generator`` is the rows' list of
    generators, and the chunk's histories are (R, W, ...)."""
    config_cls: type
    run: Callable
    init: Callable
    window: Callable
    finish: Callable
    carry_hist: str = "theta"
    traced_fields: Tuple[str, ...] = ()


def _algo(name) -> AlgoDef:
    return resolve("algo", name)


def seed_generator(seed: int, device) -> torch.Generator:
    """The generator a run with ``cfg.seed == seed`` draws from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def history(ys, names, rows: bool = False) -> dict:
    """A run's per-step outputs as numpy histories: column i of the
    steps' tuples under ``names[i]`` (names beyond the tuples' length are
    left out), time on axis 0, or on axis 1 behind a lane group's row axis
    (``rows``)."""
    # analysis: host-side (histories leave the device once, per window)
    return {name: torch.stack(col, dim=int(rows)).cpu().numpy()
            for name, col in zip(names, zip(*ys))}


# ---------------------------------------------------------------------------
# Static/traced config split (lane batching)
# ---------------------------------------------------------------------------


def traced_value(traced, name: str, default):
    """The per-row value of ``name`` when lane batching supplies one (an
    (R,) tensor), else the config's plain value (the steps call this for
    every scalar of their algorithm's ``traced_fields``)."""
    if traced is None:
        return default
    return traced.get(name, default)


def traced_spec_kwargs(traced, namespace: str, shape=(-1,)) -> dict:
    """The traced kwargs of ``namespace``'s component (stored under
    ``"<namespace>.<kwarg>"``), each reshaped to ``shape``, ready to pass
    as ``resolve`` context: an attack takes (R, 1, 1) multipliers, an
    aggregator (R,) values. A kwarg the rows share arrives as that one
    float32 value, a number (:func:`shared_values`)."""
    prefix = namespace + "."
    return {k[len(prefix):]: v if not isinstance(v, torch.Tensor)
            else v.reshape(shape)
            for k, v in (traced or {}).items() if k.startswith(prefix)}


def shared_values(traced: dict) -> dict:
    """A lane group's traced values (host tensors), with each component
    kwarg (``"attack.sigma"``, ``"aggregator.nu"``) that every row shares
    as a number, the float32 value the rows hold: the same bits in the
    component's arithmetic, and no per-row tensor where none is needed
    (``rfa``'s per-row ``nu`` is read to the host once a call)."""
    out = {}
    for k, v in traced.items():
        if "." in k and v.numel() and bool((v == v[0]).all()):
            out[k] = float(v[0])
        else:
            out[k] = v
    return out


def div_rows(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` for a number ``s``; for an (R,) tensor, each row of ``x``
    over its own value with the bits that ``x / float(s_r)`` gives on
    ``x``'s device: PyTorch divides by a Python number through its
    float32 reciprocal on CUDA, and divides truly on the CPU."""
    if not isinstance(s, torch.Tensor):
        return x / s
    s = s.reshape(-1, *(1,) * (x.dim() - 1))
    return x * (1.0 / s) if x.is_cuda else x / s


def lane_rows(cfg, traced: dict, device):
    """A lane window's set-up from its traced values (host tensors): the
    rows' configs for their draws (each with its row's ``switch_p`` as
    ``p``, the float32 value the step compares its coin draw with, as a
    single run does) and the traced values for the step, on ``device``
    (:func:`shared_values`)."""
    # analysis: host-side (the traced values are host tensors)
    ps = traced["switch_p"].tolist()
    cfgs = [dataclasses.replace(cfg, p=p) for p in ps]
    return cfgs, {k: v.to(device) if isinstance(v, torch.Tensor) else v
                  for k, v in shared_values(traced).items()}


def lane_split(cfg, traced_fields):
    """Split a config into ``(static_cfg, traced_names, traced_values)``.

    ``static_cfg`` is the lane-group representative: the config with its
    seed zeroed, every traced dataclass field blanked, and the traced
    kwargs stripped from its attack and aggregator specs, so two scenarios
    that differ only in traced scalars map to the same (hashable)
    representative and run as one group. ``traced_names`` /
    ``traced_values`` are the matching flat vector: the algorithm's
    ``traced_fields`` (derived properties like ``switch_p`` read but not
    blanked), then each spec field's traced kwargs as
    ``"<namespace>.<kwarg>"`` (``attack.sigma``, ``aggregator.nu``)."""
    from repro_torch.core.registry import REGISTRY
    traced = {name: float(getattr(cfg, name)) for name in traced_fields}
    fields = {f.name for f in dataclasses.fields(cfg)}
    repl = {name: 0.0 for name in traced_fields if name in fields}
    if "switch_p" in traced and "p" in fields:
        # p reaches the step only through the traced switch_p, so p=None
        # (default B/N) and an explicit equal p share a group
        repl["p"] = None
    for ns in ("attack", "aggregator"):
        if ns in fields:
            static_spec, kw = REGISTRY.split_traced(ns, getattr(cfg, ns))
            repl[ns] = static_spec
            for k, v in sorted(kw.items()):
                traced[f"{ns}.{k}"] = v
    static_cfg = dataclasses.replace(cfg, seed=0, **repl)
    names = tuple(traced)
    return static_cfg, names, tuple(traced[n] for n in names)


def add_telemetry(out: dict, hist: dict, n_byz: int) -> dict:
    """``out`` plus a telemetry run's gradient norms, rejected masks and
    their confusion tally against the Byzantine set (when ``hist`` holds
    them)."""
    if "rejected" in hist:
        out["grad_norm"] = hist["grad_norm"]
        out["rejected"] = hist["rejected"]
        out["aggregator_confusion"] = obs.confusion_tally(hist["rejected"],
                                                          n_byz)
    return out


# ---------------------------------------------------------------------------
# Scenario grids over arbitrary config axes
# ---------------------------------------------------------------------------


class Scenario(NamedTuple):
    """Legacy five-axis scenario key. Grids with other axes key results by
    a dynamically built namedtuple (``scenario_key``); namedtuples compare
    and hash as plain tuples, so positional lookups interoperate."""
    K: int
    n_byz: int
    attack: str
    aggregator: str
    agreement: str


_LEGACY_AXES = ("K", "n_byz", "attack", "aggregator", "agreement")
_LEGACY_DEFAULTS = {"K": (13,), "n_byz": (0,), "attack": ("none",),
                    "aggregator": ("rfa",), "agreement": ("mda",)}
#: per-step histories a run returns, stacked (S, T, ...) by the grid
_HIST_KEYS = ("returns", "coins", "diameter", "grad_norm", "rejected")


def scenario_key(names) -> type:
    """Keyed-tuple class for one grid's axis names. Equality/hashing are
    tuple-based, so keys from different grids (or plain tuples) with the
    same values in the same order compare equal."""
    return collections.namedtuple("Scenario", tuple(names))


def _as_axis(values) -> tuple:
    return values if isinstance(values, tuple) else \
        tuple(values) if isinstance(values, (list, range)) else (values,)


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """Cartesian scenario axes × a seed batch.

    Axes sweep **any** config field: ``axes={"eta": (1e-3, 5e-3),
    "attack": ("none", "large_noise(sigma=10)")}``. The five historical
    axes remain available as keyword fields; constructing a grid with only
    those (or with none) reproduces the historical five-axis product with
    its old defaults. When an ``axes`` mapping is given, it alone defines
    the sweep unless legacy fields are also set, in which case the five
    legacy axes (defaults filled) are extended/overridden by ``axes``.
    """
    seeds: Tuple[int, ...] = (0, 1, 2)
    K: Optional[Tuple[int, ...]] = None
    n_byz: Optional[Tuple[int, ...]] = None
    attack: Optional[Tuple] = None
    aggregator: Optional[Tuple] = None
    agreement: Optional[Tuple] = None
    axes: Optional[Mapping] = None

    def resolved_axes(self) -> dict:
        """Axis name -> tuple of values, in scenario-key order."""
        legacy = {n: _as_axis(getattr(self, n)) for n in _LEGACY_AXES
                  if getattr(self, n) is not None}
        extra = {k: _as_axis(v) for k, v in dict(self.axes or {}).items()}
        if self.axes is not None and not legacy:
            return extra
        return {**_LEGACY_DEFAULTS, **legacy, **extra}

    def explicit_axes(self) -> set:
        """Axis names the caller actually asked for (vs legacy defaults
        filled in for the historical five-axis grid shape)."""
        return ({n for n in _LEGACY_AXES if getattr(self, n) is not None}
                | set(dict(self.axes or {})))

    def scenarios(self):
        """Yield one keyed Scenario tuple per axis combination; use
        ``._asdict()`` for the ``{axis: value}`` mapping."""
        axes = self.resolved_axes()
        key_cls = scenario_key(axes)
        for combo in itertools.product(*axes.values()):
            yield key_cls(*combo)


def summarize(hist: dict, cfg) -> dict:
    """Host-side statistics for one scenario's (S, T) seed batch."""
    out = {k: np.asarray(v) for k, v in hist.items()}
    coins = out.pop("coins")
    out["samples"] = np.cumsum(np.where(coins, cfg.N, cfg.B), axis=-1)
    rets = out["returns"]
    S = rets.shape[0]
    sem = (rets.std(axis=0, ddof=1) / np.sqrt(S)) if S > 1 \
        else np.zeros(rets.shape[-1])
    out["returns_mean"] = rets.mean(axis=0)
    out["returns_ci95"] = 1.96 * sem
    final = rets[:, -3:].mean(axis=-1)
    out["final_return_mean"] = float(final.mean())
    out["final_return_ci95"] = float(
        1.96 * final.std(ddof=1) / np.sqrt(S)) if S > 1 else 0.0
    if "diameter" in out:
        # the paper's Δ₂ agreement diagnostic, reported alongside returns
        diam = out["diameter"]
        out["diameter_mean"] = diam.mean(axis=0)
        out["final_diameter_mean"] = float(diam[:, -1].mean())
    if "rejected" in out:
        # telemetry (cfg.telemetry): aggregator-as-detector tally of the
        # per-round rejected masks against the configured Byzantine set
        out["grad_norm_mean"] = out["grad_norm"].mean(axis=0)
        out["aggregator_confusion"] = obs.confusion_tally(
            out["rejected"], getattr(cfg, "n_byz", 0))
    return out


def _check_override(cfg_before, cfg_after, assign: dict) -> None:
    """An ``override`` hook may derive non-axis fields from axis values,
    but must not mutate an axis field itself: the result would silently
    diverge from the Scenario key it is filed under."""
    changed = [n for n in assign
               if getattr(cfg_after, n) != getattr(cfg_before, n)]
    if changed:
        raise ValueError(
            f"override mutated swept axis field(s) {changed}: the config "
            f"would no longer match its Scenario key {assign}; sweep the "
            f"desired values as an axis instead")


def grid_scenarios(grid: ScenarioGrid, algo="decbyzpg",
                   override: Optional[Callable] = None,
                   base: Optional[dict] = None):
    """Resolve a grid into ``(axes, [(scenario_key, cfg), ...])``: axis
    validation, base-field merging, and the ``override`` hook with its
    axis-mutation check, in a deterministic order (itertools.product over
    the axis mapping)."""
    a = _algo(Spec.of(algo))
    base = dict(base or {})
    cfg_cls = a.config_cls
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    axes = grid.resolved_axes()
    # legacy-default axes a config doesn't know (e.g. "agreement" for
    # ByzPG) stay in the key but are dropped from the config, as the
    # historical five-axis grid did; explicitly requested axes must exist.
    unknown = ((set(base) | (set(axes) & grid.explicit_axes()))
               - fields)
    if unknown:
        raise TypeError(f"unknown {cfg_cls.__name__} fields: "
                        f"{sorted(unknown)}")
    overlap = set(base) & set(axes)
    explicit_overlap = overlap & grid.explicit_axes()
    if explicit_overlap:
        raise TypeError(f"fields both swept and fixed: "
                        f"{sorted(explicit_overlap)}")
    # base may pin an axis the grid only holds as a legacy default: the
    # pinned value becomes that axis's single point (and its key value)
    for n in overlap:
        axes[n] = (base.pop(n),)
    key_cls = scenario_key(axes)
    scenarios = []
    for combo in itertools.product(*axes.values()):
        assign = {k: v for k, v in zip(axes, combo) if k in fields}
        cfg = cfg_cls(**{**base, **assign})
        if override is not None:
            cfg2 = override(cfg)
            _check_override(cfg, cfg2, assign)
            cfg = cfg2
        scenarios.append((key_cls(*combo), cfg))
    return axes, scenarios


def seed_batch(a: AlgoDef, env, cfg, T: int, seeds, device=None) -> dict:
    """One scenario's histories over the seed batch: one ``a.run`` per
    seed, stacked into (S, T, ...) arrays, with the final iterates as
    ``a.carry_hist`` (S, ...)."""
    runs = [a.run(env, dataclasses.replace(cfg, seed=s), T, device=device)
            for s in seeds]
    hist = {k: np.stack([r[k] for r in runs]) for k in _HIST_KEYS
            if k in runs[0]}
    # analysis: host-side (the grid's summaries are numpy, per scenario)
    hist[a.carry_hist] = torch.stack(
        [r[a.carry_hist] for r in runs]).cpu().numpy()
    return hist


def run_grid(env, grid: ScenarioGrid, T: int, algo="decbyzpg",
             override: Optional[Callable] = None, lanes: bool = True,
             device=None, **base) -> dict:
    """Run every scenario in ``grid`` for ``T`` iterations on ``device``
    (default CUDA).

    ``base`` sets non-axis config fields (N, B, eta, kappa, ...);
    ``override(cfg) -> cfg`` applies per-scenario adjustments to
    *non-axis* fields derived from axis values (e.g. fig2's kappa=0 naive
    baseline); mutating a swept axis field raises, since the config would
    silently diverge from its Scenario key. Returns ``{Scenario: summary
    dict}`` with per-seed histories plus mean ± 95% CI curves, keyed by
    the grid's keyed tuple over its axis names.

    With ``lanes=True`` (the default) the scenarios are grouped by static
    representative (:func:`lane_groups`) and each group runs as one
    lane-batched program over its lanes × seeds rows
    (:func:`lane_batch_loop`): an L-point scalar sweep (eta, gamma, an
    attack's sigma, rfa's nu, ...) launches per iteration what one run
    launches, instead of L × S times that. On a lane mesh the rows are
    padded to a multiple of its size (:func:`_pad_rows`; the pad rows are
    sliced off before the summaries). ``lanes=False`` runs each scenario's
    seeds one at a time through the algorithm's ``run``.
    """
    _, scenarios = grid_scenarios(grid, algo=algo, override=override,
                                  base=base)
    a = _algo(Spec.of(algo))
    results = {}
    if not lanes:
        for si, (scn, cfg) in enumerate(scenarios):
            if obs.enabled():
                obs.progress(f"run_grid {si + 1}/{len(scenarios)}: "
                             f"{dict(scn._asdict())}",
                             scenario=si, total=len(scenarios))
            with obs.host_span("run_grid.scenario", scenario=si):
                hist = seed_batch(a, env, cfg, T, grid.seeds, device)
            results[scn] = summarize(hist, cfg)
        return results
    from repro_torch.distributed.sharding import lane_mesh, padded_rows
    groups = lane_groups(scenarios, algo=algo)
    mesh = lane_mesh()
    S = len(grid.seeds)
    for gi, ((static_cfg, names), members) in enumerate(groups.items()):
        L = len(members)
        rows = L * S
        n_pad = padded_rows(mesh, rows)
        if obs.enabled():
            obs.progress(f"run_grid group {gi + 1}/{len(groups)}: "
                         f"{L} lane(s) x {S} seed(s)",
                         group=gi, lanes=L, seeds=S)
        loop = lane_batch_loop(env, static_cfg, T, names, n_pad, algo,
                               device)
        vals, seeds = lane_operands(members, grid.seeds, n_pad)
        with obs.host_span("run_grid.group", group=gi, lanes=L, rows=rows):
            hist = loop(vals, seeds)
        for i, (scn, cfg, _) in enumerate(members):
            # the per-scenario slice never reaches the pad rows (i < L)
            lane = {k: v[i * S:(i + 1) * S] for k, v in hist.items()}
            results[scn] = summarize(lane, cfg)
    return {scn: results[scn] for scn, _ in scenarios}


# ---------------------------------------------------------------------------
# Windowed execution (the sweep service)
# ---------------------------------------------------------------------------


def window_slices(T: int, windows: int) -> tuple:
    """Split ``[0, T)`` into ``windows`` contiguous ``(start, stop)``
    slices, near-equal with the remainder spread over the leading
    windows (the reference's slicing, so a sweep directory's manifest
    names the same windows in both packages)."""
    if not 1 <= windows <= T:
        raise ValueError(f"windows must be in [1, T={T}], got {windows}")
    base, rem = divmod(T, windows)
    out, start = [], 0
    for w in range(windows):
        stop = start + base + (1 if w < rem else 0)
        out.append((start, stop))
        start = stop
    return tuple(out)


def stack_rows(trees):
    """One tree with a leading row axis from a list of same-shaped trees
    (the rows' carries, or their chunks' numpy histories)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)
    return tree_map(stack, *trees)


def lane_carry_struct(env, cfg, n_rows: int, algo="decbyzpg"):
    """The shapes and dtypes of ``n_rows`` stacked carries as tensors on
    the ``meta`` device, drawn from no generator: the restore template of
    a sweep's carry archive (a lane group's rows, :func:`lane_init_loop`'s
    carry)."""
    from repro_torch.rl.policy import resolve_policy
    a = _algo(Spec.of(algo))
    d = resolve_policy(cfg, env).d
    carry = a.init(env, cfg, None, torch.zeros(d), device="meta")
    return tree_map(lambda x: x.expand(n_rows, *x.shape), carry)


def assemble_hist(carry, chunks, algo="decbyzpg") -> dict:
    """Stitch window chunks (leading row axis, time axis 1) and the final
    stacked carry into :func:`lane_batch_loop`'s history dict: the
    histories concatenated along time plus the algorithm's ``carry_hist``
    (the rows' ``carry[0]``), bit-identical to the uninterrupted run."""
    a = _algo(Spec.of(algo))
    # analysis: host-side (the sweep's histories are numpy, once at its end)
    hist = {a.carry_hist: carry[0].cpu().numpy()}
    for k in chunks[0]:
        hist[k] = np.concatenate([np.asarray(c[k]) for c in chunks], axis=1)
    return hist


# ---------------------------------------------------------------------------
# Lane groups: one program over a group's lanes × seeds rows
# ---------------------------------------------------------------------------


def lane_groups(scenarios, algo="decbyzpg") -> dict:
    """Group ``(scenario, cfg)`` pairs by their static representative
    (:func:`lane_split`): ``{(static_cfg, names): [(scn, cfg, vals)]}`` in
    first-appearance order. A group is both what one lane-batched program
    runs and what the sweep service checkpoints."""
    a = _algo(Spec.of(algo))
    groups: dict = {}
    for scn, cfg in scenarios:
        static_cfg, names, vals = lane_split(cfg, a.traced_fields)
        groups.setdefault((static_cfg, names), []).append((scn, cfg, vals))
    return groups


def _pad_rows(x, n_pad: int):
    """Pad a leading row axis to ``n_pad`` by repeating the last row: pad
    rows are valid, redundant runs whose outputs are sliced off before
    the summaries, so an uneven group still splits evenly over the lane
    mesh's processes."""
    n = x.shape[0]
    if n == n_pad:
        return x
    return torch.cat([x, x[-1:].expand(n_pad - n, *x.shape[1:])])


def lane_operands(members, seeds, n_pad: int):
    """The flattened ``(vals (n_pad, n), seeds (n_pad,))`` of one lane
    group's members × the seed batch (row ``i·S + j`` is member i under
    seed j), padded by :func:`_pad_rows`. The traced values go float64 on
    the host and are rounded to float32 once, as ``lanes=False`` rounds
    the Python numbers it computes with; both stay on the host (the
    draws read the rows' ``switch_p`` there)."""
    S = len(seeds)
    vals = np.asarray([m[2] for m in members], np.float64).reshape(
        len(members), -1)
    vals_flat = torch.as_tensor(np.repeat(vals, S, axis=0),
                                dtype=torch.float32)
    seeds_flat = torch.as_tensor(np.tile(np.asarray(seeds, np.int64),
                                         len(members)))
    return _pad_rows(vals_flat, n_pad), _pad_rows(seeds_flat, n_pad)


def _traced(names, vals) -> dict:
    return {n: vals[:, i].contiguous() for i, n in enumerate(names)}


def lane_init_loop(env, static_cfg, n_rows: int, algo="decbyzpg",
                   device=None):
    """``init(seeds (R,), theta0=None) -> (carry, generators)``: each
    row's carry from its own ``seed_generator(seed, device)``, as the
    single run for that seed builds it, stacked along a leading row axis,
    and the rows' generators, advanced past θ₀'s draws. ``theta0``
    (test-only, (R, d), as ``run_decbyzpg(theta0=)``) replaces the rows'
    θ₀ draws."""
    a = _algo(Spec.of(algo))
    dev = resolve_device(device)

    def init(seeds, theta0=None):
        seeds = [int(s) for s in seeds]
        if len(seeds) != n_rows:
            raise ValueError(f"lane init: {len(seeds)} seeds for "
                             f"{n_rows} rows")
        gens = [seed_generator(s, dev) for s in seeds]
        carry = stack_rows([
            a.init(env, static_cfg, g, None if theta0 is None
                   else theta0[r], device=dev)
            for r, g in enumerate(gens)])
        return carry, gens

    return init


def lane_window_loop(env, static_cfg, T: int, traced_names, W: int,
                     n_rows: int, algo="decbyzpg", device=None):
    """``window(carry, generators, vals (R, n), ts (W,), noise=None) ->
    (carry, chunk)``: iterations ``ts`` (contiguous, absolute, inside
    ``[0, T)``) of a lane group's R rows as one batched step each, the
    rows' traced values taken from ``vals`` and their draws from their
    generators. Chaining the windows of :func:`window_slices` over one
    carry and one set of generators is :func:`lane_batch_loop`, bit for
    bit. ``noise`` (test-only) gives each row its whole run's T
    StepNoise, replacing the draws."""
    a = _algo(Spec.of(algo))
    names = tuple(traced_names)

    def window(carry, gens, vals, ts, noise=None):
        t0 = int(ts[0])
        if [int(t) for t in ts] != list(range(t0, t0 + W)) or t0 + W > T:
            raise ValueError(f"lane window: ts must be {W} consecutive "
                             f"iterations inside [0, {T})")
        if len(gens) != n_rows or vals.shape[0] != n_rows:
            raise ValueError(f"lane window: {len(gens)} generators and "
                             f"{vals.shape[0]} rows of values for "
                             f"{n_rows} rows")
        return a.window(env, static_cfg, carry, gens, t0, t0 + W, noise,
                        traced=_traced(names, vals))

    return window


def lane_batch_loop(env, static_cfg, T: int, traced_names, n_rows: int,
                    algo="decbyzpg", device=None):
    """``loop(vals (R, n), seeds (R,), noise=None) -> history dict``: one
    lane group's R = lanes × seeds rows for T iterations, histories (R, T,
    ...) and the rows' final ``carry_hist``. One program serves every
    scenario sharing ``static_cfg``: each row starts from its seed's
    generator and takes its traced scalars (eta, gamma, switch_p, an
    attack's sigma, rfa's nu, ...) from its row of ``vals``, and each step
    launches every kernel once for all rows.

    On a lane mesh (:func:`repro_torch.distributed.sharding.lane_mesh`,
    a process group) whose size divides R, each process runs its block of
    rows and every process ends with every row
    (:func:`~repro_torch.distributed.sharding.lane_out_sharding`).
    ``noise`` and ``theta0`` (test-only, as ``run_decbyzpg(noise=,
    theta0=)``) give each row its whole run's T StepNoise and its θ₀,
    replacing the draws."""
    from repro_torch.distributed.sharding import (gather_rows, lane_mesh,
                                                  lane_sharding)
    a = _algo(Spec.of(algo))
    names = tuple(traced_names)
    mesh = lane_mesh()
    block = lane_sharding(mesh, n_rows)
    mine = range(n_rows) if block is None else block
    init = lane_init_loop(env, static_cfg, len(mine), algo, device)
    window = lane_window_loop(env, static_cfg, T, names, T, len(mine), algo,
                              device)

    def loop(vals, seeds, noise=None, theta0=None):
        if len(seeds) != n_rows:
            raise ValueError(f"lane batch: {len(seeds)} seeds for {n_rows} "
                             f"rows")
        rows = slice(mine.start, mine.stop)
        carry, gens = init(seeds[rows],
                           None if theta0 is None else theta0[rows])
        carry, chunk = window(carry, gens, vals[rows], range(T),
                              None if noise is None else noise[rows])
        # analysis: host-side (histories leave the device once, per group)
        hist = {a.carry_hist: carry[0].cpu().numpy(), **chunk}
        return hist if block is None else gather_rows(mesh, hist)

    return loop


# ---------------------------------------------------------------------------
# Declarative Experiment API
# ---------------------------------------------------------------------------


def _axis_str(v) -> str:
    """Canonical display form of one scenario-axis value."""
    return v.canonical() if isinstance(v, Spec) else str(v)


def _axis_eq(a, b) -> bool:
    """Axis-value equality with Spec/string interchangeability: a Spec
    matches its spec string (and vice versa)."""
    if a == b:
        return True
    if isinstance(a, Spec) or isinstance(b, Spec):
        try:
            return Spec.of(a) == Spec.of(b)
        except Exception:
            return False
    return False


class ExperimentResult:
    """Results of one :class:`Experiment` run: a mapping from scenario key
    (keyed tuple over the experiment's axis names) to summary dict, plus
    JSON/plaintext reporting."""

    def __init__(self, meta: dict, axes: dict, results: dict):
        self.meta = meta
        self.axes = axes
        self.results = results

    def __getitem__(self, key):
        return self.results[key]

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)

    def items(self):
        return self.results.items()

    def keys(self):
        return self.results.keys()

    def sel(self, **axes):
        """The unique scenario matching the given axis values, e.g.
        ``res.sel(aggregator="rfa")``. Spec-valued axes match their
        string/canonical forms interchangeably. Under-specified queries
        raise a ``KeyError`` naming the still-free axes (and their
        values) instead of dumping every scenario tuple."""
        names = list(self.axes)
        bad = set(axes) - set(names)
        if bad:
            raise KeyError(f"{sorted(bad)} are not sweep axes of this "
                           f"experiment; axes: {sorted(names)}")
        matches = [s for s in self.results
                   if all(_axis_eq(getattr(s, k), v)
                          for k, v in axes.items())]
        if len(matches) == 1:
            return self.results[matches[0]]
        query = ", ".join(f"{k}={_axis_str(v)}" for k, v in axes.items())
        if not matches:
            raise KeyError(
                f"sel({query}) matches no scenario; axis values: "
                + "; ".join(f"{k} in {[_axis_str(v) for v in vals]}"
                            for k, vals in self.axes.items()))
        free = [k for k in names if k not in axes and
                len({_axis_str(getattr(s, k)) for s in matches}) > 1]
        raise KeyError(
            f"sel({query}) is under-specified: {len(matches)} scenarios "
            f"match; also constrain the free axis(es) "
            + "; ".join(f"{k} in {sorted({_axis_str(getattr(s, k)) for s in matches})}"
                        for k in free))

    @staticmethod
    def scenario_name(scn) -> str:
        """Stable ``"axis=value,..."`` name: Spec-valued entries render as
        their canonical spec string, so the name is identical whether the
        axis value was given as a Spec or its string form."""
        if not scn:
            return "base"
        return ",".join(f"{k}={_axis_str(v)}"
                        for k, v in zip(scn._fields, scn))

    def summary(self) -> dict:
        """Compact per-scenario statistics keyed by ``"axis=value,..."``."""
        out = {}
        for scn, r in self.results.items():
            entry = {
                "final_return_mean": r["final_return_mean"],
                "final_return_ci95": r["final_return_ci95"],
                "samples_per_agent": float(
                    np.asarray(r["samples"])[:, -1].mean()),
            }
            # Δ₂ diagnostic; absent for algos without agreement (ByzPG)
            if "final_diameter_mean" in r:
                entry["honest_diameter_final"] = r["final_diameter_mean"]
            # aggregator-as-Byzantine-detector forensics (cfg.telemetry)
            if "aggregator_confusion" in r:
                conf = r["aggregator_confusion"]
                entry["aggregator_precision"] = conf["precision"]
                entry["aggregator_recall"] = conf["recall"]
            out[self.scenario_name(scn)] = entry
        return out

    def to_json(self, path=None, curves: bool = True):
        """JSON document (written to ``path`` when given) with experiment
        metadata and per-scenario summaries; ``curves`` includes the
        mean ± CI return curves (per-seed parameter arrays are omitted)."""
        doc = {"experiment": self.meta, "scenarios": []}
        summ = self.summary()
        for scn, r in self.results.items():
            entry = {"scenario": dict(zip(scn._fields, [
                v.canonical() if isinstance(v, Spec) else v for v in scn])),
                **summ[self.scenario_name(scn)]}
            if curves:
                # analysis: host-side (numpy summaries to JSON lists)
                entry["returns_mean"] = np.asarray(
                    r["returns_mean"]).tolist()
                # analysis: host-side
                entry["returns_ci95"] = np.asarray(
                    r["returns_ci95"]).tolist()
                # analysis: host-side
                entry["samples_mean"] = np.asarray(
                    r["samples"]).mean(axis=0).tolist()
            doc["scenarios"].append(entry)
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
        return doc


class Experiment:
    """Declarative experiment over :func:`run_grid`.

    ::

        Experiment(algo="byzpg", env="cartpole(horizon=100)", T=15,
                   seeds=3, axes={"attack": ("large_noise", "avg_zero"),
                                  "aggregator": ("rfa", "mean")},
                   K=13, n_byz=3, N=20, B=4, eta=2e-2).run()

    ``axes`` sweeps any config fields (values are component spec strings,
    Specs, or plain values); remaining keyword arguments fix base config
    fields. ``seeds`` is a tuple of seeds or an int (``range(seeds)``);
    ``env`` is an ``Env`` or an env spec resolved through the registry.
    ``override(cfg) -> cfg`` derives non-axis fields per scenario and is
    validated against axis mutation exactly like :func:`run_grid` (it is
    the same check: ``run()`` executes through ``run_grid``). ``lanes``
    (default True) is :func:`run_grid`'s. ``device`` (default CUDA) is
    where every run goes.
    """

    def __init__(self, algo="decbyzpg", env="cartpole", T: int = 50,
                 seeds=(0, 1, 2), axes: Optional[Mapping] = None,
                 override: Optional[Callable] = None, lanes: bool = True,
                 device=None, **base):
        self.algo = Spec.of(algo)
        self.env_spec = env
        self.T = int(T)
        self.seeds = tuple(range(seeds)) if isinstance(seeds, int) \
            else tuple(seeds)
        self.axes = {k: _as_axis(v) for k, v in dict(axes or {}).items()}
        self.override = override
        self.lanes = lanes
        self.device = device
        self.base = base
        self._result: Optional[ExperimentResult] = None

    @property
    def env(self):
        from repro_torch.rl.envs import make_env
        return make_env(self.env_spec)

    def run(self, force: bool = False) -> ExperimentResult:
        """Execute the grid, or return the cached result of an earlier
        ``run()``; ``force=True`` runs it again."""
        if self._result is not None and not force:
            return self._result
        env = self.env
        grid = ScenarioGrid(seeds=self.seeds, axes=self.axes)
        results = run_grid(env, grid, self.T, algo=self.algo,
                           override=self.override, lanes=self.lanes,
                           device=self.device, **self.base)
        meta = {"algo": self.algo.canonical(),
                "env": (Spec.of(self.env_spec).canonical()
                        if isinstance(self.env_spec, (str, Spec))
                        else env.name),
                "T": self.T, "seeds": list(self.seeds),
                "axes": {k: [v.canonical() if isinstance(v, Spec) else v
                             for v in vals]
                         for k, vals in self.axes.items()},
                "base": {k: (v.canonical() if isinstance(v, Spec) else
                             repr(v) if not isinstance(
                                 v, (int, float, bool, str, type(None)))
                             else v)
                         for k, v in self.base.items()},
                # marker only: the hook itself is code and can't round-trip
                "override": (getattr(self.override, "__qualname__",
                                     repr(self.override))
                             if self.override is not None else None)}
        self._result = ExperimentResult(meta, self.axes, results)
        return self._result

    def summary(self) -> dict:
        return self.run().summary()

    def to_json(self, path=None, curves: bool = True):
        return self.run().to_json(path, curves=curves)
