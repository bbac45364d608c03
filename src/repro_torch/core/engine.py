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
  run T a slice at a time; ``carry_struct`` and ``assemble_hist`` are the
  reference's ``lane_carry_struct`` and ``assemble_hist`` over a seed
  batch's rows.

What the reference has for managing XLA compiles (the compiled-loop
cache, lane batching of scalar axes, ``static_key``, carry donation) has
no counterpart: the port compiles nothing. Each scenario's seeds run one
at a time through the algorithm's own ``run``, so every seed's history is
bit-identical to the single run for that seed. A seed ``s`` means
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

from repro_torch import obs
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
    ``register("algo", name)``."""
    config_cls: type
    run: Callable
    init: Callable
    window: Callable
    finish: Callable
    carry_hist: str = "theta"


def _algo(name) -> AlgoDef:
    return resolve("algo", name)


def seed_generator(seed: int, device) -> torch.Generator:
    """The generator a run with ``cfg.seed == seed`` draws from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def history(ys, names) -> dict:
    """A run's per-step outputs as numpy histories: column i of the
    steps' tuples under ``names[i]`` (names beyond the tuples' length are
    left out)."""
    # analysis: host-side (histories leave the device once, per window)
    return {name: torch.stack(col).cpu().numpy()
            for name, col in zip(names, zip(*ys))}


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
             override: Optional[Callable] = None, device=None,
             **base) -> dict:
    """Run every scenario in ``grid`` for ``T`` iterations on ``device``
    (default CUDA).

    ``base`` sets non-axis config fields (N, B, eta, kappa, ...);
    ``override(cfg) -> cfg`` applies per-scenario adjustments to
    *non-axis* fields derived from axis values (e.g. fig2's kappa=0 naive
    baseline); mutating a swept axis field raises, since the config would
    silently diverge from its Scenario key. Returns ``{Scenario: summary
    dict}`` with per-seed histories plus mean ± 95% CI curves, keyed by
    the grid's keyed tuple over its axis names.
    """
    _, scenarios = grid_scenarios(grid, algo=algo, override=override,
                                  base=base)
    a = _algo(Spec.of(algo))
    results = {}
    for si, (scn, cfg) in enumerate(scenarios):
        if obs.enabled():
            obs.progress(f"run_grid {si + 1}/{len(scenarios)}: "
                         f"{dict(scn._asdict())}",
                         scenario=si, total=len(scenarios))
        with obs.host_span("run_grid.scenario", scenario=si):
            hist = seed_batch(a, env, cfg, T, grid.seeds, device)
        results[scn] = summarize(hist, cfg)
    return results


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


def carry_struct(env, cfg, n_rows: int, algo="decbyzpg"):
    """The shapes and dtypes of ``n_rows`` stacked carries as tensors on
    the ``meta`` device, drawn from no generator: the restore template of
    a sweep's carry archive (the reference's ``lane_carry_struct``)."""
    from repro_torch.rl.policy import resolve_policy
    a = _algo(Spec.of(algo))
    d = resolve_policy(cfg, env).d
    carry = a.init(env, cfg, None, torch.zeros(d), device="meta")
    return tree_map(lambda x: x.expand(n_rows, *x.shape), carry)


def assemble_hist(carry, chunks, algo="decbyzpg") -> dict:
    """Stitch window chunks (leading row axis, time axis 1) and the final
    stacked carry into :func:`seed_batch`'s history dict: the histories
    concatenated along time plus the algorithm's ``carry_hist`` (the
    rows' ``carry[0]``), bit-identical to the uninterrupted runs."""
    a = _algo(Spec.of(algo))
    # analysis: host-side (the sweep's histories are numpy, once at its end)
    hist = {a.carry_hist: carry[0].cpu().numpy()}
    for k in chunks[0]:
        hist[k] = np.concatenate([np.asarray(c[k]) for c in chunks], axis=1)
    return hist


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
    the same check: ``run()`` executes through ``run_grid``). ``device``
    (default CUDA) is where every run goes.
    """

    def __init__(self, algo="decbyzpg", env="cartpole", T: int = 50,
                 seeds=(0, 1, 2), axes: Optional[Mapping] = None,
                 override: Optional[Callable] = None, device=None,
                 **base):
        self.algo = Spec.of(algo)
        self.env_spec = env
        self.T = int(T)
        self.seeds = tuple(range(seeds)) if isinstance(seeds, int) \
            else tuple(seeds)
        self.axes = {k: _as_axis(v) for k, v in dict(axes or {}).items()}
        self.override = override
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
                           override=self.override, device=self.device,
                           **self.base)
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
