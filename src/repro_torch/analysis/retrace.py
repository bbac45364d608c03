"""Config hygiene, lane groups, build-once and launch counts: the
counterpart of the JAX package's ``analysis/retrace.py``.

The reference counts XLA compiles: one per (algo, static signature),
none for a re-sweep of traced values or seeds. The port compiles no
program; what a sweep must not pay per value is the kernels' build and
their launches, and what its scenario keys and lane groups rely on is
config hygiene. Three layers:

* :func:`audit_static_config` — per registered algorithm
  (``REGISTRY.names("algo")``): the default config must construct
  (``default-config``); the config itself must hash
  (``unhashable-static``: ``Scenario`` keys, ``grid_scenarios`` and the
  sweep's group signatures rely on it); two equal configs must compare
  and hash equal (``unstable-static-key``: an ``object()`` default makes
  every instance its own scenario); configs built with two seeds must be
  one scenario once the seed is set aside, as the sweep's group
  signature sets it (``seed-in-static-key``);
  and two spellings of one spec, such as ``large_noise(sigma=10)`` and
  ``large_noise(sigma=10.0)``, must give one config
  (``spec-normalization``: ``normalize_spec_fields``). The lane rules are
  the reference's: every name of the algorithm's ``traced_fields`` must
  be a dataclass field or a derived property (``traced-field-missing``),
  and sweeping one must leave :func:`~repro_torch.core.engine.lane_split`'s
  static representative, its hash and its traced names unchanged
  (``traced-leaks-into-static``), or the sweep would split into one lane
  group per value.
* :func:`audit_builds` — ``build-once`` over a grid that sweeps K (up to
  ``_build.KMAX``), eta and the attack: the CPU route never calls
  ``_build.build()``; on the card the library is loaded at most once per
  process (none if it was loaded before), and no second ``nvcc`` runs
  (every ``build()`` after the first compile finds the library built,
  ``BUILD_INFO["seconds"]`` 0.0). :class:`BuildWatch` counts them, also
  over a whole script.

* :func:`audit_launches` — ``launch-count``, in place of the
  reference's compile count: a ``run_grid(lanes=True)`` over G lane
  groups launches, per iteration, exactly what single runs of the G
  groups' static configs launch (:class:`LaunchWatch` counts every
  kernel call, on the CPU's plain route as on the card), and a re-sweep
  with other traced values and seeds launches the same; more would mean
  a component ran its rows one at a time.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch

from repro_torch.analysis.findings import Finding

_BUILD_PATH = "src/repro_torch/kernels/_build.py"

#: per spec field, two spellings of one spec
SPELLINGS = {  # analysis: not-a-spec
    "attack": ("large_noise(sigma=10)", "large_noise(sigma=10.0)"),
    "aggregator": ("bucketing(s=2, inner=rfa)",
                   "bucketing(inner=rfa(), s=2)"),
    "agreement": ("mda", " mda "),
}


# ---------------------------------------------------------------------------
# Static audit
# ---------------------------------------------------------------------------


def _anchor(cls) -> tuple:
    try:
        path = inspect.getsourcefile(cls) or "<unknown>"
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        path, line = "<unknown>", 0
    return path, line


def _signature(cfg) -> str:
    """A config's scenario identity with the seed set aside: the sweep's
    group signature (``sweep/runner.py``)."""
    return repr(dataclasses.replace(cfg, seed=0))


def audit_static_config(algo: str, config_cls, traced_fields=()) -> list:
    """Config hygiene findings for one algorithm config class, with the
    lane rules for its ``traced_fields``."""
    path, line = _anchor(config_cls)
    findings = []

    def bad(rule, msg):
        findings.append(Finding("retrace", rule, path, line,
                                f"[{algo}] {msg}"))

    try:
        cfg = config_cls()
    except Exception as e:      # any failure is the finding
        bad("default-config", f"{config_cls.__name__}() must construct "
            f"(the analysis passes and grid defaults rely on it): {e}")
        return findings
    try:
        h1 = hash(cfg)
    except TypeError as e:
        bad("unhashable-static", f"the config is unhashable — Scenario "
            f"keys, grid_scenarios and the sweep's group signatures hash "
            f"it: {e}")
        return findings
    cfg2 = config_cls()
    if cfg != cfg2 or h1 != hash(cfg2):
        bad("unstable-static-key",
            "two identically-constructed configs differ — per-instance "
            "state (e.g. an object() default) makes every instance its "
            "own scenario")
        return findings
    fields = {f.name for f in dataclasses.fields(cfg)}
    if "seed" in fields and _signature(cfg) != _signature(
            config_cls(seed=cfg.seed + 17)):
        bad("seed-in-static-key",
            "the seed reaches the scenario's identity (a field derived "
            "from it at construction) — every seed would be its own "
            "scenario and sweep group (seeds are a batch, not an axis)")
    for name, (a, b) in SPELLINGS.items():
        if name not in fields:
            continue
        try:
            ca, cb = (config_cls(**{name: a}), config_cls(**{name: b}))
        except Exception as e:  # any failure is the finding
            bad("spec-normalization", f"{name}={a!r} does not construct: "
                f"{e}")
            continue
        if ca != cb or hash(ca) != hash(cb):
            bad("spec-normalization",
                f"{name}={a!r} and {name}={b!r} spell one spec but give "
                f"two configs — normalize the spec fields "
                f"(registry.normalize_spec_fields)")
    present = []
    for name in traced_fields:
        if hasattr(cfg, name):
            present.append(name)
        else:
            bad("traced-field-missing",
                f"traced field {name!r} is neither a dataclass field nor "
                f"a derived property — lane_split would crash on it")
    if not present:
        return findings
    from repro_torch.core import engine
    base_static, base_names, _ = engine.lane_split(cfg, tuple(present))
    for name in present:
        field = name if name in fields \
            else ("p" if name == "switch_p" and "p" in fields else None)
        if field is None:
            continue
        old = getattr(cfg, field)
        new = 0.375 if not isinstance(old, float) else old + 0.125
        static, names, _ = engine.lane_split(
            dataclasses.replace(cfg, **{field: new}), tuple(present))
        if static != base_static or hash(static) != hash(base_static) \
                or names != base_names:
            bad("traced-leaks-into-static",
                f"sweeping traced field {name!r} (via {field!r}) changes "
                f"the lane group's static representative — the sweep "
                f"would run one lane group per value")
    return findings


def audit_static() -> list:
    from repro_torch.core.registry import REGISTRY, resolve
    findings = []
    for algo in REGISTRY.names("algo"):
        a = resolve("algo", algo)
        findings.extend(audit_static_config(algo, a.config_cls,
                                            a.traced_fields))
    return findings


# ---------------------------------------------------------------------------
# Dynamic audit: build-once
# ---------------------------------------------------------------------------


class BuildWatch:
    """While active, counts the kernel library's ``_build.build()`` calls
    (``builds``: each call's ``BUILD_INFO["seconds"]``, > 0 where
    ``nvcc`` ran) and its loads (``loads``: ``_build.library()`` calls
    that found no library loaded), through the module's attributes, which
    every caller looks up when it runs."""

    def __init__(self):
        self.builds: list = []
        self.loads = 0

    def __enter__(self):
        from repro_torch.kernels import _build
        self._mod, self._saved = _build, (_build.build, _build.library)
        self.loaded_before = _build._LIB is not None
        build, library = self._saved

        def counted_build():
            try:
                return build()
            finally:
                self.builds.append(_build.BUILD_INFO.get("seconds", 0.0))

        def counted_library():
            if _build._LIB is None:
                self.loads += 1
            return library()

        _build.build, _build.library = counted_build, counted_library
        return self

    def __exit__(self, *exc):
        self._mod.build, self._mod.library = self._saved
        return False

    def findings(self, device, where: str) -> list:
        """``build-once`` findings for what was counted on ``device``."""
        out = []

        def bad(msg):
            out.append(Finding("retrace", "build-once", _BUILD_PATH, 0,
                               f"[{where}] {msg}"))

        compiles = [s for s in self.builds if s > 0]
        if torch.device(device).type != "cuda":
            if self.builds or self.loads:
                bad(f"the CPU route called _build.build() "
                    f"{len(self.builds)} time(s) and loaded the library "
                    f"{self.loads} time(s) — a CPU tensor takes the plain "
                    f"versions and builds nothing")
            return out
        if self.loads > (0 if self.loaded_before else 1):
            bad(f"the library was loaded {self.loads} time(s)"
                f"{' after an earlier load' if self.loaded_before else ''}"
                f" — it loads once per process")
        if len(compiles) > 1:
            bad(f"nvcc ran {len(compiles)} times ({compiles} s) — every "
                f"build after the first finds the library built")
        return out


def _grid_base() -> dict:
    return dict(n_byz=1, N=3, B=2, kappa=1, hidden=(4,), aggregator="rfa",
                agreement="mda")


def audit_builds(device="cpu", T: int = 2) -> list:
    """Run a grid sweeping K, eta and the attack on ``device`` under a
    :class:`BuildWatch` and return its ``build-once`` findings."""
    from repro_torch.core.engine import ScenarioGrid, run_grid
    from repro_torch.kernels._build import KMAX
    from repro_torch.rl.envs import make_env
    grid = ScenarioGrid(seeds=(0,), axes={
        "K": (3, min(5, KMAX)), "eta": (5e-3, 1e-2),
        "attack": ("none", "large_noise(sigma=1.0)")})
    with BuildWatch() as watch:
        run_grid(make_env("cartpole(horizon=8)"), grid, T, algo="decbyzpg",
                 device=device, **_grid_base())
    return watch.findings(device, "run_grid over K, eta and the attack")


class LaunchWatch:
    """While active, counts every call of every registered kernel
    (:class:`~repro_torch.kernels.dispatch.Kernel`), on the CPU's plain
    route as on the card: ``counts`` by kernel name."""

    def __enter__(self):
        from repro_torch.kernels import dispatch
        self._cls, self._saved = dispatch.Kernel, dispatch.Kernel.__call__
        self.counts: dict = {}
        call = self._saved

        def counted(kernel, *a, **k):
            self.counts[kernel.name] = self.counts.get(kernel.name, 0) + 1
            return call(kernel, *a, **k)

        dispatch.Kernel.__call__ = counted
        return self

    def __exit__(self, *exc):
        self._cls.__call__ = self._saved
        return False


def _launch_grid(etas, sigmas, seeds):
    from repro_torch.core.engine import ScenarioGrid
    return ScenarioGrid(seeds=seeds, axes={
        "eta": tuple(etas), "attack": tuple(
            f"large_noise(sigma={s})" for s in sigmas) + ("sign_flip",)})


def audit_launches(device="cpu", T: int = 2) -> list:
    """``launch-count``: a lane-grouped grid (a traced eta and sigma sweep
    over two attacks, so two groups) launches exactly what one single run
    of each group's static config launches, T iterations each; so does a
    re-sweep with other traced values and seeds."""
    from repro_torch.core import engine
    from repro_torch.core.registry import resolve
    from repro_torch.rl.envs import make_env
    env = make_env("cartpole(horizon=8)")
    base = dict(K=3, **_grid_base())
    a = resolve("algo", "decbyzpg")
    findings = []
    for etas, sigmas, seeds in (((5e-3, 1e-2), (1.0, 5.0), (0, 1)),
                                ((2e-2,), (3.0,), (2, 3, 4))):
        grid = _launch_grid(etas, sigmas, seeds)
        _, scenarios = engine.grid_scenarios(grid, base=base)
        groups = engine.lane_groups(scenarios)
        with LaunchWatch() as single:
            for members in groups.values():
                a.run(env, members[0][1], T, device=device)
        with LaunchWatch() as lanes:
            engine.run_grid(env, grid, T, algo="decbyzpg", device=device,
                            **base)
        if lanes.counts != single.counts:
            findings.append(Finding(
                "retrace", "launch-count",
                inspect.getsourcefile(engine.lane_batch_loop) or "<unknown>",
                0, f"a grid of {len(groups)} lane group(s) x {len(seeds)} "
                f"seed(s) launched {lanes.counts}, {len(groups)} single "
                f"runs {single.counts} — a component runs its rows one at "
                f"a time"))
    return findings


def run(device="cpu") -> list:
    return audit_static() + audit_builds(device) + audit_launches(device)
