"""Draw discipline over the port's real entry points: the counterpart of
the JAX package's ``analysis/keycheck.py``.

The paper's variance-reduction and robustness arguments assume the K
agents' trajectory batches are independent draws; a reused stream
silently correlates them without failing any numeric test. The reference
walks the jaxprs of its fused loops for PRNG-key dataflow. The port
draws each step's randomness up front from one ``torch.Generator``
(:mod:`repro_torch.core.noise`), so this pass runs the real entry points small
under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
(:class:`DrawRecorder`) that records every random aten op (``uniform_``,
``normal_``, ``random_``, ``bernoulli_``, ``exponential_``, ``randperm``,
``multinomial``, ...) with the generator's state before the draw: a hash
of the Mersenne state on the CPU, (seed, offset) on CUDA. Between steps it
also follows which draws each tensor derives from, and a :class:`Tap` on
each run's step records the noise each step consumes. Contracts:

* ``key-reuse`` — two draws of one run start from the same generator
  state: a cloned state, or two generators seeded alike (the reference's
  ``key-reuse`` and ``double-split``);
* ``global-generator`` — a draw from a default generator;
* ``step-invariant-draw`` — a T-step run consumes fewer than T draws in
  one :class:`~repro_torch.core.noise.StepNoise` or ``FedNoise`` field:
  noise drawn once outside the loop (the reference's
  ``scan-invariant-sample``);
* ``per-agent-fanout`` — a step's ``gumbel`` or ``s0`` is not one K-wide
  draw (one per row of a lane group, which stacks its rows' draws), or
  two agents' rows of it are bit-equal.

The reference's ``sample-then-derive`` has no counterpart: a generator is
not split, it advances.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import os
import sys
from typing import Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding

#: aten ops that draw from a generator (the overload's base name)
DRAW_OPS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "uniform_", "normal_", "normal", "random_",
    "bernoulli_", "bernoulli", "exponential_", "geometric_", "log_normal_",
    "cauchy_", "multinomial", "poisson", "native_dropout"})

_TORCH_DIR = os.path.dirname(torch.__file__)


@dataclasses.dataclass(frozen=True)
class Draw:
    """One random op: its aten name, the generator state it started from
    (``state``; ``shown`` for messages), whether that was a default
    generator, its output shape and the innermost frame outside torch."""
    index: int
    op: str
    state: tuple
    shown: str
    default: bool
    shape: tuple
    path: str
    line: int


def _site() -> tuple:
    """The innermost frame outside torch: the draw's caller."""
    f = sys._getframe(2)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if not name.startswith(_TORCH_DIR):
            return name, f.f_lineno
        f = f.f_back
    return "<unknown>", 0


def _generator_of(func, args, kwargs) -> Optional[torch.Generator]:
    if "generator" in kwargs:
        return kwargs["generator"]
    for i, a in enumerate(func._schema.arguments):
        if a.name == "generator":
            return args[i] if i < len(args) else None
    return None


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def generator_state(gen: torch.Generator) -> tuple:
    """``(key, shown)``: the generator's state before its next draw, as a
    hashable key and for messages. CUDA's Philox state is (seed, offset);
    the CPU's Mersenne state is 5 KB, kept as its hash."""
    raw = gen.get_state()
    if gen.device.type == "cuda":
        seed, offset = raw.view(torch.int64).tolist()
        return ("cuda", seed, offset), f"(seed {seed}, offset {offset})"
    digest = hashlib.sha1(raw.numpy().tobytes()).hexdigest()[:16]
    return (gen.device.type, digest), f"mt19937 state {digest}"


def _storage_key(t: torch.Tensor):
    if t.device.type == "meta" or t.numel() == 0:
        return None
    return (str(t.device), t.untyped_storage().data_ptr())


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class DrawRecorder(TorchDispatchMode):
    """While active, records every draw (:class:`Draw`) and, outside the
    taps' steps, which draws each storage derives from (``origin``). The
    storages it follows are kept alive until it is cleared, so no address
    is reused while the record runs."""

    def __init__(self):
        super().__init__()
        self.draws: list = []
        self.origin: dict = {}
        self._alive: list = []
        self.in_step = 0

    def origins(self, t: torch.Tensor) -> frozenset:
        key = _storage_key(t)
        return frozenset(self.origin.get(key, ())) if key else frozenset()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if name not in DRAW_OPS:
            out = func(*args, **kwargs)
            if not self.in_step:
                self._follow(args, kwargs, out)
            return out
        gen = _generator_of(func, args, kwargs)
        pre = _tensors(args)
        default = gen is None
        if default:
            dev = kwargs.get("device") or (pre[0].device if pre
                                           else torch.device("cpu"))
            gen = _default_generator(torch.device(dev))
        state, shown = generator_state(gen)
        path, line = _site()
        out = func(*args, **kwargs)
        res = pre[0] if name.endswith("_") and pre else \
            (_tensors(out) or [None])[0]
        if res is None or res.numel() == 0:
            return out              # nothing drawn, the state did not move
        idx = len(self.draws)
        self.draws.append(Draw(idx, name, state, shown, default,
                               tuple(res.shape), path, line))
        key = _storage_key(res)
        if key is not None:
            self.origin[key] = {idx}
            self._alive.append(res)
        return out

    def _follow(self, args, kwargs, out) -> None:
        src = set()
        for t in _tensors((args, kwargs)):
            key = _storage_key(t)
            if key in self.origin:
                src |= self.origin[key]
        if not src:
            return
        for t in _tensors(out):
            key = _storage_key(t)
            if key is not None:
                self.origin.setdefault(key, set()).update(src)
                self._alive.append(t)


# ---------------------------------------------------------------------------
# Taps on the runs' steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tap:
    """A run's step, found as ``owner.attr`` (a module or class
    attribute the run looks up when it calls it): ``noise(args, kwargs)``
    picks the noise tuple a call consumes; with ``factory`` the attribute
    builds the step and the tap wraps what it returns."""
    owner: object
    attr: str
    noise: Callable
    factory: bool = False


@dataclasses.dataclass
class Recording:
    """What :func:`record` saw: every :class:`Draw`, and per step call
    ``{field: (origin draw indices, shape, first pair of equal rows, lane
    rows or 0)}`` for each tensor field of the noise it consumed."""
    draws: list
    steps: list


class _Steps:
    def __init__(self, rec: DrawRecorder):
        self.rec, self.steps = rec, []

    def note(self, noise) -> None:
        fields = {}
        for name in getattr(noise, "_fields", ()):
            t = getattr(noise, name)
            if not isinstance(t, torch.Tensor):
                continue
            equal, rows = None, 0
            if name in ("gumbel", "s0") and t.dim() >= 1:
                # a lane group's noise leads with its rows: the agents of
                # each row are compared among themselves
                lead = t.dim() - (3 if name == "s0" else 4)
                rows = t.shape[0] if lead > 0 else 0
                blocks = t.reshape(-1, *t.shape[lead:]) if lead > 0 \
                    else t[None]
                equal = next(((i, j) for b in blocks
                              for i in range(b.shape[0])
                              for j in range(i + 1, b.shape[0])
                              if torch.equal(b[i], b[j])), None)
            fields[name] = (self.rec.origins(t), tuple(t.shape), equal,
                            rows)
        self.steps.append(fields)

    def wrap(self, tap: Tap, fn):
        if tap.factory:
            plain = dataclasses.replace(tap, factory=False)
            return lambda *a, **k: self.wrap(plain, fn(*a, **k))

        def step(*a, **k):
            self.note(tap.noise(a, k))
            self.rec.in_step += 1
            try:
                return fn(*a, **k)
            finally:
                self.rec.in_step -= 1
        return step


def record(fn: Callable, taps: Iterable[Tap] = ()) -> Recording:
    """Run ``fn()`` under a :class:`DrawRecorder` with ``taps`` wrapped in
    place for the call."""
    rec = DrawRecorder()
    steps = _Steps(rec)
    saved = []
    try:
        for tap in taps:
            orig = getattr(tap.owner, tap.attr)
            saved.append((tap.owner, tap.attr, orig))
            setattr(tap.owner, tap.attr, steps.wrap(tap, orig))
        with rec:
            fn()
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)
    return Recording(rec.draws, steps.steps)


# ---------------------------------------------------------------------------
# Contract evaluation
# ---------------------------------------------------------------------------


def _rel(path: str) -> str:
    from repro_torch.analysis.lint import repo_root
    root = str(repo_root()) + os.sep
    return path[len(root):] if path.startswith(root) else path


def check(rec: Recording, program: str) -> list:
    """The findings of one :class:`Recording`."""
    findings = []

    def bad(rule, draw: Optional[Draw], msg):
        path, line = (_rel(draw.path), draw.line) if draw else (program, 0)
        findings.append(Finding("keycheck", rule, path, line,
                                f"[{program}] {msg}"))

    first = {}
    for d in rec.draws:
        if d.default:
            bad("global-generator", d,
                f"{d.op} draws from the default generator — draw from the "
                f"run's torch.Generator (engine.seed_generator)")
        if d.state in first:
            p = first[d.state]
            bad("key-reuse", d,
                f"{d.op} starts from {d.shown}, the state {p.op} at "
                f"{_rel(p.path)}:{p.line} drew from — the two streams are "
                f"the same numbers")
        else:
            first[d.state] = d
    T = len(rec.steps)
    names = sorted({n for s in rec.steps for n in s})
    for name in names:
        seen = [s[name] for s in rec.steps if name in s]
        used = set().union(*(o for o, _, _, _ in seen))
        if len(used) < len(seen):
            anchor = rec.draws[min(used)] if used else None
            bad("step-invariant-draw", anchor,
                f"{len(seen)} steps consumed {len(used)} draw(s) of "
                f"{name!r} — each step draws its own noise (the same value "
                f"every step is noise drawn once outside the loop)")
    for i, s in enumerate(rec.steps):
        for name in ("gumbel", "s0"):
            if name not in s:
                continue
            origins, shape, equal, rows = s[name]
            wide = [rec.draws[o] for o in origins]
            agents = shape[1:2] if rows else shape[:1]
            if len(wide) != max(rows, 1) \
                    or any(w.shape[:1] != agents for w in wide):
                bad("per-agent-fanout", wide[0] if wide else None,
                    f"step {i}: {name} {shape} comes from draws "
                    f"{[w.shape for w in wide]}, not one {agents[0]}-wide "
                    f"draw of the K agents' rows"
                    + (f" for each of {rows} lane rows" if rows else ""))
            if equal is not None:
                bad("per-agent-fanout", wide[0] if wide else None,
                    f"step {i}: agents {equal[0]} and {equal[1]} have "
                    f"bit-equal {name} rows — the agents' streams are one")
    return findings


# ---------------------------------------------------------------------------
# The inventory: the port's real entry points, run small
# ---------------------------------------------------------------------------

_K = 4          # agents in the RL programs
_FED_K = 3      # agents in the federated programs
_T = 3          # steps of each RL run


def _rl_cfg(algo: str):
    if algo == "decbyzpg":
        from repro_torch.core.decbyzpg import DecByzPGConfig
        return DecByzPGConfig(K=_K, n_byz=1,
                              attack="large_noise(sigma=1.0)",
                              aggregator="rfa", agreement="gda", kappa=2,
                              N=3, B=2, hidden=(8,))
    from repro_torch.core.byzpg import ByzPGConfig
    return ByzPGConfig(K=_K, n_byz=1, attack="sign_flip", aggregator="rfa",
                       N=3, B=2, hidden=(8,))


def _rl_tap(algo: str) -> Tap:
    import importlib
    mod = importlib.import_module(f"repro_torch.core.{algo}")
    return Tap(mod, f"build_{algo}_step", lambda a, k: a[1], factory=True)


def _run_algo(algo: str, device):
    from repro_torch.rl.envs import make_env
    from repro_torch.core.registry import resolve
    env = make_env("cartpole(horizon=16)")
    resolve("algo", algo).run(env, _rl_cfg(algo), _T, device=device)


def _run_grid(device):
    from repro_torch.core.engine import ScenarioGrid, run_grid
    from repro_torch.rl.envs import make_env
    cfg = _rl_cfg("decbyzpg")
    base = {k: getattr(cfg, k) for k in ("K", "n_byz", "attack",
                                         "aggregator", "agreement", "kappa",
                                         "N", "B", "hidden")}
    run_grid(make_env("cartpole(horizon=16)"),
             ScenarioGrid(seeds=(0, 1), axes={"eta": (1e-2,)}), 2,
             algo="decbyzpg", device=device, **base)


def _fed_args(device) -> list:
    return ["--arch", "llama3.2-1b", "--reduced", "--agents", str(_FED_K),
            "--byz", "1", "--attack", "large_noise(sigma=1.0)",
            "--aggregator", "rfa", "--kappa", "2", "--steps", "2",
            "--window", "2", "--seq", "16", "--batch", "2",
            "--device", str(device)]


def _fed_noise(a, k):
    return k.get("noise", a[5] if len(a) > 5 else None)


def _run_fed_flat(device):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.engine import seed_generator
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import fed_trainer as ft
    cfg = reduced(get_config("llama3.2-1b"))
    fed = ft.FedConfig(aggregator="rfa", kappa=2, n_byz=1,
                       attack="large_noise(sigma=1.0)")
    gen = seed_generator(fed.seed, device)
    state, unravel = ft.init_flat_fed_state(cfg, fed, _FED_K, gen,
                                            device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    per_agent_batch=2, n_agents=_FED_K),
                         device=device)
    mask = torch.arange(_FED_K, device=device) < fed.n_byz
    for t, large in enumerate((True, False)):
        noise = ft.fed_noise(gen, fed, state, fed.n_byz)
        state, _ = ft.fed_train_step_flat(cfg, fed, state, unravel,
                                          pipe.batch(t), mask, noise,
                                          large=large)


def programs() -> list:
    """(name, run(device), taps) for every entry point the pass runs."""
    from repro_torch.distributed import fed_trainer
    from repro_torch.launch import train
    return [
        ("decbyzpg", lambda d: _run_algo("decbyzpg", d),
         (_rl_tap("decbyzpg"),)),
        ("byzpg", lambda d: _run_algo("byzpg", d), (_rl_tap("byzpg"),)),
        ("run_grid", _run_grid, (_rl_tap("decbyzpg"),)),
        ("fed_train_window", lambda d: train.main(_fed_args(d)),
         (Tap(fed_trainer, "fed_train_step", _fed_noise),)),
        ("fed_train_step",
         lambda d: train.main(_fed_args(d) + ["--no-fused"]),
         (Tap(train, "fed_train_step", _fed_noise),)),
        ("fed_train_step_flat", _run_fed_flat,
         (Tap(fed_trainer, "fed_train_step_flat", lambda a, k: a[6]),)),
    ]


def run(device="cpu", selected: Optional[Iterable[str]] = None) -> list:
    """Run every inventory entry point on ``device`` and return all findings
    (deduped on (rule, path, line), so one bad helper reported through
    several entry points surfaces once)."""
    findings, seen = [], set()
    dev = torch.device(device)
    for name, fn, taps in programs():
        if selected is not None and name not in selected:
            continue
        with contextlib.redirect_stdout(io.StringIO()):   # CLI progress
            rec = record(lambda: fn(dev), taps)
        for f in check(rec, name):
            key = (f.rule, f.path, f.line)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings
