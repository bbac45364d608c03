"""The port's AST lint: the counterpart of the JAX package's
``analysis/lint.py``, with the port's conventions in place of JAX's.

The framework is the reference's: every rule is a :class:`Rule` scoped
to a set of paths; the runner parses each python file (and each fenced
``python`` block of README.md that imports ``repro_torch``) once into a
:class:`FileCtx` and hands it to the rules that claim it. A ``#
analysis: <tag>`` comment on the flagged line or the line above is the
escape hatch. It scans ``src/repro_torch/``, ``examples_torch/``,
``chip_smoke.py`` and ``tools/``. Rules:

* ``spec-strings`` — every literal component-spec string at the
  reference's sites (spec-valued keyword arguments, dict keys and
  annotated fields, ``resolve``/``make_env``/``Spec.parse`` calls) must
  parse and name a component of :data:`repro_torch.core.registry.REGISTRY`
  whose factory takes its kwargs. Hatch: ``not-a-spec``.
* ``global-generator`` (for the reference's ``literal-prng-key``) — in
  library code (``src/repro_torch/``), a ``torch`` draw (``rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, ...) or an in-place draw (``uniform_``, ``normal_``,
  ...) without ``generator=``, and any ``torch.manual_seed``: every draw
  comes from an explicit ``torch.Generator``. Hatch: ``global-generator``.
* ``kernel-location`` (for ``pallas-location``) — ``ctypes.CDLL``,
  ``_build.library()``, ``triton.jit`` and ``torch.utils.cpp_extension``
  only under ``src/repro_torch/kernels/``: kernels live behind the
  dispatch layer, and a script that wants the build up front calls
  ``_build.build()``.
* ``host-sync`` (for ``numpy-traced``) — ``.item()``, ``.tolist()``,
  ``.cpu()`` and ``.numpy()`` in the hot modules (``core/``, ``rl/``,
  ``distributed/``, ``models/``, ``serving/engine.py``) wait for the
  device; each sanctioned read carries ``# analysis: host-side`` and a
  reason.
* ``reference-import`` — no ``jax`` and nothing of ``repro`` is imported
  by the port, its examples, ``chip_smoke.py`` or ``tools/`` (the static
  half of the tests' import check).
* ``deep-import`` — an example (``examples_torch/``) imports a name the
  public surface exports (``repro_torch._EXPORTS``) from its defining
  submodule (``from repro_torch.core.engine import Experiment``) rather
  than from ``repro_torch``, or imports from a module outside the
  surface's namespaces (``repro_torch._MODULES``). Hatch:
  ``deep-import``.
* ``tracked-smoke-file`` — no ``benchmarks/*_smoke.json`` committed, as
  the reference has it.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import re
import subprocess
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.findings import Finding

# keyword/field name -> registry namespaces it may resolve in
SPEC_KWARGS = {  # analysis: not-a-spec
    "attack": ("attack", "fed_attack"),
    "aggregator": ("aggregator", "fed_aggregator"),
    "agreement": ("agreement",),
    "estimator": ("estimator",),
    "optimizer": ("optimizer",),
    "topology": ("topology",),
    "policy": ("policy",),
    "env": ("env",),
    "algo": ("algo",),
}

# call name -> namespace of its literal first spec argument
SPEC_CALLS = {
    "make_env": "env",
    "resolve_topology": "topology",
}

#: ``torch.<name>(...)`` draws that take ``generator=``
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like"})
#: in-place draws on a tensor (``x.uniform_(...)``)
INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_"})
#: seeding the default generators
GLOBAL_SEEDS = frozenset({"manual_seed", "manual_seed_all", "seed"})
#: reads that wait for the device
HOST_SYNCS = frozenset({"item", "tolist", "cpu", "numpy"})
#: the examples, which import only the public surface
EXAMPLE_PREFIX = "examples_torch/"


@dataclasses.dataclass
class LintConfig:
    root: Path
    lib_prefixes: tuple = ("src/repro_torch/",)
    scan_prefixes: tuple = ("src/repro_torch/", EXAMPLE_PREFIX, "tools/")
    scan_files: tuple = ("chip_smoke.py",)
    doc_files: tuple = ("README.md",)
    kernel_prefix: str = "src/repro_torch/kernels/"
    hot_prefixes: tuple = ("src/repro_torch/core/", "src/repro_torch/rl/",
                           "src/repro_torch/distributed/",
                           "src/repro_torch/models/",
                           "src/repro_torch/serving/engine.py")
    # the analyzer's own rule tables are spec-shaped data, not spec sites
    spec_exclude: tuple = ("src/repro_torch/analysis/",)
    smoke_patterns: tuple = ("benchmarks/*_smoke.json", "*_smoke.json")


@dataclasses.dataclass
class FileCtx:
    rel: str                 # repo-relative posix path ("README.md#3" for
    tree: ast.AST            # the 3rd code fence)
    lines: list              # raw source lines (1-indexed via lineno-1)
    line_offset: int = 0     # fence offset into the containing document
    is_doc_fence: bool = False

    def line(self, node) -> int:
        return node.lineno + self.line_offset

    def has_hatch(self, node, tag: str) -> bool:
        marker = f"# analysis: {tag}"
        for ln in (node.lineno - 1, node.lineno - 2):
            if 0 <= ln < len(self.lines) and marker in self.lines[ln]:
                return True
        return False


class Rule:
    name = "rule"

    def wants(self, ctx: FileCtx, cfg: LintConfig) -> bool:
        raise NotImplementedError

    def visit(self, ctx: FileCtx, cfg: LintConfig) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileCtx, node, message: str) -> Finding:
        rel = ctx.rel.split("#")[0]
        return Finding("lint", self.name, rel, ctx.line(node), message)


def _starts_with(rel: str, prefixes) -> bool:
    return any(rel.startswith(p) for p in prefixes)


def _attr_chain(node) -> list:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _module_aliases(tree, module: str) -> set:
    """The names under which ``tree`` imports ``module`` itself."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or module)
    return out


def _in_port(ctx: FileCtx, cfg: LintConfig) -> bool:
    return not ctx.is_doc_fence and (
        _starts_with(ctx.rel, cfg.scan_prefixes) or ctx.rel in cfg.scan_files)


# ---------------------------------------------------------------------------
# spec-strings
# ---------------------------------------------------------------------------


def _validate_spec(text: str, namespaces) -> Optional[str]:
    """Parse + resolve a spec string in the port's registry; returns an
    error message or None."""
    from repro_torch.core.registry import REGISTRY, Spec, SpecError
    try:
        spec = Spec.parse(text)
    except SpecError as e:
        return str(e)
    if namespaces is None:          # parse-only site (Spec.parse/Spec.of)
        return None
    errors = []
    for ns in namespaces:
        try:
            factory = REGISTRY._factory(ns, spec.name)
        except KeyError:
            errors.append(f"not registered in {ns!r}")
            continue
        params = inspect.signature(factory).parameters
        var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
        bad = [k for k, _ in spec.kwargs if not var_kw and k not in params]
        if bad:
            errors.append(f"{ns}/{spec.name} does not accept kwarg(s) "
                          f"{bad}")
            continue
        for k, v in spec.kwargs:
            if isinstance(v, Spec):
                err = _validate_spec(v.canonical(), (ns,))
                if err:
                    errors.append(err)
                    break
        else:
            return None
    return "; ".join(errors) or None


def _literal_specs(value) -> list:
    """(text, node) pairs for a literal spec value: a string constant or a
    tuple/list of them (sweep axes)."""
    out = []
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        out.append((value.value, value))
    elif isinstance(value, (ast.Tuple, ast.List)):
        for el in value.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append((el.value, el))
    return out


class SpecStrings(Rule):
    name = "spec-strings"

    def wants(self, ctx, cfg):
        if _starts_with(ctx.rel, cfg.spec_exclude):
            return False
        return ctx.is_doc_fence or _in_port(ctx, cfg)

    def _sites(self, ctx):
        """(text, node, namespaces) for every literal spec site, as the
        reference finds them."""
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Call, ast.Dict, ast.AnnAssign)) \
                    and ctx.has_hatch(node, "not-a-spec"):
                continue
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                tail = chain[-1] if chain else None
                for kw in node.keywords:
                    if kw.arg in SPEC_KWARGS:
                        for text, n in _literal_specs(kw.value):
                            yield text, n, SPEC_KWARGS[kw.arg]
                if tail == "resolve" and len(node.args) >= 2 \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    for text, n in _literal_specs(node.args[1]):
                        yield text, n, (node.args[0].value,)
                elif tail in SPEC_CALLS and node.args:
                    for text, n in _literal_specs(node.args[0]):
                        yield text, n, (SPEC_CALLS[tail],)
                elif tail in ("parse", "of") and len(chain) >= 2 \
                        and chain[-2] == "Spec" and node.args:
                    for text, n in _literal_specs(node.args[0]):
                        yield text, n, None
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) \
                            and k.value in SPEC_KWARGS:
                        for text, n in _literal_specs(v):
                            yield text, n, SPEC_KWARGS[k.value]
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id in SPEC_KWARGS \
                    and node.value is not None:
                for text, n in _literal_specs(node.value):
                    yield text, n, SPEC_KWARGS[node.target.id]

    def visit(self, ctx, cfg):
        seen = set()
        for text, node, namespaces in self._sites(ctx):
            key = (text, ctx.line(node))
            if key in seen:
                continue
            seen.add(key)
            err = _validate_spec(text, namespaces)
            if err:
                yield self.finding(
                    ctx, node, f"spec string {text!r} does not resolve: "
                               f"{err}")


# ---------------------------------------------------------------------------
# global-generator
# ---------------------------------------------------------------------------


class GlobalGenerator(Rule):
    name = "global-generator"

    def wants(self, ctx, cfg):
        return not ctx.is_doc_fence and _starts_with(ctx.rel,
                                                     cfg.lib_prefixes)

    def visit(self, ctx, cfg):
        torch_names = _module_aliases(ctx.tree, "torch")
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if len(chain) < 2 or ctx.has_hatch(node, self.name):
                continue
            rooted = chain[0] in torch_names
            if rooted and chain[-1] in GLOBAL_SEEDS:
                yield self.finding(
                    ctx, node,
                    f"{'.'.join(chain)}() seeds a default generator — "
                    f"seed an explicit torch.Generator "
                    f"(engine.seed_generator) and pass it as generator=")
                continue
            draw = (rooted and len(chain) == 2 and chain[1] in TORCH_DRAWS) \
                or chain[-1] in INPLACE_DRAWS
            if draw and not any(kw.arg == "generator"
                                for kw in node.keywords):
                yield self.finding(
                    ctx, node,
                    f"{'.'.join(chain)}() draws from the default generator "
                    f"— pass generator= (a caller-provided "
                    f"torch.Generator)")


# ---------------------------------------------------------------------------
# kernel-location
# ---------------------------------------------------------------------------


def _kernel_access(node) -> Optional[str]:
    """What a node does that belongs behind ``kernels/``, or None."""
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module or ""]
        for mod in mods:
            if mod.startswith("torch.utils.cpp_extension"):
                return "torch.utils.cpp_extension"
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("_build") \
                and any(a.name == "library" for a in node.names):
            return "_build.library"
        return None
    chain = _attr_chain(node.func) if isinstance(node, ast.Call) \
        else _attr_chain(node) if isinstance(node, ast.Attribute) else []
    if chain[-2:] == ["ctypes", "CDLL"]:
        return "ctypes.CDLL"
    if chain[-2:] == ["triton", "jit"]:
        return "triton.jit"
    if "cpp_extension" in chain:
        return "torch.utils.cpp_extension"
    if isinstance(node, ast.Call) and chain[-2:] == ["_build", "library"]:
        return "_build.library()"
    return None


class KernelLocation(Rule):
    name = "kernel-location"

    def wants(self, ctx, cfg):
        return _in_port(ctx, cfg) and not ctx.rel.startswith(
            cfg.kernel_prefix)

    def visit(self, ctx, cfg):
        seen = set()
        for node in ast.walk(ctx.tree):
            what = _kernel_access(node)
            if what is None or node.lineno in seen:
                continue
            seen.add(node.lineno)
            yield self.finding(
                ctx, node,
                f"{what} outside src/repro_torch/kernels/ — kernels are "
                f"built, loaded and launched behind the dispatch layer "
                f"(kernels/dispatch.py); a script that wants the build up "
                f"front calls _build.build()")


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


class HostSync(Rule):
    name = "host-sync"

    def wants(self, ctx, cfg):
        return not ctx.is_doc_fence and _starts_with(ctx.rel,
                                                     cfg.hot_prefixes)

    def visit(self, ctx, cfg):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_SYNCS \
                    and not ctx.has_hatch(node, "host-side"):
                yield self.finding(
                    ctx, node,
                    f".{node.func.attr}() in a hot module waits for the "
                    f"device — keep the value on the device, or mark a "
                    f"sanctioned read with '# analysis: host-side' and its "
                    f"reason")


# ---------------------------------------------------------------------------
# reference-import
# ---------------------------------------------------------------------------


def _reference_module(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


class ReferenceImport(Rule):
    name = "reference-import"

    def wants(self, ctx, cfg):
        return _in_port(ctx, cfg)

    def visit(self, ctx, cfg):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call) \
                    and _attr_chain(node.func)[-1:] in (["import_module"],
                                                        ["__import__"]) \
                    and node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                mods = [node.args[0].value]
            else:
                continue
            bad = [m for m in mods if _reference_module(m)]
            if bad:
                yield self.finding(
                    ctx, node,
                    f"imports {bad[0]!r} — the port runs where only torch "
                    f"is installed and keeps its own copy of what it needs "
                    f"from the JAX package")


# ---------------------------------------------------------------------------
# deep-import
# ---------------------------------------------------------------------------


class DeepImport(Rule):
    name = "deep-import"

    def wants(self, ctx, cfg):
        return not ctx.is_doc_fence and ctx.rel.startswith(EXAMPLE_PREFIX)

    @staticmethod
    def _public_names() -> dict:
        """name -> defining submodule, from the public surface itself (so
        this rule can never drift from ``repro_torch/__init__``)."""
        import repro_torch
        return dict(repro_torch._EXPORTS)

    def visit(self, ctx, cfg):
        import repro_torch
        public = self._public_names()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            mods = [m for m in mods if m.startswith("repro_torch.")]
            if not mods or ctx.has_hatch(node, "deep-import"):
                continue
            outside = [m for m in mods
                       if m.split(".")[1] not in repro_torch._MODULES]
            if outside:
                yield self.finding(
                    ctx, node,
                    f"imports {outside[0]!r}, outside the surface's "
                    f"namespaces (repro_torch._MODULES); mark a deliberate "
                    f"internal demo with '# analysis: deep-import'")
                continue
            if isinstance(node, ast.Import):
                continue
            mod = mods[0]
            covered = [a.name for a in node.names if a.name in public]
            if covered:
                yield self.finding(
                    ctx, node,
                    f"deep import from {mod!r} of public name(s) "
                    f"{covered} — examples use the public surface (from "
                    f"repro_torch import {', '.join(covered)}); mark a "
                    f"deliberate internal demo with "
                    f"'# analysis: deep-import'")


# ---------------------------------------------------------------------------
# tracked-smoke-file (repo-level, no AST)
# ---------------------------------------------------------------------------


def check_tracked_smoke(cfg: LintConfig) -> list:
    try:
        out = subprocess.run(
            ["git", "ls-files", "--", *cfg.smoke_patterns],
            cwd=cfg.root, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [
        Finding("lint", "tracked-smoke-file", p, 0,
                "smoke benchmark output is tracked by git — smoke runs "
                "are per-run CI artifacts, only full BENCH_*.json "
                "baselines are committed")
        for p in out.stdout.split() if p
    ]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

RULES = (SpecStrings(), GlobalGenerator(), KernelLocation(), HostSync(),
         ReferenceImport(), DeepImport())

_FENCE_RE = re.compile(r"^```(\w*)\s*$")


def _doc_fences(rel: str, text: str):
    """Yield (rel#i, fence_source, line_offset) for ```python fences."""
    lines = text.splitlines()
    i, n, count = 0, len(lines), 0
    while i < n:
        m = _FENCE_RE.match(lines[i])
        if m and m.group(1) == "python":
            start = i + 1
            j = start
            while j < n and not lines[j].startswith("```"):
                j += 1
            count += 1
            yield f"{rel}#{count}", "\n".join(lines[start:j]), start
            i = j + 1
        else:
            i += 1


def _imports_port(tree) -> bool:
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module or ""] if isinstance(node, ast.ImportFrom) \
            else []
        if any(n.split(".")[0] == "repro_torch" for n in names):
            return True
    return False


def _parse(path: Path, rel: str):
    text = path.read_text()
    try:
        return FileCtx(rel, ast.parse(text), text.splitlines())
    except SyntaxError:
        return None             # not this tool's job


def _contexts(cfg: LintConfig):
    seen = set()
    for prefix in sorted(set(cfg.scan_prefixes) | set(cfg.lib_prefixes)):
        base = cfg.root / prefix
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*.py")):
            rel = path.relative_to(cfg.root).as_posix()
            if rel not in seen:
                seen.add(rel)
                ctx = _parse(path, rel)
                if ctx is not None:
                    yield ctx
    for rel in cfg.scan_files:
        path = cfg.root / rel
        if path.is_file() and rel not in seen:
            ctx = _parse(path, rel)
            if ctx is not None:
                yield ctx
    for doc in cfg.doc_files:
        path = cfg.root / doc
        if not path.is_file():
            continue
        for rel, src, offset in _doc_fences(doc, path.read_text()):
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue        # illustrative snippet, not runnable code
            if _imports_port(tree):
                yield FileCtx(rel, tree, src.splitlines(),
                              line_offset=offset, is_doc_fence=True)


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def run(root: Optional[Path] = None,
        config: Optional[LintConfig] = None) -> list:
    cfg = config or LintConfig(root=Path(root) if root else repo_root())
    findings = []
    for ctx in _contexts(cfg):
        for rule in RULES:
            if rule.wants(ctx, cfg):
                findings.extend(rule.visit(ctx, cfg))
    findings.extend(check_tracked_smoke(cfg))
    return findings
