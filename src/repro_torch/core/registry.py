"""Component-spec registry: the port's own copy of the JAX package's
``core/registry.py``.

Components (aggregators, attacks, agreement methods, estimators,
optimizers, environments, topologies, policies, algorithms) register
under a namespace and are addressed by a :class:`Spec`, a frozen, hashable
``(name, sorted kwargs)`` value that parses from strings::

    Spec.of("bucketing(s=2, inner=rfa(n_iter=64))").canonical()
        -> "bucketing(inner=rfa(n_iter=64), s=2)"

Names and kwargs are the reference's, so one spec string means the same
component in both packages. :func:`resolve` passes a factory the spec's
kwargs plus the context kwargs (``K=...``, ``n_byz=...``) its signature
names; spec kwargs win. Namespaces load lazily from ``_PROVIDERS``, which
points at this package's modules.
"""
from __future__ import annotations

import ast
import importlib
import inspect
from typing import Any, Callable, Dict, Optional, Tuple


class SpecError(ValueError):
    """A component spec string failed to parse."""


class Spec:
    """Frozen, hashable component spec: a name plus keyword arguments,
    stored key-sorted so equal specs hash equal."""

    __slots__ = ("name", "kwargs")

    def __init__(self, name: str, **kwargs):
        if not name.isidentifier():
            raise SpecError(f"component name must be an identifier, "
                            f"got {name!r}")
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "kwargs", tuple(
            sorted((k, _norm_value(v)) for k, v in kwargs.items())))

    def __setattr__(self, *_):
        raise AttributeError("Spec is immutable")

    @classmethod
    def of(cls, value) -> "Spec":
        """Coerce a Spec | string into a Spec (idempotent)."""
        if isinstance(value, Spec):
            return value
        if isinstance(value, str):
            return cls.parse(value)
        raise SpecError(f"cannot make a Spec from {type(value).__name__}: "
                        f"{value!r}")

    @classmethod
    def parse(cls, s: str) -> "Spec":
        """Parse ``"name"`` or ``"name(k=v, ...)"``; nested calls become
        nested Specs."""
        try:
            node = ast.parse(s.strip(), mode="eval").body
        except SyntaxError as e:
            raise SpecError(f"invalid spec string {s!r}: {e.msg}") from None
        return _spec_from_node(node, s)

    def with_kwargs(self, **kwargs) -> "Spec":
        """New Spec with ``kwargs`` merged in (existing keys kept)."""
        merged = dict(kwargs)
        merged.update(dict(self.kwargs))
        return Spec(self.name, **merged)

    def canonical(self) -> str:
        if not self.kwargs:
            return self.name
        inner = ", ".join(f"{k}={_fmt_value(v)}" for k, v in self.kwargs)
        return f"{self.name}({inner})"

    def __str__(self) -> str:
        return self.canonical()

    def __repr__(self) -> str:
        return f"Spec({self.canonical()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Spec):
            return (self.name, self.kwargs) == (other.name, other.kwargs)
        return NotImplemented

    def __hash__(self) -> int:
        return hash((Spec, self.name, self.kwargs))


def _norm_value(v):
    if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
        raise SpecError(f"non-finite spec kwarg value: {v!r}")
    if isinstance(v, (Spec, bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_norm_value(x) for x in v)
    raise SpecError(f"unsupported spec kwarg value: {v!r}")


def _fmt_value(v) -> str:
    if isinstance(v, Spec):
        return v.canonical()
    if isinstance(v, tuple):
        inner = ", ".join(_fmt_value(x) for x in v)
        return f"({inner},)" if len(v) == 1 else f"({inner})"
    return repr(v)


def _spec_from_node(node, src: str) -> Spec:
    if isinstance(node, ast.Name):
        return Spec(node.id)
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise SpecError(f"invalid spec string {src!r}: component name "
                            f"must be a plain identifier")
        if node.args:
            raise SpecError(f"invalid spec string {src!r}: only keyword "
                            f"arguments are allowed")
        kwargs = {}
        for kw in node.keywords:
            if kw.arg is None:
                raise SpecError(f"invalid spec string {src!r}: ** is not "
                                f"allowed")
            kwargs[kw.arg] = _value_from_node(kw.value, src)
        return Spec(node.func.id, **kwargs)
    raise SpecError(f"invalid spec string {src!r}")


def _value_from_node(node, src: str):
    if isinstance(node, (ast.Name, ast.Call)):
        return _spec_from_node(node, src)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (bool, int, float, str)) \
                or node.value is None:
            return node.value
        raise SpecError(f"invalid spec string {src!r}: unsupported constant "
                        f"{node.value!r}")
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_value_from_node(e, src) for e in node.elts)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant) \
            and isinstance(node.operand.value, (int, float)):
        return -node.operand.value
    raise SpecError(f"invalid spec string {src!r}: unsupported value "
                    f"expression")


# namespace -> modules whose import registers that namespace's built-ins
_PROVIDERS: Dict[str, Tuple[str, ...]] = {  # analysis: not-a-spec
    "aggregator": ("repro_torch.core.aggregators",),
    "attack": ("repro_torch.core.attacks",),
    "agreement": ("repro_torch.core.agreement",),
    "estimator": ("repro_torch.rl.gradient",),
    "optimizer": ("repro_torch.optim.optimizers",),
    "env": ("repro_torch.rl.envs",),
    "topology": ("repro_torch.topology.graphs",),
    "policy": ("repro_torch.rl.policy",
               "repro_torch.rl.transformer_policy"),
    "algo": ("repro_torch.core.decbyzpg", "repro_torch.core.byzpg"),
}


class Registry:
    """Namespaced registry mapping ``(namespace, name)`` to a factory plus
    metadata."""

    def __init__(self):
        self._factories: Dict[Tuple[str, str], Callable] = {}
        self._meta: Dict[Tuple[str, str], dict] = {}
        self._loaded: set = set()

    def register(self, namespace: str, name: Optional[str] = None, **meta):
        """Decorator: ``@register("aggregator", "rfa", **meta)``."""

        def deco(factory):
            key = (namespace, name or factory.__name__.lstrip("_"))
            self._factories[key] = factory
            self._meta[key] = meta
            return factory

        return deco

    def _ensure_loaded(self, namespace: str) -> None:
        if namespace in self._loaded:
            return
        for mod in _PROVIDERS.get(namespace, ()):
            importlib.import_module(mod)
        self._loaded.add(namespace)

    def names(self, namespace: str) -> Tuple[str, ...]:
        self._ensure_loaded(namespace)
        return tuple(sorted(n for ns, n in self._factories
                            if ns == namespace))

    def meta(self, namespace: str, spec) -> dict:
        name = Spec.of(spec).name
        self._factory(namespace, name)          # raises on unknown
        return self._meta[(namespace, name)]

    def _factory(self, namespace: str, name: str) -> Callable:
        self._ensure_loaded(namespace)
        try:
            return self._factories[(namespace, name)]
        except KeyError:
            known = ", ".join(self.names(namespace)) or "<none>"
            raise KeyError(f"unknown {namespace} component {name!r}; "
                           f"registered: {known}") from None

    def resolve(self, namespace: str, spec, **context) -> Any:
        """Build the component named by ``spec`` (Spec or string), passing
        the context kwargs the factory's signature accepts."""
        spec = Spec.of(spec)
        factory = self._factory(namespace, spec.name)
        params = inspect.signature(factory).parameters
        var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
        accepted = {n for n, p in params.items()
                    if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                  inspect.Parameter.KEYWORD_ONLY)}
        kwargs = dict(spec.kwargs)
        if not var_kw:
            bad = set(kwargs) - accepted
            if bad:
                raise TypeError(
                    f"{namespace}/{spec.name} got unexpected kwarg(s) "
                    f"{sorted(bad)}; accepted: {sorted(accepted)}")
        for k, v in context.items():
            if k in accepted or var_kw:
                kwargs.setdefault(k, v)
        return factory(**kwargs)


REGISTRY = Registry()
register = REGISTRY.register
resolve = REGISTRY.resolve


def normalize_spec_fields(cfg, fields) -> None:
    """``__post_init__`` body for frozen configs: coerce each named
    str|Spec field to a Spec."""
    for f in fields:
        object.__setattr__(cfg, f, Spec.of(getattr(cfg, f)))
