"""Span tracing: profiler phase names plus a host Chrome-trace tracer (the
port of the JAX package's ``repro/obs/trace.py``).

Two layers:

* :func:`named_phase` wraps a region of the step in a
  ``torch.profiler.record_function`` range (the reference's
  ``jax.named_scope``) when its ``enabled`` flag is on.
* :class:`Tracer`, a host-side wall-clock tracer emitting Chrome-trace
  JSON (``{"traceEvents": [...]}``), loadable in Perfetto or
  ``chrome://tracing``. ``engine.run_grid`` wraps each lane group's run
  (each scenario's runs with ``lanes=False``) in :func:`host_span`. Host spans also enter ``record_function`` (the
  reference's ``jax.profiler.TraceAnnotation``), so they line up with the
  device's events when a ``torch.profiler`` session is active.

Host spans are no-ops (a shared ``nullcontext``) while telemetry is
disabled: the hot loops must not pay for instrumentation that is off.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

from torch.profiler import record_function

from repro_torch.obs import metrics as _metrics

_NULL = contextlib.nullcontext()


def named_phase(name: str, enabled: bool = True):
    """``record_function(name)`` when ``enabled``, else a no-op context."""
    return record_function(name) if enabled else _NULL


class Tracer:
    """Accumulates Chrome trace events (host wall-clock, us since the
    tracer's epoch)."""

    def __init__(self):
        self.events: list = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Complete ("X") event around the scope; ``args`` must be
        JSON-serializable."""
        t0 = self._now_us()
        try:
            with record_function(name):
                yield
        finally:
            self.events.append({
                "name": name, "ph": "X", "ts": t0,
                "dur": self._now_us() - t0,
                "pid": 0, "tid": 0, "args": args,
            })

    def instant(self, name: str, **args) -> None:
        self.events.append({"name": name, "ph": "i", "ts": self._now_us(),
                            "s": "p", "pid": 0, "tid": 0, "args": args})

    def clear(self) -> None:
        self.events.clear()
        self._t0 = time.perf_counter()

    def to_chrome(self, path: Optional[str] = None) -> dict:
        """The Chrome trace document; written to ``path`` when given."""
        doc = {"traceEvents": list(self.events), "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def host_span(name: str, **args):
    """Tracer span while telemetry is enabled, else a free no-op: the
    single guard of the hot host paths (``run_grid``)."""
    if not _metrics.enabled():
        return _NULL
    return _TRACER.span(name, **args)


def host_instant(name: str, **args) -> None:
    if _metrics.enabled():
        _TRACER.instant(name, **args)


def write_trace(path: str) -> dict:
    """Write the accumulated host trace as Chrome-trace JSON."""
    return _TRACER.to_chrome(path)
