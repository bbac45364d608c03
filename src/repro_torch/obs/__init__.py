"""repro_torch.obs — telemetry that costs nothing when off: the port of the
JAX package's ``repro.obs``.

Three planes:

* **In-loop metric taps** (:mod:`repro_torch.obs.metrics`): a run with
  ``cfg.telemetry=True`` taps per-iteration scalars and small vectors
  (honest gradient norm, per-round rejected-agent masks) to host ring
  buffers and attached sinks, reading them to the host once a step. Off
  (the default), the step neither taps nor reads anything to the host.
* **Span tracing** (:mod:`repro_torch.obs.trace`): ``torch.profiler``
  ranges around named phases, plus a host Chrome-trace tracer around the
  engine's scenario runs (Perfetto-loadable).
* **Sinks + manifest** (:mod:`repro_torch.obs.sinks` /
  :mod:`repro_torch.obs.manifest`): JSONL / in-memory / stdout-progress
  sinks and a per-run manifest with the kernels' launch counts.

Typical use::

    from repro_torch import obs
    with obs.telemetry(obs.JsonlSink("metrics.jsonl")):
        out = run_decbyzpg(env, dataclasses.replace(cfg, telemetry=True), T)
    print(out["aggregator_confusion"]["recall"])
"""
from repro_torch.obs.manifest import build_manifest, write_manifest
from repro_torch.obs.metrics import (RingBuffer, Recorder, capture,
                                     confusion_tally, disable, enable,
                                     enabled, get_recorder, progress, record,
                                     tap, telemetry)
from repro_torch.obs.sinks import (JsonlSink, MemorySink, Sink,
                                   StdoutProgressSink)
from repro_torch.obs.trace import (Tracer, get_tracer, host_instant,
                                   host_span, named_phase, write_trace)

__all__ = [
    "RingBuffer", "Recorder", "Sink", "MemorySink", "JsonlSink",
    "StdoutProgressSink", "Tracer",
    "enabled", "enable", "disable", "telemetry", "capture",
    "get_recorder", "record", "progress", "tap", "confusion_tally",
    "named_phase", "host_span", "host_instant", "get_tracer",
    "write_trace", "build_manifest", "write_manifest",
]
