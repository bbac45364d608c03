"""In-loop metric taps and the host-side recorder: the port of the JAX
package's ``repro/obs/metrics.py``.

Two switches govern telemetry, as in the reference:

* ``cfg.telemetry`` decides whether a run's step taps at all. Off (the
  default), the step is the plain one: no tap, no read to the host.
* :func:`enable` / :func:`disable` (process-global) gate the *host-side*
  instrumentation (engine spans, ``run_grid`` progress events, manifest
  records), which must cost nothing when off.

A telemetry run emits one record per iteration through :func:`tap`,
which reads the step's tensors to the host (the reference's
``jax.debug.callback``); records land in per-stream ring buffers on the
:class:`Recorder` and fan out to any attached sinks. The run's returned
histories remain the source of truth; the stream is for live observation.

Taps draw no randomness and change no value: a run with
``telemetry=True`` returns bit-identical histories to the same run with
``telemetry=False`` (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.sinks import MemorySink, Sink, StdoutProgressSink

#: default per-stream ring-buffer capacity (records, not bytes)
RING_CAPACITY = 4096

_ENABLED = [False]


def enabled() -> bool:
    """Is host-side instrumentation (spans, progress, records) on?"""
    return _ENABLED[0]


def enable() -> None:
    _ENABLED[0] = True


def disable() -> None:
    _ENABLED[0] = False


class RingBuffer:
    """Bounded per-stream record store (newest ``capacity`` records)."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._q = collections.deque(maxlen=capacity)
        self.dropped = 0          # records evicted since creation

    def append(self, record: dict) -> None:
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(record)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def latest(self) -> Optional[dict]:
        return self._q[-1] if self._q else None


class Recorder:
    """Per-stream ring buffers + attached sinks.

    ``record(stream, payload)`` always lands in the stream's ring buffer
    (cheap, bounded) and fans out to every attached sink. The default
    recorder carries one :class:`StdoutProgressSink` so ``progress``
    lines reach the terminal with no setup.
    """

    def __init__(self, capacity: int = RING_CAPACITY,
                 sinks: Optional[list] = None):
        self.capacity = capacity
        self.streams: dict = {}
        self.sinks: list = list(sinks) if sinks is not None \
            else [StdoutProgressSink()]

    def record(self, stream: str, payload: dict) -> None:
        buf = self.streams.get(stream)
        if buf is None:
            buf = self.streams[stream] = RingBuffer(self.capacity)
        rec = {"stream": stream, **payload}
        buf.append(rec)
        for sink in self.sinks:
            sink.emit(rec)

    def add_sink(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    def remove_sink(self, sink: Sink) -> None:
        self.sinks.remove(sink)

    def stream(self, name: str) -> list:
        """Snapshot of one stream's ring buffer (oldest first)."""
        return list(self.streams.get(name, ()))

    def clear(self) -> None:
        self.streams.clear()

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


_RECORDER = Recorder()


def get_recorder() -> Recorder:
    return _RECORDER


def record(stream: str, **payload) -> None:
    """Host-side record (engine spans, grid progress, manifests)."""
    _RECORDER.record(stream, payload)


def progress(message: str, **fields) -> None:
    """One progress line through the recorder's stdout sink — the single
    reporting path for benchmarks/examples entry points (replaces their
    historical ad-hoc ``print`` calls)."""
    _RECORDER.record("progress", {"message": message, **fields})


@contextlib.contextmanager
def telemetry(*sinks: Sink, keep: bool = False):
    """Enable host-side instrumentation and attach ``sinks`` for the
    scope; yields the recorder. ``keep=True`` leaves attached sinks in
    place on exit (callers manage ``close``)."""
    prev = _ENABLED[0]
    _ENABLED[0] = True
    for s in sinks:
        _RECORDER.add_sink(s)
    try:
        yield _RECORDER
    finally:
        _ENABLED[0] = prev
        if not keep:
            for s in sinks:
                _RECORDER.remove_sink(s)
                s.close()


@contextlib.contextmanager
def capture(stream: Optional[str] = None):
    """Collect records into a fresh :class:`MemorySink` for the scope
    (optionally filtered to one stream); yields the sink."""
    sink = MemorySink()
    with telemetry(sink):
        yield sink
    if stream is not None:
        sink.records = [r for r in sink.records
                        if r.get("stream") == stream]


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tap(stream: str, **values) -> None:
    """Emit one iteration's values from inside a run's step, read to the
    host now (tensors on the device included).

    Only call under a ``cfg.telemetry`` check: the read synchronises with
    the device, which is exactly why the off path must never reach this
    function. Values must hold no random state (taps are observers, not
    consumers of the run's draws)."""
    # sorted, as the reference's records come out of jax.debug.callback
    _RECORDER.record(stream, {k: _to_host(values[k])
                              for k in sorted(values)})


# ---------------------------------------------------------------------------
# Byzantine forensics: rejected-mask confusion tally
# ---------------------------------------------------------------------------


def confusion_tally(rejected, n_byz: int) -> dict:
    """Confusion tally of per-round rejected-agent masks vs the ground
    truth Byzantine set (agents ``0..n_byz-1`` by construction).

    ``rejected``: bool array ``(..., K)`` — any number of leading axes
    (rounds, seeds, lanes) is summed over. Returns counts plus
    precision/recall of the aggregator viewed as a Byzantine detector
    (the ``Experiment.summary()`` ``aggregator_precision/recall``
    metric)."""
    rej = np.asarray(rejected).astype(bool)
    K = rej.shape[-1]
    truth = np.arange(K) < n_byz
    flat = rej.reshape(-1, K)
    tp = int(np.sum(flat & truth))
    fp = int(np.sum(flat & ~truth))
    fn = int(np.sum(~flat & truth))
    tn = int(np.sum(~flat & ~truth))
    return {
        "rounds": int(flat.shape[0]), "n_byz": int(n_byz), "K": int(K),
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp) if tp + fp else 0.0,
        "recall": tp / (tp + fn) if tp + fn else 0.0,
    }
