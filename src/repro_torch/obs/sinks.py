"""Metric sinks: where telemetry records go (the port of the JAX
package's ``repro/obs/sinks.py``, with the same record layout).

Every record is one flat dict ``{"stream": <name>, **payload}`` produced
by the :class:`~repro_torch.obs.metrics.Recorder`. Sinks are deliberately tiny
— ``emit(record)`` + ``close()`` — so new transports (a socket, a
pytest capture) are a few lines.

* :class:`MemorySink` — append to a list (tests, notebooks).
* :class:`JsonlSink` — one JSON object per line; numpy scalars/arrays are
  converted to plain Python so every line is loadable anywhere.
* :class:`StdoutProgressSink` — human-oriented progress lines, filtered
  to the ``progress`` stream by default so metric taps don't spam the
  terminal. This is the single reporting path the benchmarks/examples
  entry points print through (:func:`repro_torch.obs.progress`).
"""
from __future__ import annotations

import json
from typing import Optional, Sequence, TextIO

import numpy as np
import torch


def _jsonable(v):
    """Plain-Python view of one payload value (numpy arrays and tensors
    included)."""
    if isinstance(v, (str, bool, int, float, type(None))):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


class Sink:
    """Base sink: receives every record the recorder accepts."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Collect records in ``self.records`` (tests / notebooks)."""

    def __init__(self):
        self.records: list = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class JsonlSink(Sink):
    """One JSON object per line, flushed per record (tail -f friendly)."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[TextIO] = open(path, "w")

    def emit(self, record: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(_jsonable(record)) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutProgressSink(Sink):
    """Print the ``message`` field of matching streams to stdout.

    ``streams=None`` prints every stream (debug); the default prints only
    the ``progress`` stream, so in-loop metric taps stay off the terminal.
    """

    def __init__(self, streams: Optional[Sequence[str]] = ("progress",)):
        self.streams = None if streams is None else tuple(streams)

    def emit(self, record: dict) -> None:
        if self.streams is not None and record.get("stream") \
                not in self.streams:
            return
        msg = record.get("message")
        if msg is None:
            payload = {k: v for k, v in record.items() if k != "stream"}
            msg = f"[{record.get('stream')}] {_jsonable(payload)}"
        print(msg, flush=True)
