"""Server loop: feeder + engine threads around the slot scheduler.

Two execution modes share the same scheduler:

* **offline** (:meth:`PolicyServer.run_offline`) — single-threaded,
  virtual-clock replay of a request list in arrival order.  Admission
  is interleaved with decode exactly as online continuous batching
  would do it (admit while a slot is free, tick otherwise), but with no
  wall-clock dependence — this is the mode the invariance tests and the
  benchmark use.
* **realtime** (:meth:`PolicyServer.run`) — a feeder thread replays
  each request's ``arrival_s`` offset against the wall clock into the
  thread-safe :class:`~repro.serving.request.RequestQueue`; the engine
  thread admits from the queue whenever a slot is free and otherwise
  ticks.  Latency percentiles from this mode include real queueing
  delay, which is what the serving benchmark reports.

The port of the JAX package's ``serving/server.py``. Per-request
``serve.request`` records and ``serve.gauge`` queue-depth/slot-occupancy
gauges go to :mod:`repro_torch.obs` only under ``obs.enabled()``; the
end-of-run summary prints through :func:`progress`, with its fields.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from repro_torch import obs
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.request import Request, RequestQueue, RequestResult
from repro_torch.serving.scheduler import SlotScheduler


def progress(message: str, **fields) -> None:
    """One progress line on stdout: the message and its fields."""
    tail = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{message} {tail}".rstrip(), flush=True)


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile without numpy-on-hot-path ceremony."""
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


class ServeReport:
    """Aggregate view over one served request stream."""

    def __init__(self, results: List[RequestResult], wall_s: float):
        self.results = sorted(results, key=lambda r: r.uid)
        self.wall_s = wall_s
        lats = [r.latency_s for r in self.results]
        self.n_requests = len(self.results)
        self.total_tokens = sum(len(r.tokens) for r in self.results)
        self.latency_p50_s = _percentile(lats, 50)
        self.latency_p99_s = _percentile(lats, 99)
        self.ttft_p50_s = _percentile([r.ttft_s for r in self.results], 50)
        self.tokens_per_s = self.total_tokens / wall_s if wall_s > 0 else 0.0

    def summary(self) -> dict:
        return {"n_requests": self.n_requests,
                "total_tokens": self.total_tokens,
                "wall_s": round(self.wall_s, 4),
                "tokens_per_s": round(self.tokens_per_s, 2),
                "latency_p50_ms": round(self.latency_p50_s * 1e3, 3),
                "latency_p99_ms": round(self.latency_p99_s * 1e3, 3),
                "ttft_p50_ms": round(self.ttft_p50_s * 1e3, 3)}


class PolicyServer:
    """Continuous-batching server over one :class:`DecodeEngine`."""

    def __init__(self, engine: DecodeEngine, warmup: bool = True):
        self.engine = engine
        self.scheduler = SlotScheduler(engine)
        self.queue = RequestQueue()
        if warmup:
            with obs.host_span("serve.warmup"):
                engine.warmup()
            self.scheduler = SlotScheduler(engine)   # fresh post-warmup state

    # -- shared bookkeeping ------------------------------------------------

    def _emit_done(self, res: RequestResult) -> None:
        if obs.enabled():
            obs.record("serve.request", uid=res.uid,
                       tokens=len(res.tokens), prompt_len=res.prompt_len,
                       latency_ms=round(res.latency_s * 1e3, 3),
                       ttft_ms=round(res.ttft_s * 1e3, 3),
                       queue_ms=round(res.queue_s * 1e3, 3))

    def _emit_gauges(self) -> None:
        if obs.enabled():
            obs.record("serve.gauge", queue_depth=self.queue.depth(),
                       slots_busy=self.scheduler.busy(),
                       slots=self.engine.slots)

    # -- offline -----------------------------------------------------------

    def run_offline(self, requests: Sequence[Request],
                    submit_at_arrival: bool = False) -> ServeReport:
        """Deterministic single-threaded replay. Requests are admitted in
        arrival order whenever a slot frees up.  By default ``t_submit``
        is stamped at admission, so offline latency is pure service time
        (prefill + decode) — the loop runs faster than the declared
        arrival offsets, which makes queueing delay meaningless here;
        use :meth:`run` for latency that includes real queueing."""
        t0 = time.monotonic()
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.uid))
        done: List[RequestResult] = []
        i = 0
        while i < len(pending) or not self.scheduler.idle():
            while i < len(pending) and self.scheduler.has_free():
                req = pending[i]
                i += 1
                t_submit = (t0 + req.arrival_s) if submit_at_arrival \
                    else None
                res = self.scheduler.admit(req, t_submit=t_submit)
                if res is not None:
                    done.append(res)
                    self._emit_done(res)
            for res in self.scheduler.tick():
                done.append(res)
                self._emit_done(res)
            self._emit_gauges()
        report = ServeReport(done, time.monotonic() - t0)
        progress("serve.done", mode="offline", **report.summary())
        return report

    # -- realtime ----------------------------------------------------------

    def _feeder(self, requests: Sequence[Request], t0: float) -> None:
        for req in sorted(requests, key=lambda r: (r.arrival_s, r.uid)):
            delay = (t0 + req.arrival_s) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            self.queue.put(req)

    def run(self, requests: Sequence[Request],
            idle_timeout_s: float = 0.002) -> ServeReport:
        """Realtime replay: a feeder thread submits at each request's
        ``arrival_s`` offset, the calling thread runs the engine loop."""
        t0 = time.monotonic()
        n_total = len(requests)
        submit_times: dict = {}
        feeder = threading.Thread(target=self._feeder, args=(requests, t0),
                                  daemon=True)
        feeder.start()
        done: List[RequestResult] = []
        while len(done) < n_total:
            admitted = False
            while self.scheduler.has_free():
                req = self.queue.get_nowait()
                if req is None:
                    break
                submit_times[req.uid] = t0 + req.arrival_s
                res = self.scheduler.admit(req,
                                           t_submit=submit_times[req.uid])
                admitted = True
                if res is not None:
                    done.append(res)
                    self._emit_done(res)
            if not self.scheduler.idle():
                for res in self.scheduler.tick():
                    done.append(res)
                    self._emit_done(res)
            elif not admitted:
                # nothing in flight, nothing admitted: block briefly on
                # the queue instead of spinning
                req = self.queue.get(timeout=idle_timeout_s)
                if req is not None:
                    submit_times[req.uid] = t0 + req.arrival_s
                    res = self.scheduler.admit(
                        req, t_submit=submit_times[req.uid])
                    if res is not None:
                        done.append(res)
                        self._emit_done(res)
            self._emit_gauges()
        feeder.join()
        report = ServeReport(done, time.monotonic() - t0)
        progress("serve.done", mode="realtime", **report.summary())
        return report
