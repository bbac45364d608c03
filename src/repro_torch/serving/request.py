"""Request/response types and the thread-safe submission queue.

A :class:`Request` is one simulated user's decode job: a prompt (token
ids, an observation that becomes a prefix embedding, or both) plus a
token budget.  The engine is greedy by construction — the served artifact
is the *aggregated* federated policy, which every honest agent agrees on,
so two replicas serving the same request must return the same tokens.

Timestamps are wall-clock seconds (``time.monotonic``); latency is
``t_done - t_submit``, i.e. queueing + prefill + decode as the user sees
it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One decode job.

    ``tokens`` — prompt token ids ``(S,)`` (``None`` for obs-only
    policy requests, where the BOS anchor is supplied by the engine);
    ``obs`` — observation vector mapped into the model's prefix-embedding
    frontend (requires ``cfg.frontend != "none"``);
    ``max_new`` — number of tokens to generate (>= 1);
    ``arrival_s`` — offset from stream start at which the traffic
    generator submits this request (ignored in offline replay).
    """
    uid: int
    max_new: int = 16
    tokens: Optional[np.ndarray] = None
    obs: Optional[np.ndarray] = None
    arrival_s: float = 0.0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"request {self.uid}: max_new must be >= 1, "
                             f"got {self.max_new}")
        if self.tokens is None and self.obs is None:
            raise ValueError(f"request {self.uid}: needs tokens and/or obs")
        if self.tokens is not None:
            self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.obs is not None:
            self.obs = np.asarray(self.obs, np.float32).reshape(-1)


@dataclasses.dataclass
class RequestResult:
    """Completed request: generated tokens + per-phase timestamps."""
    uid: int
    tokens: List[int]
    prompt_len: int                  # real prompt positions (prefix incl.)
    t_submit: float = 0.0
    t_admit: float = 0.0             # prefilled into a slot
    t_first: float = 0.0             # first token available
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> float:
        """Time to first token (queueing + prefill)."""
        return self.t_first - self.t_submit

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_submit


class RequestQueue:
    """Thread-safe FIFO between feeder threads and the engine loop."""

    def __init__(self):
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._submitted = 0
        self._lock = threading.Lock()

    def put(self, req: Request) -> None:
        with self._lock:
            self._submitted += 1
        self._q.put(req)

    def get_nowait(self) -> Optional[Request]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def get(self, timeout: float) -> Optional[Request]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def depth(self) -> int:
        return self._q.qsize()

    @property
    def submitted(self) -> int:
        with self._lock:
            return self._submitted
