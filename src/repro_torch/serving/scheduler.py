"""Slot scheduler: maps a request stream onto the engine's fixed slots.

The scheduler owns the engine's :class:`~repro_torch.serving.engine.SlotState`
and the host-side bookkeeping the state cannot carry: which request
occupies which slot, the tokens emitted so far, and per-phase
timestamps.  Its contract with the server loop is small:

* :meth:`admit` prefills one request into a free slot (or completes it
  outright when the budget is a single token — the prefill already
  produced it);
* :meth:`tick` advances every slot one decode step and returns the
  requests that finished this step, freeing their slots;
* :meth:`drain` ticks until nothing is in flight.

A slot's lifecycle is ``free → (prefill+insert) → decoding → done →
free``.  Finished slots retire *inside* the engine's tick (the active
mask flips), so eviction is not a separate device call on the hot path
— the freed slot's ring is simply overwritten by the next insert.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.request import Request, RequestResult


@dataclasses.dataclass
class _InFlight:
    req: Request
    tokens: List[int]
    prompt_len: int
    t_submit: float
    t_admit: float
    t_first: float


class SlotScheduler:
    """Host-side slot bookkeeping around one :class:`DecodeEngine`."""

    def __init__(self, engine: DecodeEngine,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.clock = clock
        self.state = engine.init_state()
        self.free: List[int] = list(range(engine.slots))
        self.inflight: dict = {}          # slot -> _InFlight

    # -- queries ----------------------------------------------------------

    def has_free(self) -> bool:
        return bool(self.free)

    def busy(self) -> int:
        return len(self.inflight)

    def idle(self) -> bool:
        return not self.inflight

    # -- transitions ------------------------------------------------------

    def admit(self, req: Request,
              t_submit: Optional[float] = None) -> Optional[RequestResult]:
        """Prefill ``req`` and occupy a free slot.  Returns the finished
        :class:`RequestResult` immediately when ``max_new == 1`` (the
        prefill's last-position argmax IS the whole generation), else
        ``None`` — the request completes through :meth:`tick`."""
        now = self.clock()
        t_submit = now if t_submit is None else t_submit
        first, row, true_total = self.engine.prefill_request(req)
        t_first = self.clock()
        if req.max_new == 1:
            return RequestResult(uid=req.uid, tokens=[first],
                                 prompt_len=true_total,
                                 t_submit=t_submit, t_admit=now,
                                 t_first=t_first, t_done=t_first)
        if not self.free:
            raise RuntimeError("admit() with no free slot — gate on "
                               "has_free()")
        slot = self.free.pop()
        self.state = self.engine.insert(self.state, slot, row, first,
                                        true_total, req.max_new)
        self.inflight[slot] = _InFlight(req=req, tokens=[first],
                                        prompt_len=true_total,
                                        t_submit=t_submit, t_admit=now,
                                        t_first=t_first)
        return None

    def tick(self) -> List[RequestResult]:
        """One decode step for all slots; returns requests that finished."""
        if not self.inflight:
            return []
        self.state, out = self.engine.tick(self.state)
        now = self.clock()
        finished = []
        for slot, fl in list(self.inflight.items()):
            if out.active[slot]:
                fl.tokens.append(int(out.tokens[slot]))
            if out.done[slot]:
                finished.append(RequestResult(
                    uid=fl.req.uid, tokens=fl.tokens,
                    prompt_len=fl.prompt_len, t_submit=fl.t_submit,
                    t_admit=fl.t_admit, t_first=fl.t_first, t_done=now))
                del self.inflight[slot]
                self.free.append(slot)
        return finished

    def cancel(self, slot: int) -> None:
        """Drop a slot mid-flight (no result is produced)."""
        if slot in self.inflight:
            self.state = self.engine.evict(self.state, slot)
            del self.inflight[slot]
            self.free.append(slot)

    def drain(self, max_ticks: Optional[int] = None) -> List[RequestResult]:
        """Tick until every in-flight request completes."""
        done: List[RequestResult] = []
        ticks = 0
        while self.inflight:
            done.extend(self.tick())
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                raise RuntimeError(
                    f"drain() exceeded {max_ticks} ticks with "
                    f"{len(self.inflight)} slots still active")
        return done
