"""Continuous-batching decode engine.

The port of the JAX package's ``serving/engine.py``. One fixed-slot decode
state lives on the engine's device and is stepped by one ``tick`` per
scheduler round:

* the **state** (:class:`SlotState`) carries the per-slot ring KV cache
  (``models.init_slot_cache``: every slot has its own write position),
  the per-slot current token / generated-count / budget vectors, and an
  active mask;
* **tick** runs ``decode_step_slots`` over all slots, active or not, so
  the step's shapes never depend on occupancy, takes the greedy next
  token per slot, and retires slots whose budget is exhausted;
* **insert** writes one request's prefilled batch-1 ring into a free
  slot (``distributed.serving.slot_cache_insert``);
* **prefill** runs one request's prompt right-padded to its length
  *bucket*: causality keeps the real positions exact, the padded ring
  entries are invalidated on insert, and the first token is read at the
  true last position. Each layer's prefill attention is one launch of
  the flash-attention kernel.

PyTorch runs eagerly, so there is nothing to compile and nothing to
donate; the state is updated in place. Decode is greedy: the served
policy is the *agreed* aggregated model, so identical requests must yield
identical tokens on every replica (the batching-invariance contract).
Each phase runs inside a ``torch.profiler`` range (``serve.prefill``,
``serve.insert``, ``serve.tick``), which ``tools/profile_serve.py``
reads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.serving import (slot_cache_evict,
                                             slot_cache_insert)
from repro_torch.models.model import (check_supported, decode_step_slots,
                                      init_slot_cache, prefill, tree_map)
from repro_torch.serving.request import Request

#: BOS anchor supplied when a request carries only an observation
BOS_ID = 0


class SlotState(NamedTuple):
    """The decode state, on the engine's device."""
    cache: dict            # per-slot ring cache (models.init_slot_cache)
    tokens: torch.Tensor   # (S,) long: token to feed each slot next
    steps: torch.Tensor    # (S,) long: tokens generated so far
    budget: torch.Tensor   # (S,) long: max_new per slot
    active: torch.Tensor   # (S,) bool


class TickOut(NamedTuple):
    """Host view of one tick: per-slot emissions."""
    tokens: np.ndarray   # (S,) next token per slot (frozen where inactive)
    done: np.ndarray     # (S,) bool: slot retired this tick
    active: np.ndarray   # (S,) bool: slot was active entering the tick


def default_buckets(max_prompt: int) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets covering [1, max_prompt]."""
    out = []
    b = 1
    while b < max_prompt:
        out.append(b)
        b *= 2
    out.append(max_prompt)
    return tuple(dict.fromkeys(out))


class DecodeEngine:
    """Fixed-slot continuous-batching greedy decoder for one model.

    ``n_logits`` restricts the greedy argmax to the first ``n_logits``
    vocabulary entries: the action head of a transformer *policy*
    (``rl.transformer_policy``). ``device`` defaults to CUDA; the
    parameters are moved there if they lie elsewhere.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 4,
                 max_new: int = 32, max_prompt: int = 64,
                 prompt_buckets: Optional[Tuple[int, ...]] = None,
                 n_logits: Optional[int] = None, dtype=torch.float32,
                 device=None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.slots = int(slots)
        self.max_new = int(max_new)
        self.max_prompt = int(max_prompt)
        self.n_logits = None if n_logits is None else int(n_logits)
        self.dtype = dtype
        self.has_pe = cfg.frontend != "none"
        if prompt_buckets is None:
            prompt_buckets = default_buckets(max_prompt)
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        #: ring size: longest padded prompt + full generation budget
        self.cache_len = (cfg.n_prefix_embeds
                          + (max(self.prompt_buckets)
                             if self.prompt_buckets else max_prompt)
                          + max_new)

    # -- state ------------------------------------------------------------

    def init_state(self) -> SlotState:
        S, dev = self.slots, self.device
        return SlotState(
            cache=init_slot_cache(self.cfg, S, self.cache_len, self.dtype,
                                  dev),
            tokens=torch.zeros((S,), dtype=torch.long, device=dev),
            steps=torch.zeros((S,), dtype=torch.long, device=dev),
            budget=torch.zeros((S,), dtype=torch.long, device=dev),
            active=torch.zeros((S,), dtype=torch.bool, device=dev))

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        if self.n_logits is not None:
            logits = logits[..., :self.n_logits]
        return torch.argmax(logits, dim=-1)

    # -- host API ---------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        """Padded token length for a prompt of ``prompt_len`` tokens."""
        if prompt_len > self.max_prompt:
            raise ValueError(f"prompt of {prompt_len} tokens exceeds "
                             f"max_prompt={self.max_prompt}")
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        return prompt_len

    def _prompt(self, req: Request):
        toks = req.tokens if req.tokens is not None \
            else np.asarray([BOS_ID], np.int32)
        if req.obs is not None and not self.has_pe:
            raise ValueError(f"request {req.uid} carries an observation "
                             f"but {self.cfg.name} has no prefix-embedding "
                             f"frontend")
        P = len(toks)
        padded = self.bucket_for(P)
        toks = np.pad(toks, (0, padded - P))[None]        # (1, padded)
        pe = None
        if self.has_pe:
            pe = np.zeros((1, self.cfg.n_prefix_embeds, self.cfg.d_model),
                          np.float32)
            if req.obs is not None:
                pe[0, 0, :req.obs.shape[0]] = req.obs
        true_total = self.cfg.n_prefix_embeds + P
        return toks, pe, true_total, padded

    def prefill_request(self, req: Request):
        """Run one request's prompt. Returns ``(first_token int,
        row_cache, true_total)``: the insert-ready batch-1 ring."""
        toks, pe, true_total, _ = self._prompt(req)
        with record_function("serve.prefill"):
            toks = torch.as_tensor(toks, dtype=torch.long,
                                   device=self.device)
            if pe is not None:
                pe = torch.as_tensor(pe, device=self.device)
            logits, row = prefill(self.cfg, self.params, toks, pe,
                                  cache_len=self.cache_len, last_only=False)
            first = int(self._greedy(logits[0, true_total - 1]))
        return first, row, true_total

    def insert(self, state: SlotState, slot: int, row_cache: dict,
               first_tok: int, true_total: int, max_new: int) -> SlotState:
        if max_new > self.max_new:
            raise ValueError(f"max_new={max_new} exceeds engine budget "
                             f"{self.max_new}")
        with record_function("serve.insert"):
            slot_cache_insert(state.cache, row_cache, slot, true_total)
            state.tokens[slot] = first_tok
            state.steps[slot] = 1
            state.budget[slot] = max_new
            state.active[slot] = True
        return state

    def evict(self, state: SlotState, slot: int) -> SlotState:
        """Cancel a slot mid-flight (finished slots retire themselves in
        the tick; this is for cancellations and resets)."""
        slot_cache_evict(state.cache, slot)
        state.active[slot] = False
        return state

    def tick(self, state: SlotState):
        """One decode step for every slot. Returns ``(state, TickOut)``."""
        with record_function("serve.tick"):
            logits, cache = decode_step_slots(self.cfg, self.params,
                                              state.tokens, state.cache)
            nxt = torch.where(state.active, self._greedy(logits),
                              state.tokens)
            steps = state.steps + state.active
            done = state.active & (steps >= state.budget)
            new = SlotState(cache=cache, tokens=nxt, steps=steps,
                            budget=state.budget,
                            active=state.active & ~done)
            host = torch.stack([nxt, done.long(),
                                state.active.long()]).cpu().numpy()
        return new, TickOut(tokens=host[0], done=host[1].astype(bool),
                            active=host[2].astype(bool))

    def warmup(self, buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Run every phase once against a scratch state: one prefill per
        bucket, an insert each, a tick and an evict. Returns the number of
        phases run (the reference's count of compiled programs)."""
        state = self.init_state()
        if buckets is None:
            buckets = self.prompt_buckets or (1,)
        n = 0
        for b in buckets:
            req = Request(uid=-1, max_new=2,
                          tokens=np.zeros((min(b, self.max_prompt),),
                                          np.int32),
                          obs=(np.zeros((1,), np.float32)
                               if self.has_pe else None))
            first, row, true_total = self.prefill_request(req)
            state = self.insert(state, 0, row, first, true_total, 2)
            n += 1
        state, _ = self.tick(state)
        self.evict(state, 0)
        return n + 3


def engine_for_policy(policy, params: Optional[dict] = None,
                      **kw) -> DecodeEngine:
    """Build a :class:`DecodeEngine` serving a resolved servable policy
    (one with ``model_cfg``, e.g. ``policy="transformer(...)"``), with the
    greedy head restricted to the policy's action logits."""
    model_cfg = getattr(policy, "model_cfg", None)
    if model_cfg is None:
        raise ValueError("policy is not servable: no model_cfg attached "
                         "(only transformer policies decode; 'mlp' has no "
                         "token stream)")
    kw.setdefault("n_logits", getattr(policy, "n_actions", None))
    return DecodeEngine(model_cfg, params, **kw)
