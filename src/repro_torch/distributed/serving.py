"""Slot-granular cache operations of the continuous-batching engine.

The port of ``serve_cache_len``, ``slot_cache_insert`` and
``slot_cache_evict`` from the JAX package's ``distributed/serving.py``.
The mesh-sharded ``make_serve_fns`` waits (ROADMAP Queue 1). Both cache
operations write the per-slot cache in place and return it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def serve_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring size for a decode cache over a context of ``seq_len``."""
    if cfg.family == "ssm":
        return 1                       # recurrent state only
    if seq_len > 65536:                # long-context: sliding-window ring
        return cfg.long_context_window
    return seq_len


def slot_cache_insert(cache: dict, row: dict, slot: int,
                      true_len: int) -> dict:
    """Insert a batch-1 prefill cache ``row`` into ``slot`` of a per-slot
    cache (:func:`repro_torch.models.model.init_slot_cache` layout).

    ``true_len`` is the number of real prompt positions (prefix embeds
    included); ring entries holding positions ``>= true_len``, the prompt
    padding of a bucketed prefill, are marked empty, so padded keys are
    never attended to.
    """
    sp = row["slot_pos"]
    sp = torch.where((sp >= 0) & (sp < true_len), sp, -1)
    for name in ("k", "v"):
        cache["blocks"]["kv"][name][:, slot] = row["blocks"]["kv"][name][:, 0]
    cache["pos"][slot] = true_len
    cache["slot_pos"][slot] = sp
    return cache


def slot_cache_evict(cache: dict, slot: int) -> dict:
    """Clear one slot: empty ring (``slot_pos = -1``), position 0. Block
    contents stay: the empty ring makes them unreachable and the next
    :func:`slot_cache_insert` overwrites them."""
    cache["pos"][slot] = 0
    cache["slot_pos"][slot] = -1
    return cache
