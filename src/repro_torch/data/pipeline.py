"""Deterministic synthetic token pipeline, agent-aware: the port of the
JAX package's ``data/pipeline.py``.

Produces ``{tokens, labels[, prefix_embeds]}`` batches shaped for a
federated trainer, (K, b, S). Content is drawn with numpy from
``SeedSequence([seed, step])``, exactly as the reference draws it, so the
two packages give the same tokens, labels and prefix embeddings, with no
replay. Every run is reproducible and resumable by step index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's config: the same fields and defaults."""
    vocab_size: int
    seq_len: int
    per_agent_batch: int
    n_agents: int = 1
    n_prefix_embeds: int = 0
    d_model: int = 0
    seed: int = 0


class TokenPipeline:
    """Stateless by-step batch source: ``batch(step)`` is deterministic.

    Batches lie on ``device`` (default CUDA, see
    :func:`repro_torch.resolve_device`): int32 ``tokens`` and ``labels``
    (K, b, S), f32 ``prefix_embeds`` (K, b, P, d_model). The reference's
    ``shardings`` (a device placement per key) has no counterpart: a
    batch goes to the one device whole.
    """

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = self._rng(step)
        shape = (c.n_agents, c.per_agent_batch, c.seq_len)
        tokens = rng.integers(0, c.vocab_size, size=shape, dtype=np.int32)
        # next-token targets of the same stream
        labels = np.concatenate(
            [tokens[..., 1:],
             rng.integers(0, c.vocab_size, size=shape[:-1] + (1,),
                          dtype=np.int32)], axis=-1)
        out = {"tokens": tokens, "labels": labels}
        if c.n_prefix_embeds:
            out["prefix_embeds"] = rng.standard_normal(
                (c.n_agents, c.per_agent_batch, c.n_prefix_embeds,
                 c.d_model)).astype(np.float32)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
