"""Simulated per-user traffic for the serving benchmark and examples.

Arrivals are a Poisson process (exponential inter-arrival gaps at
``rate_rps``), prompts are drawn from a small set of lengths, and —
when serving a *policy* — each request carries a synthetic observation
vector that the engine maps into the model's prefix-embedding frontend.

Everything here is host-side ``numpy.random.default_rng`` state, a copy
of the JAX package's ``serving/traffic.py``: the same seed gives the same
requests in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request


def make_traffic(n_requests: int, *, seed: int = 0, rate_rps: float = 50.0,
                 max_new: int = 16, obs_dim: Optional[int] = None,
                 prompt_lens: Sequence[int] = (1, 4, 8, 16),
                 vocab: int = 256,
                 jitter_budget: bool = True) -> List[Request]:
    """Generate ``n_requests`` requests with staggered Poisson arrivals.

    ``obs_dim`` set → policy traffic: requests carry an observation (the
    engine supplies the BOS anchor) and no token prompt.  ``obs_dim``
    None → LM traffic: token prompts of lengths drawn from
    ``prompt_lens``.  ``jitter_budget`` varies per-request ``max_new``
    in ``[max(1, max_new // 2), max_new]`` so completions stagger and
    slots actually recycle mid-stream.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]          # first arrives at t=0
    reqs = []
    for i in range(n_requests):
        budget = int(rng.integers(max(1, max_new // 2), max_new + 1)) \
            if jitter_budget else max_new
        if obs_dim is not None:
            obs = rng.standard_normal(obs_dim).astype(np.float32)
            reqs.append(Request(uid=i, max_new=budget, obs=obs,
                                arrival_s=float(arrivals[i])))
        else:
            P = int(rng.choice(np.asarray(prompt_lens)))
            toks = rng.integers(0, vocab, size=P).astype(np.int32)
            reqs.append(Request(uid=i, max_new=budget, tokens=toks,
                                arrival_s=float(arrivals[i])))
    return reqs
