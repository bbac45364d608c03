"""Serving: continuous-batching greedy decode of a transformer policy or
language model, on the CUDA device by default.

The port of the JAX package's ``repro.serving``. The front door is
:func:`serve`: resolve the aggregated policy, build a fixed-slot
continuous-batching decode engine for its transformer, and serve a stream
of simulated per-user requests::

    from repro_torch import serving
    report = serving.serve(
        policy="transformer(arch='llama3.2-1b', n_layers=2, d_model=64, "
               "n_heads=2)",
        env="cartpole(horizon=32)", key=0, n_requests=32, slots=4)
    print(report.summary())

Layers (each importable on its own):

* :mod:`repro_torch.serving.request`: request/result types and a
  thread-safe queue
* :mod:`repro_torch.serving.engine`: slot state, tick/insert/prefill
* :mod:`repro_torch.serving.scheduler`: slot lifecycle bookkeeping
* :mod:`repro_torch.serving.server`: offline and realtime loops
* :mod:`repro_torch.serving.traffic`: simulated Poisson request streams
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.registry import resolve
from repro_torch.core.tree import tree_size, unravel_tree
from repro_torch.models.model import param_shapes, tree_map
from repro_torch.serving.engine import (DecodeEngine, SlotState, TickOut,
                                        default_buckets, engine_for_policy)
from repro_torch.serving.request import Request, RequestQueue, RequestResult
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.server import PolicyServer, ServeReport, progress
from repro_torch.serving.traffic import make_traffic

__all__ = ["DecodeEngine", "SlotState", "TickOut", "default_buckets",
           "engine_for_policy", "Request", "RequestQueue", "RequestResult",
           "SlotScheduler", "PolicyServer", "ServeReport", "make_traffic",
           "progress", "serve", "policy_params"]


def policy_params(policy, *, checkpoint: Optional[str] = None, theta=None,
                  key=None, device=None) -> dict:
    """Servable parameters for a resolved transformer policy, on
    ``device`` (default CUDA).

    Precedence: ``checkpoint`` (a :mod:`repro_torch.checkpoint` archive of
    the parameter tree, the aggregated artifact a trainer saves; either
    package's archive restores) > ``theta`` (a flat aggregated policy
    vector, unraveled in ``ravel_pytree``'s order: keys sorted at every
    level) > ``key`` (fresh init from a ``torch.Generator``, or an int
    seed for one; nothing here invents randomness)."""
    dev = resolve_device(device)
    if checkpoint is not None:
        from repro_torch.checkpoint import restore
        # shapes and dtype without storage: the restore template
        template = tree_map(lambda s: torch.empty(s, device="meta"),
                            param_shapes(policy.model_cfg))
        return restore(template, checkpoint, device=dev)
    if theta is not None:
        if not isinstance(theta, torch.Tensor):
            theta = torch.from_numpy(np.array(theta, dtype=np.float32))
        theta = theta.to(torch.float32)
        shapes = param_shapes(policy.model_cfg)
        d = tree_size(shapes)
        if tuple(theta.shape) != (d,):
            raise ValueError(f"theta has shape {tuple(theta.shape)}, policy "
                             f"expects ({d},)")
        return unravel_tree(theta.to(dev), shapes)
    if key is not None:
        if isinstance(key, torch.Generator):
            gen = key
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(key))
        return tree_map(lambda t: t.to(dev), policy.init(gen))
    raise ValueError("no parameter source: pass checkpoint=, theta= or "
                     "key= (serving never invents random state)")


def serve(policy: str = "transformer(arch='llama3.2-1b', n_layers=2, "
                        "d_model=64, n_heads=2)",
          env: str = "cartpole(horizon=32)", *,
          checkpoint: Optional[str] = None, theta=None, key=None,
          params=None, n_requests: int = 32, rate_rps: float = 50.0,
          slots: int = 4, max_new: int = 16, max_prompt: int = 8,
          seed: int = 0, realtime: bool = True, warmup: bool = True,
          device=None, **engine_kw) -> ServeReport:
    """Serve simulated policy traffic against the aggregated model, on
    ``device`` (default CUDA; ``device="cpu"`` runs the plain versions).

    ``policy``/``env`` are registry spec strings; the policy must be
    servable (a transformer policy). Parameters come from ``params``
    directly or :func:`policy_params` (checkpoint > theta > key).
    ``realtime`` replays Poisson arrivals at ``rate_rps`` against the wall
    clock through the feeder thread; off, the offline loop runs the same
    continuous-batching schedule on a virtual clock."""
    dev = resolve_device(device)
    e = resolve("env", env) if isinstance(env, str) else env
    pol = resolve("policy", policy, env=e) if isinstance(policy, str) \
        else policy
    if params is None:
        params = policy_params(pol, checkpoint=checkpoint, theta=theta,
                               key=key, device=dev)
    engine = engine_for_policy(pol, params, slots=slots, max_new=max_new,
                               max_prompt=max_prompt, device=dev,
                               **engine_kw)
    server = PolicyServer(engine, warmup=warmup)
    traffic = make_traffic(n_requests, seed=seed, rate_rps=rate_rps,
                           max_new=max_new, obs_dim=e.obs_dim)
    if realtime:
        return server.run(traffic)
    return server.run_offline(traffic)
