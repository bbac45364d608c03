"""PyTorch and CUDA port of the DecByzPG reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``rl/``, ``optim/``, ``topology/``, ``kernels/``, ``configs/``,
``models/``, ``data/``, ``distributed/``, ``serving/``, ``launch/``,
``obs/``, ``checkpoint/``, ``sweep/``, ``analysis/``), adds the DTensor
carriers of its distributed routes (``carriers/``), and imports neither
``jax`` nor anything of ``repro``. Its entry points run on the CUDA device
unless the caller asks for the CPU (:func:`resolve_device`).

This module is the deliberate public surface, the reference's names and
namespaces. Everything here resolves lazily (PEP 562): each name imports
only its own submodule on first touch. Stable entry points:

* ``repro_torch.Experiment`` / ``repro_torch.ScenarioGrid`` /
  ``repro_torch.run_grid`` — configure and run the paper's experiments
* ``repro_torch.register`` / ``repro_torch.resolve`` /
  ``repro_torch.REGISTRY`` — the spec-string registry (aggregators,
  attacks, envs, policies, ...)
* ``repro_torch.get_config`` / ``repro_torch.reduced`` /
  ``repro_torch.make_env`` — model configurations and environments
* ``repro_torch.save`` / ``repro_torch.restore`` — checkpoint parameter
  trees
* ``repro_torch.SweepRunner`` — windowed, resumable, multi-process sweeps
  (and the port's ``SweepError`` and ``SweepMismatch``)
* ``repro_torch.serve`` — continuous-batching decode of the aggregated
  policy
* ``repro_torch.obs`` / ``repro_torch.serving`` / ``repro_torch.core`` /
  ... — the subsystem namespaces themselves (``_MODULES``)
* ``repro_torch.resolve_device`` — the port's own: CUDA unless asked

Anything not exported here is internal: the examples (``examples_torch/``)
do not deep-import paths like ``repro_torch.core.engine`` for names this
surface already provides (``repro_torch.analysis`` lints exactly that)::

    from repro_torch import Experiment, obs
    Experiment(algo="byzpg", env="cartpole(horizon=100)", T=15, seeds=3,
               axes={"aggregator": ("rfa", "mean")}, K=13, n_byz=3,
               attack="large_noise", N=20, B=4, eta=2e-2).run().summary()
"""
from __future__ import annotations

import importlib

import torch

# RFA's squared distances come from the Gram identity
# ‖x_i − z‖² = G_ii − 2 (G w)_i + wᵀ G w, whose cancellation only the
# smoothing floor ``nu`` bounds (see the JAX package's kernels/rfa/rfa.py).
# TF32 keeps 10 mantissa bits and would break that bound, so every f32
# product in the port is full f32, on matmuls and convolutions alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for (or implied) and
    absent: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


#: name -> defining submodule (attribute re-exports, imported on first use):
#: every name of the reference's surface, from the module that mirrors its
#: own, and the port's sweep errors
_EXPORTS = {
    "Experiment": "repro_torch.core.engine",
    "ExperimentResult": "repro_torch.core.engine",
    "Scenario": "repro_torch.core.engine",
    "ScenarioGrid": "repro_torch.core.engine",
    "run_grid": "repro_torch.core.engine",
    "REGISTRY": "repro_torch.core.registry",
    "Spec": "repro_torch.core.registry",
    "SpecError": "repro_torch.core.registry",
    "register": "repro_torch.core.registry",
    "resolve": "repro_torch.core.registry",
    "get_config": "repro_torch.configs.base",
    "reduced": "repro_torch.configs.base",
    "make_env": "repro_torch.rl.envs",
    "save": "repro_torch.checkpoint",
    "restore": "repro_torch.checkpoint",
    "serve": "repro_torch.serving",
    "SweepRunner": "repro_torch.sweep",
    "SweepError": "repro_torch.sweep",
    "SweepMismatch": "repro_torch.sweep",
}
#: subsystem namespaces exposed as attributes (lazy submodule imports)
_MODULES = ("analysis", "checkpoint", "configs", "core", "data",
            "distributed", "kernels", "launch", "models", "obs", "optim",
            "rl", "serving", "sweep", "topology")

__all__ = ["resolve_device", *sorted(_EXPORTS), *sorted(_MODULES)]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is not None:
        return getattr(importlib.import_module(module), name)
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return __all__
