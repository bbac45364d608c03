"""PyTorch and CUDA port of the DecByzPG reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``rl/``, ``optim/``, ``topology/``, ``kernels/``, ``configs/``,
``models/``, ``distributed/``, ``serving/``, ``launch/``, ``obs/``,
``checkpoint/``) and imports neither ``jax`` nor anything of ``repro``. Its
entry points run on the CUDA device unless the caller asks for the CPU
(:func:`resolve_device`).

The front door, as in the reference, resolves lazily::

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


#: name -> defining submodule (attribute re-exports, imported on first use)
_EXPORTS = {
    "Experiment": "repro_torch.core.engine",
    "ExperimentResult": "repro_torch.core.engine",
    "ScenarioGrid": "repro_torch.core.engine",
    "run_grid": "repro_torch.core.engine",
}
#: subsystem namespaces exposed as attributes
_MODULES = ("checkpoint", "obs")

__all__ = ["resolve_device", *sorted(_EXPORTS), *_MODULES]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is not None:
        return getattr(importlib.import_module(module), name)
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
