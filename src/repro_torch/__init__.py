"""PyTorch and CUDA port of the DecByzPG reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``rl/``, ``optim/``, ``topology/``, ``kernels/``) and imports
neither ``jax`` nor anything of ``repro``. Its entry points run on the CUDA
device unless the caller asks for the CPU (:func:`resolve_device`).
"""
from __future__ import annotations

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


__all__ = ["resolve_device"]
